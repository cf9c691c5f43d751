"""CoTracker (Karaev et al., 2023) in torch: the sliding-window transformer
point tracker of the ``_track_cotracker`` bundle.

Counterpart of ``pgdvs_tpu.models.tracking.cotracker`` (the reference's
vendored CoTracker, checkpoint ``cotracker_stride_4_wind_8.pth``: windows of
S = 8 frames at stride 4, 6 time and 6 space attention blocks, 384 wide),
with the submodules named after the reference's state-dict keys
(``fnet.layer2.0.downsample.0``, ``updateformer.time_blocks.{i}.attn.qkv``,
``norm``, ``ffeat_updater.0`` ...), so the released ``.pth`` loads with
``load_state_dict`` (``cotracker_port``):

  * ``BasicEncoder``: the RAFT-style encoder (affine-less instance norm,
    eps 1e-5), four residual stages resized to 1/stride (align_corners)
    and fused -> 128-channel feature maps;
  * ``UpdateFormer``: interleaved time / space attention blocks (pre-norm
    affine-less layer norm, eps 1e-6; tanh-GELU MLP);
  * ``CoTrackerModel.track``: the windows of the JAX package, every point
    processed in every window, the reference's admission and carry
    reproduced by masks (``vis_init`` carried as a raw logit from the
    previous window's second half, ``track_mask`` from the first frame and
    the frames already covered, outputs committed only for points whose
    first frame lies before the window's end), the flag concat quirk
    (track_mask and vis concatenated on the point axis, then reshaped to
    (N, S, 2)) and the transposed 7x7 correlation taps kept as they are;
  * ``CoTrackerTracker``: the predictor (resize to 384x512, a 6x6 support
    grid at t = 0, a time-flipped backward pass merged where the forward
    trajectory is zero, visibility sigmoid > 0.9, tracks rescaled and
    clipped at 0).

Which queries share a call. With ``chunk=None`` the tracker is JAX's: every
row of ``queries`` plus the support grid is one set whose space attention
couples all of them, and ``query_valid`` is ignored. With ``chunk=k`` (what
``make_cotracker_tracker`` builds, k = ``CHUNK`` = 4096) it tracks only the valid
rows, in consecutive chunks of k, each chunk plus the support grid one set;
invalid rows get zero tracks and no visibility. That follows the
reference's interface, which tracks the valid queries in chunks of 4096
(``pgdvs_renderer_dyn_track.py:493-498``), not JAX's one set, which at full
size (T x H x W slots, ~1.9M at 288x550 with ±5 track frames) cannot run:
on the card invalid slots take no part in attention and a query attends
only within its chunk (ROADMAP.md §3, F12).

The frames are encoded once per call (the encoder is per frame), the
backward pass reads the same feature maps flipped. Everything runs in
float32 with TF32 off (``tapir.no_tf32``); attention is
``F.scaled_dot_product_attention``, which on the card keeps the
[frames, heads, N, N] scores of a space block out of memory.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pgdvs_tpu_torch.core.interpolate import bilinear_sample, resize_bilinear
from pgdvs_tpu_torch.models.tracking.tapir import no_tf32

LATENT_DIM = 128
INPUT_DIM = 456
HIDDEN_SIZE = 384
CORR_LEVELS = 4
CORR_RADIUS = 3
# the predictor's working size, support grid and visibility threshold, and
# the reference interface's query chunk
INTERP_HW = (384, 512)
SUPPORT_GRID = 6
VIS_THRES = 0.9
CHUNK = 4096


# ---------------------------------------------------------------- embeddings


def sincos_pos_embed_1d(embed_dim: int, pos):
    """get_1d_sincos_pos_embed_from_grid: [sin | cos] of pos [...] ->
    [numel, embed_dim]."""
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device) / (
        embed_dim / 2.0)
    omega = 1.0 / (10000.0 ** omega)
    out = pos.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)


def sincos_pos_embed_2d(embed_dim: int, grid_h: int, grid_w: int, device=None):
    """get_2d_sincos_pos_embed: [emb_h | emb_w] -> [H * W, D], the grid
    built w-first (emb_h comes from the x coordinate)."""
    gw = torch.arange(grid_w, dtype=torch.float32, device=device)
    gh = torch.arange(grid_h, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(gw, gh, indexing="xy")
    return torch.cat([sincos_pos_embed_1d(embed_dim // 2, gx),
                      sincos_pos_embed_1d(embed_dim // 2, gy)], dim=-1)


def embedding_2d_interleaved(xy, c: int):
    """get_2d_embedding(cat_coords=True): per axis interleaved sin / cos,
    the coordinates prepended. xy [..., 2] -> [..., 2 + 2c]."""
    div = torch.arange(0, c, 2, dtype=torch.float32, device=xy.device) * (1000.0 / c)
    parts = [xy]
    for i in range(2):
        a = xy[..., i:i + 1] * div
        parts.append(torch.stack([torch.sin(a), torch.cos(a)], dim=-1).reshape(
            a.shape[:-1] + (c,)))
    return torch.cat(parts, dim=-1)


def support_grid_points(grid_size: int, hw) -> np.ndarray:
    """get_points_on_a_grid with grid_center (0, 0): [G * G, 2] (x, y)."""
    h, w = hw
    step = w // 64
    lin = np.arange(grid_size, dtype=np.float32)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    gy = step + gy.reshape(-1) / float(grid_size - 1) * (h - step * 2)
    gx = step + gx.reshape(-1) / float(grid_size - 1) * (w - step * 2)
    return np.stack([gx, gy], axis=-1)


def _resize_frames(x, out_h: int, out_w: int, align_corners: bool):
    """``resize_bilinear`` of every frame of x [T, H, W, C]."""
    t_n, h, w, c = x.shape
    flat = x.permute(1, 2, 0, 3).reshape(h, w, t_n * c)
    out = resize_bilinear(flat, out_h, out_w, align_corners=align_corners)
    return out.reshape(out_h, out_w, t_n, c).permute(2, 0, 1, 3)


# ------------------------------------------------------------------ encoder


class ResidualBlock(nn.Module):
    """Two 3x3 convs with instance norm and ReLU; a strided 1x1 projection
    (``downsample.0``) where the shape changes."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = nn.InstanceNorm2d(planes)
        self.norm2 = nn.InstanceNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride),
                                            nn.InstanceNorm2d(planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """NCHW frames in [-1, 1] -> [T, output_dim, H / stride, W / stride]."""

    def __init__(self, output_dim: int = LATENT_DIM, stride: int = 4):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = nn.InstanceNorm2d(64)
        planes = ((64, 64, 1), (64, 96, 2), (96, 128, 2), (128, 128, 2))
        for i, (cin, cout, st) in enumerate(planes):
            self.add_module(f"layer{i + 1}", nn.Sequential(ResidualBlock(cin, cout, st),
                                                           ResidualBlock(cout, cout, 1)))
        self.conv2 = nn.Conv2d(64 + 96 + 128 + 128, output_dim * 2, 3, padding=1)
        self.norm2 = nn.InstanceNorm2d(output_dim * 2)
        self.conv3 = nn.Conv2d(output_dim * 2, output_dim, 1)

    def forward(self, x):
        ho, wo = x.shape[2] // self.stride, x.shape[3] // self.stride
        x = F.relu(self.norm1(self.conv1(x)))
        stages = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            up = _resize_frames(x.permute(0, 2, 3, 1), ho, wo, align_corners=True)
            stages.append(up.permute(0, 3, 1, 2))
        y = F.relu(self.norm2(self.conv2(torch.cat(stages, dim=1))))
        return self.conv3(y)


# ------------------------------------------------------- update transformer


class Attention(nn.Module):
    """timm's ViT attention: fused qkv with bias, scaled dot product,
    output projection."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class AttnBlock(nn.Module):
    """Pre-norm (affine-less, eps 1e-6) attention and MLP, both residual."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.attn = Attention(dim, heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        c = x.shape[-1]
        x = x + self.attn(F.layer_norm(x, (c,), eps=1e-6))
        return x + self.mlp(F.layer_norm(x, (c,), eps=1e-6))


class UpdateFormer(nn.Module):
    """Time attention over each track's frames, space attention over each
    frame's tracks, interleaved: x [N, S, INPUT_DIM] -> [N, S, 130]."""

    def __init__(self, time_depth: int = 6, space_depth: int = 6, heads: int = 8):
        super().__init__()
        self.input_transform = nn.Linear(INPUT_DIM, HIDDEN_SIZE)
        self.time_blocks = nn.ModuleList(AttnBlock(HIDDEN_SIZE, heads)
                                         for _ in range(time_depth))
        self.space_blocks = nn.ModuleList(AttnBlock(HIDDEN_SIZE, heads)
                                          for _ in range(space_depth))
        self.flow_head = nn.Linear(HIDDEN_SIZE, LATENT_DIM + 2)

    def forward(self, x):
        x = self.input_transform(x)
        stride = len(self.time_blocks) // len(self.space_blocks)
        j = 0
        for i, block in enumerate(self.time_blocks):
            x = block(x)
            if i % stride == 0 and j < len(self.space_blocks):
                x = self.space_blocks[j](x.transpose(0, 1)).transpose(0, 1)
                j += 1
        return self.flow_head(x)


# -------------------------------------------------------------------- model


class CoTrackerModel(nn.Module):
    """fnet + updateformer + heads, in the reference's key layout."""

    def __init__(self, S: int = 8, stride: int = 4):
        super().__init__()
        self.S = S
        self.stride = stride
        self.fnet = BasicEncoder(LATENT_DIM, stride)
        self.updateformer = UpdateFormer()
        self.norm = nn.GroupNorm(1, LATENT_DIM, eps=1e-5)
        self.ffeat_updater = nn.Sequential(nn.Linear(LATENT_DIM, LATENT_DIM), nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(LATENT_DIM, 1))

    def encode(self, frames):
        """frames [T, H, W, 3] in [0, 255] -> fmaps [T, H / stride,
        W / stride, 128]."""
        x = 2.0 * (frames / 255.0) - 1.0
        return self.fnet(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def window(self, fmaps, coords_init, feat_init, vis_init, track_mask, iters: int):
        """One window of iterative refinement.

        fmaps [S, h, w, C]; coords_init [S, N, 2] at feature scale;
        feat_init [S, N, C]; vis_init and track_mask [S, N, 1]. Returns
        coords [S, N, 2] at pixel scale and vis logits [S, N].
        """
        s, h8, w8, cdim = fmaps.shape
        n = coords_init.shape[1]
        dev = fmaps.device
        pyr = [fmaps]
        for _ in range(CORR_LEVELS - 1):
            t, hh, ww, cc = pyr[-1].shape
            pyr.append(pyr[-1][:, :hh // 2 * 2, :ww // 2 * 2]
                       .reshape(t, hh // 2, 2, ww // 2, 2, cc).mean(dim=(2, 4)))
        pos_grid = sincos_pos_embed_2d(INPUT_DIM, h8, w8, dev).reshape(h8, w8, INPUT_DIM)
        pos_embed = bilinear_sample(pos_grid, coords_init[0, :, 0], coords_init[0, :, 1],
                                    zero_pad=False)
        times_embed = sincos_pos_embed_1d(INPUT_DIM, torch.arange(s, dtype=torch.float32,
                                                                  device=dev))
        r = torch.arange(-CORR_RADIUS, CORR_RADIUS + 1, dtype=torch.float32, device=dev)
        # (a, b) over a 7x7 grid, a the outer index: the reference names it
        # (dy, dx) but adds it to (x, y), which transposes the tap grid
        dgrid = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).reshape(-1, 2)
        k_taps = dgrid.shape[0]
        frame = torch.arange(s * n, device=dev)[:, None]
        # the track mask and the visibility concatenated on the point axis,
        # then read as (N, S, 2): the layout the released weights expect
        flags = torch.cat([track_mask.transpose(0, 1), vis_init.transpose(0, 1)],
                          dim=0).reshape(n, s, 2)
        coords, ffeats = coords_init, feat_init
        for _ in range(iters):
            fcorrs = []
            for lvl, fm in enumerate(pyr):
                _, hl, wl, _ = fm.shape
                corr = torch.einsum("snc,shwc->snhw", ffeats, fm) / math.sqrt(cdim)
                cl = coords / (2.0 ** lvl)
                xx = (cl[..., 0:1] + dgrid[:, 0]).reshape(s * n, k_taps)
                yy = (cl[..., 1:2] + dgrid[:, 1]).reshape(s * n, k_taps)
                samp = bilinear_sample(corr.reshape(s * n, hl, wl, 1), xx, yy, zero_pad=True,
                                       frame=frame)
                fcorrs.append(samp[..., 0].reshape(s, n, k_taps))
            fcorrs = torch.cat(fcorrs, dim=-1)
            flows = (coords - coords[0:1]).transpose(0, 1)
            x = torch.cat([embedding_2d_interleaved(flows, 64), fcorrs.transpose(0, 1),
                           ffeats.transpose(0, 1), flags], dim=-1)
            x = x + pos_embed[:, None, :] + times_embed[None]
            delta = self.updateformer(x).transpose(0, 1)
            coords = coords + delta[..., :2]
            dfeat = self.ffeat_updater(self.norm(delta[..., 2:].reshape(s * n, LATENT_DIM)))
            ffeats = dfeat.reshape(s, n, LATENT_DIM) + ffeats
        vis_logit = self.vis_predictor(ffeats.reshape(s * n, LATENT_DIM)).reshape(s, n)
        return coords * float(self.stride), vis_logit

    def track(self, fmaps_all, queries, iters: int = 6):
        """The sliding windows over encoded frames fmaps_all [T, h, w, C];
        queries [N, 3] (t, x, y) in pixels of the encoded frames. Returns
        traj [T, N, 2] and vis logits [T, N], zero before a query's first
        window (what the backward merge reads)."""
        t_total = fmaps_all.shape[0]
        n = queries.shape[0]
        s, half = self.S, self.S // 2
        dev = fmaps_all.device
        first = queries[:, 0]
        coords_q = queries[:, 1:] / float(self.stride)
        t_first = torch.clamp(first.to(torch.int32), 0, t_total - 1).long()
        feat_q = bilinear_sample(fmaps_all, coords_q[:, 0], coords_q[:, 1], zero_pad=False,
                                 frame=t_first)
        feat_init = feat_q[None].expand(s, n, LATENT_DIM)
        q_coords = coords_q[None].expand(s, n, 2)
        traj = torch.zeros((t_total, n, 2), device=dev)
        vis = torch.zeros((t_total, n), device=dev)
        prev_coords = prev_vis = None
        for ind in range(0, max(t_total - half, 1), half):
            s_local = min(s, t_total - ind)
            fmaps = fmaps_all[torch.clamp(torch.arange(ind, ind + s, device=dev), 0,
                                          t_total - 1)]
            started_before = (first < float(ind))[None, :, None]
            if prev_coords is None:
                coords_init = q_coords
                vis_init = torch.full((s, n, 1), 10.0, device=dev)
            else:
                carried = torch.cat([prev_coords[half:], prev_coords[-1:].expand(half, n, 2)])
                coords_init = torch.where(started_before, carried, q_coords)
                carried_vis = torch.cat([prev_vis[half:], prev_vis[-1:].expand(half, n, 1)])
                vis_init = torch.where(started_before, carried_vis,
                                       torch.full_like(carried_vis, 10.0))
            # frames at or after the first frame not covered by an earlier window
            tgrid = torch.arange(ind, ind + s, dtype=torch.float32, device=dev)[:, None]
            zeroed_upto = torch.where((first < float(ind)) & (ind > 0),
                                      torch.full_like(first, float(ind + half)),
                                      torch.zeros_like(first))
            track_mask = ((tgrid >= first[None]) & (tgrid >= zeroed_upto[None])).float()[..., None]
            coords_out, vis_out = self.window(fmaps, coords_init, feat_init, vis_init,
                                              track_mask, iters)
            active = (first < float(ind + s))[None, :]
            traj[ind:ind + s_local] = torch.where(active[..., None], coords_out[:s_local],
                                                  traj[ind:ind + s_local])
            vis[ind:ind + s_local] = torch.where(active, vis_out[:s_local],
                                                 vis[ind:ind + s_local])
            prev_coords = coords_out / float(self.stride)
            prev_vis = vis_out[..., None]     # a raw logit, as the reference carries it
        return traj, vis

    def forward(self, frames, queries, iters: int = 6):
        """frames [T, H, W, 3] in [0, 255] at model resolution; queries
        [N, 3] (t, x, y) in its pixels."""
        return self.track(self.encode(frames), queries, iters)


# ------------------------------------------------------------------ tracker


class CoTrackerTracker:
    """The tracker contract over ``CoTrackerModel`` (the predictor's
    ``_compute_sparse_tracks`` and the pgdvs interface): frames [T, H, W, 3]
    in [0, 1], queries [N, 3] (t, x, y) -> tracks [N, T, 2] clipped at 0,
    visibles [N, T] bool. ``chunk`` None: one set, ``query_valid`` ignored
    (JAX's tracker); an int: the valid rows in chunks of that many."""

    def __init__(self, model: CoTrackerModel, chunk: Optional[int] = None, iters: int = 6,
                 interp_hw=INTERP_HW):
        self.model = model
        self.chunk = chunk
        self.iters = iters
        self.interp_hw = tuple(interp_hw)

    @property
    def one_set(self) -> bool:
        """Whether every query slot goes into one call (the renderer then
        hands over JAX's whole slot layout)."""
        return self.chunk is None

    def to(self, device):
        self.model.to(device)
        return self

    def encode(self, frames):
        """The frames at the working size, encoded: fmaps [T, h, w, C]."""
        hi, wi = self.interp_hw
        return self.model.encode(_resize_frames(frames.float(), hi, wi, False) * 255.0)

    def track_set(self, fmaps, queries, hw):
        """One set: ``queries`` plus the support grid, forward and
        time-flipped, merged; tracks [N, T, 2] at the frames' size hw."""
        h, w = hw
        hi, wi = self.interp_hw
        dev = fmaps.device
        t_total, n = fmaps.shape[0], queries.shape[0]
        scale = torch.tensor([wi / w, hi / h], dtype=torch.float32, device=dev)
        sup = torch.from_numpy(support_grid_points(SUPPORT_GRID, self.interp_hw)).to(dev)
        q_all = torch.cat([torch.cat([queries[:, :1], queries[:, 1:] * scale], dim=1),
                           torch.cat([torch.zeros_like(sup[:, :1]), sup], dim=1)])
        traj_f, vis_f = self.model.track(fmaps, q_all, self.iters)
        inv_q = torch.cat([float(t_total) - 1.0 - q_all[:, :1], q_all[:, 1:]], dim=1)
        traj_b, vis_b = self.model.track(fmaps.flip(0), inv_q, self.iters)
        zero = traj_f == 0.0
        traj = torch.where(zero, traj_b.flip(0), traj_f)[:, :n]
        vis = torch.where(zero[..., 0], vis_b.flip(0), vis_f)[:, :n]
        back = torch.tensor([w / wi, h / hi], dtype=torch.float32, device=dev)
        traj = torch.clamp(traj * back, min=0.0)
        return traj.transpose(0, 1), (torch.sigmoid(vis) > VIS_THRES).transpose(0, 1)

    @torch.no_grad()
    def __call__(self, frames, queries, query_valid=None):
        hw = frames.shape[1:3]
        with no_tf32():
            fmaps = self.encode(frames)
            if self.chunk is None:
                return self.track_set(fmaps, queries, hw)
            n, t_n = queries.shape[0], frames.shape[0]
            tracks = torch.zeros((n, t_n, 2), device=queries.device)
            visibles = torch.zeros((n, t_n), dtype=torch.bool, device=queries.device)
            rows = (torch.arange(n, device=queries.device) if query_valid is None
                    else torch.nonzero(query_valid)[:, 0])
            for i in range(0, rows.numel(), self.chunk):
                sel = rows[i:i + self.chunk]
                tracks[sel], visibles[sel] = self.track_set(fmaps, queries[sel], hw)
            return tracks, visibles


def init_cotracker_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """torch's default initialisation from an explicit generator (weights
    and biases uniform in ±1 / sqrt(fan_in), norm scales 1 and offsets 0),
    then the update head damped: ``updateformer.flow_head`` weight times
    1e-2, bias 0, as random updates diverge over the refinements otherwise
    (tests/test_cotracker.py damps so too)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                bound = 1.0 / math.sqrt(math.prod(mod.weight.shape[1:]))
                mod.weight.copy_(torch.empty(mod.weight.shape).uniform_(-bound, bound,
                                                                        generator=gen))
                mod.bias.copy_(torch.empty(mod.bias.shape).uniform_(-bound, bound,
                                                                    generator=gen))
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        head = model.updateformer.flow_head
        head.weight.mul_(1e-2)
        head.bias.zero_()
    return model


def make_cotracker_tracker(ckpt_path: Optional[str] = None,
                           device="cuda") -> CoTrackerTracker:
    """The tracker on ``device`` (default the card) with the released
    checkpoint (``cotracker_port``), queries in chunks of ``CHUNK``; raises
    FileNotFoundError when the checkpoint is not there (no random fallback,
    as in the JAX package)."""
    from pgdvs_tpu_torch.models.tracking.cotracker_port import load_cotracker_checkpoint

    state = load_cotracker_checkpoint(ckpt_path)
    if state is None:
        raise FileNotFoundError(
            "CoTracker checkpoint not found (set PGDVS_CKPT_DIR with "
            "cotracker/cotracker_stride_4_wind_8.pth); the weight-free fallback is "
            "tracker='lk'")
    model = CoTrackerModel()
    model.load_state_dict(state)
    model.eval()
    return CoTrackerTracker(model, chunk=CHUNK).to(device)
