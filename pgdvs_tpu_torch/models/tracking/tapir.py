"""TAPIR point tracker (Doersch et al., ICCV 2023) in torch.

Counterpart of ``pgdvs_tpu.models.tracking.tapir`` (the deepmind/tapnet
TAPIR in the PGDVS configuration: pyramid_level 0, no depthwise-conv
interpolation, 256x256 working resolution), with the same module names and
knobs:

  * ``TapirResNet``: a ResNet-v2 backbone (instance norm, groups of strides
    1/2/2/1 and 64/128/256/256 channels, two blocks each, projection on the
    first) -> L2-normalized hires (stride 4, 128 ch) and lowres (stride 8,
    256 ch) grids;
  * the TAP-Net initialization: query-feature / grid cost volume, conv
    heads, a soft argmax around the heatmap's argmax (query frames
    reproduced verbatim), occlusion and expected-distance logits;
  * ``num_pips_iter`` PIPs refinements: 7x7 local correlations against both
    grids and an MLP-Mixer of depthwise temporal convs.

Flax's ``"SAME"`` padding is asymmetric at stride 2 (``(lo, hi) = (p // 2,
p - p // 2)``): every strided conv pads with ``F.pad`` first, so grids sit
where flax puts them at any size. Norm epsilons are flax's: 1e-5 for the
instance norm, 1e-6 for the scale-only layer norm; GELU is exact.

Tensors are channel-last at the module boundaries, as in the JAX package
(video [T, H, W, 3], grids [T, h, w, C]); the convolutions run NCHW. No
query's track depends on another's, so ``Tapir.forward`` computes the grids
once and tracks the queries in chunks sized by QUERY_CHUNK_BYTES (memory
only). ``TapirTracker`` runs the network with TF32 off for its
convolutions and matmuls: a small change in the cost volume moves the soft
argmax's window to another cell.
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pgdvs_tpu_torch.core.interpolate import bilinear_sample, resize

HIGHRES_DIM = 128
LOWRES_DIM = 256
INITIAL_RES = (256, 256)
# the tracker's working set per chunk of queries: a tenth of the H100's 80 GB
QUERY_CHUNK_BYTES = 8 << 30
LOGGER = logging.getLogger(__name__)


def convert_grid_coords(coords, in_size, out_size):
    """Plain scale ``coords * out / in`` (the reference's code, not its
    docstring's half-pixel mapping; see the JAX package's note)."""
    return coords * float(out_size) / float(in_size)


def _same_pad(x, k: int, stride: int):
    """Pad NC(H)(W) ``x`` as flax's "SAME" for a k-wide kernel at stride."""
    pads = []
    for size in reversed(x.shape[2:]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv2d(nn.Conv2d):
    """A square conv with flax's "SAME" padding at any stride."""

    def __init__(self, cin, cout, k, stride=1, bias=True):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)

    def forward(self, x):
        return super().forward(_same_pad(x, self.kernel_size[0], self.stride[0]))


class ScaleLayerNorm(nn.Module):
    """flax ``LayerNorm(use_bias=False)``: scale only, eps 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, None, self.eps)


def _instance_norm(c: int):
    """flax ``GroupNorm(group_size=1)``: per-frame, per-channel statistics."""
    return nn.GroupNorm(c, c, eps=1e-5)


class TapirBlockV2(nn.Module):
    """Pre-activation basic residual block (resnet.py:156-266)."""

    def __init__(self, cin: int, channels: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        self.instancenorm_0 = _instance_norm(cin)
        self.conv_0 = SameConv2d(cin, channels, 3, stride, bias=False)
        self.instancenorm_1 = _instance_norm(channels)
        self.conv_1 = SameConv2d(channels, channels, 3, bias=False)
        self.shortcut_conv = (SameConv2d(cin, channels, 1, stride, bias=False)
                              if use_projection else None)

    def forward(self, x):
        h = F.relu(self.instancenorm_0(x))
        shortcut = x if self.shortcut_conv is None else self.shortcut_conv(h)
        h = F.relu(self.instancenorm_1(self.conv_0(h)))
        return self.conv_1(h) + shortcut


class TapirResNet(nn.Module):
    """Backbone on NCHW; returns (hires stride 4 128 ch, lowres stride 8
    256 ch)."""

    def __init__(self, channels: Sequence[int] = (64, HIGHRES_DIM, 256, LOWRES_DIM),
                 strides: Sequence[int] = (1, 2, 2, 1), blocks: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.initial_conv = SameConv2d(3, 64, 7, 2, bias=False)
        self.names = []
        cin = 64
        for g, (ch, st, nb) in enumerate(zip(channels, strides, blocks)):
            group = []
            for b in range(nb):
                name = f"group_{g}_block_{b}"
                self.add_module(name, TapirBlockV2(cin, ch, st if b == 0 else 1,
                                                   use_projection=b == 0))
                group.append(name)
                cin = ch
            self.names.append(group)

    def forward(self, x):
        h = self.initial_conv(x)
        outs = []
        for group in self.names:
            for name in group:
                h = getattr(self, name)(h)
            outs.append(h)
        return outs[1], outs[3]


def _temporal_conv(x, conv: nn.Conv1d, repeat: int = 1):
    """``conv`` (a grouped 1-D conv with one input channel per group and
    "SAME" padding) applied to channel-last x [N, T, C] as shifted
    multiply-adds over T: each input channel feeds ``repeat`` consecutive
    output channels, as ``groups = C`` orders them. Equal to
    ``conv(x.transpose(1, 2)).transpose(1, 2)`` but for float32 summation
    order, and it needs no transpose; torch runs grouped 1-D convolutions
    at T = 12 and 2048 channels through a slow native kernel."""
    n, t, c = x.shape
    k = conv.kernel_size[0]
    xp = F.pad(x, (0, 0, k // 2, k - 1 - k // 2))[..., None]  # [N, T + k - 1, C, 1]
    w = conv.weight[:, 0, :].reshape(c, repeat, k)
    out = torch.addcmul(conv.bias.reshape(c, repeat), xp[:, 0:t], w[..., 0])
    for j in range(1, k):
        out.addcmul_(xp[:, j:j + t], w[..., j])
    return out.reshape(n, t, c * repeat)


class PipsMixerBlock(nn.Module):
    """Depthwise temporal conv + channel MLP (tapir_model.py:37-122) on
    [N, T, C]."""

    def __init__(self, c: int, kernel_shape: int = 3):
        super().__init__()
        self.layer_norm = ScaleLayerNorm(c)
        pad = kernel_shape // 2
        self.mlp1_up = nn.Conv1d(c, c * 4, kernel_shape, padding=pad, groups=c)
        self.mlp1_up_1 = nn.Conv1d(c * 4, c * 4, kernel_shape, padding=pad, groups=c * 4)
        self.layer_norm_1 = ScaleLayerNorm(c)
        self.mlp2_up = nn.Linear(c, c * 4)
        self.mlp2_down = nn.Linear(c * 4, c)

    def forward(self, x):
        n, t, c = x.shape
        h = _temporal_conv(self.layer_norm(x), self.mlp1_up, repeat=4)
        h = _temporal_conv(F.gelu(h), self.mlp1_up_1)        # [N, T, 4C]
        # fold the multiplier back: h[..., 0::4] + ... + h[..., 3::4]
        x = h.reshape(n, t, c, 4).sum(dim=-1) + x
        h = self.mlp2_down(F.gelu(self.mlp2_up(self.layer_norm_1(x))))
        return h + x


class PipsMlpMixer(nn.Module):
    def __init__(self, input_channels: int, output_channels: int, hidden_dim: int = 512,
                 num_blocks: int = 12):
        super().__init__()
        self.linear = nn.Linear(input_channels, hidden_dim)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", PipsMixerBlock(hidden_dim))
        self.layer_norm = ScaleLayerNorm(hidden_dim)
        self.linear_1 = nn.Linear(hidden_dim, output_channels)

    def forward(self, x):
        x = self.linear(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self.linear_1(self.layer_norm(x))


def soft_argmax_heatmap(softmax_val, threshold: float = 5.0):
    """Soft argmax around the argmax cell (model_utils.py:99-138), batched:
    softmax_val [..., h, w] -> [..., 2] (x, y) in grid coords (cell
    centres at +0.5)."""
    h, w = softmax_val.shape[-2:]
    flat = softmax_val.reshape(softmax_val.shape[:-2] + (h * w,))
    dev = softmax_val.device
    cx = (torch.arange(w, device=dev) + 0.5).float().repeat(h)
    cy = (torch.arange(h, device=dev) + 0.5).float().repeat_interleave(w)
    arg = torch.argmax(flat, dim=-1, keepdim=True)
    px, py = cx[arg], cy[arg]
    valid = (((cx - px) ** 2 + (cy - py) ** 2) < threshold ** 2).float()
    wv = valid * flat
    norm = torch.clamp(wv.sum(dim=-1), min=1e-12)
    return torch.stack([(cx * wv).sum(dim=-1), (cy * wv).sum(dim=-1)], dim=-1) / norm[..., None]


class Tapir(nn.Module):
    """Single-resolution TAPIR (one video, in [-1, 1])."""

    def __init__(self, num_pips_iter: int = 4, patch_size: int = 7,
                 softmax_temperature: float = 20.0, mixer_hidden_dim: int = 512,
                 num_mixer_blocks: int = 12):
        super().__init__()
        self.num_pips_iter = num_pips_iter
        self.patch_size = patch_size
        self.softmax_temperature = softmax_temperature
        self.mixer_hidden_dim = mixer_hidden_dim
        self.num_mixer_blocks = num_mixer_blocks
        self.resnet = TapirResNet()
        self.cost_hid1 = SameConv2d(1, 16, 3)
        self.cost_hid2 = SameConv2d(16, 1, 3)
        self.cost_hid3 = SameConv2d(16, 32, 3, 2)
        self.cost_hid4 = nn.Linear(32, 16)
        self.occ_out = nn.Linear(16, 2)
        self.mixer = PipsMlpMixer(4 + HIGHRES_DIM + LOWRES_DIM + 2 * patch_size ** 2,
                                  4 + HIGHRES_DIM + LOWRES_DIM, hidden_dim=mixer_hidden_dim,
                                  num_blocks=num_mixer_blocks)

    def feature_grids(self, video):
        """video [T, H, W, 3] -> (hires [T, h4, w4, 128], lowres [T, h8, w8,
        256]), each L2-normalized per position."""
        hires, lowres = self.resnet(video.permute(0, 3, 1, 2))

        def l2n(x):
            x = x.permute(0, 2, 3, 1)
            return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True),
                                               min=1e-12))

        return l2n(hires), l2n(lowres)

    def query_features(self, grids, query_points, video_hw):
        """Edge-clamped bilinear features at (t, y, x) query points."""
        t_idx = torch.round(query_points[:, 0]).long()

        def extract(grid):
            gh, gw = grid.shape[1], grid.shape[2]
            y = convert_grid_coords(query_points[:, 1], video_hw[0], gh)
            x = convert_grid_coords(query_points[:, 2], video_hw[1], gw)
            # the JAX package adds the raster half pixel and takes it off again
            return bilinear_sample(grid, (x + 0.5) - 0.5, (y + 0.5) - 0.5, zero_pad=False,
                                   frame=t_idx)

        return extract(grids[0]), extract(grids[1])

    def tracks_from_cost_volume(self, query_feat, grid, query_points, video_hw):
        """TAP-Net initialization (tapir_model.py:345-411): points [N, T, 2]
        (x, y) at video resolution, occlusion [N, T], expected_dist [N, T]."""
        t_n, gh, gw, _ = grid.shape
        n = query_feat.shape[0]
        cost = torch.einsum("nc,thwc->tnhw", query_feat, grid)
        occ = F.relu(self.cost_hid1(cost.reshape(t_n * n, 1, gh, gw)))
        pos = self.cost_hid2(occ).reshape(t_n, n, gh * gw).transpose(0, 1)
        sm = torch.softmax(pos * self.softmax_temperature, dim=-1).reshape(n, t_n, gh, gw)
        points = soft_argmax_heatmap(sm)
        points = torch.stack([convert_grid_coords(points[..., 0], gw, video_hw[1]),
                              convert_grid_coords(points[..., 1], gh, video_hw[0])], dim=-1)
        # the query points verbatim on their own frames
        t_idx = torch.round(convert_grid_coords(query_points[:, 0], t_n, t_n)).long()
        is_q = (t_idx[:, None] == torch.arange(t_n, device=grid.device)[None, :])[..., None]
        points = torch.where(is_q, query_points[:, None, [2, 1]], points)

        o = F.relu(self.cost_hid3(occ)).mean(dim=(2, 3))
        o = self.occ_out(F.relu(self.cost_hid4(o))).reshape(t_n, n, 2)
        return points, o[..., 0].T, o[..., 1].T

    def refine_pips(self, queries, pyramid, pos_guess, occ_guess, expd_guess,
                    last_iter=None):
        """One PIPs iteration (tapir_model.py:413-557, pyramid_level 0).

        queries: (hires [N, 128], lowres [N, 256]); pyramid: the grids;
        pos_guess [N, T, 2] (x, y); occ / expd_guess [N, T]; last_iter the
        previous iteration's features [N, T, 384] or None.
        """
        half = self.patch_size // 2
        dev = pos_guess.device
        r = torch.arange(-half, half + 1, device=dev, dtype=torch.float32)
        # jnp.meshgrid's "xy" order: entry i * ps + j is (r[j], r[i]) as (y, x)
        ctx = torch.stack(torch.meshgrid(r, r, indexing="xy"), dim=-1).reshape(-1, 2)
        n, t_n = pos_guess.shape[:2]
        # map (n, t) of the [N * T] correlation maps below
        nt_idx = torch.arange(n * t_n, device=dev).reshape(n, t_n, 1).expand(-1, -1, ctx.shape[0])
        corrs = []
        for lvl, (query, grid) in enumerate(zip(queries, pyramid)):
            gh, gw = grid.shape[1], grid.shape[2]
            cy = convert_grid_coords(pos_guess[..., 1], INITIAL_RES[0], gh)
            cx = convert_grid_coords(pos_guess[..., 0], INITIAL_RES[1], gw)
            ys = cy[..., None] + ctx[:, 0]
            xs = cx[..., None] + ctx[:, 1]
            # the JAX package samples the grid's features on the 7x7 window
            # and takes their dot product with the query; bilinear sampling
            # is linear, so the port samples the query's correlation map
            # with the whole grid instead (a [T, h, w] map per query, one
            # product, where the features would be [T, 49, C] per query)
            if last_iter is None:
                cmap = torch.einsum("nc,thwc->nthw", query, grid)
            else:
                q = last_iter[..., :HIGHRES_DIM] if lvl == 0 else last_iter[..., HIGHRES_DIM:]
                cmap = torch.einsum("ntc,thwc->nthw", q, grid)
            corrs.append(bilinear_sample(cmap.reshape(n * t_n, gh, gw, 1), xs - 0.5, ys - 0.5,
                                         frame=nt_idx)[..., 0])
        corrs = torch.cat(corrs, dim=-1)
        if last_iter is None:
            feats = torch.cat(queries, dim=-1)[:, None, :].expand(n, t_n, -1)
        else:
            feats = last_iter
        mlp_in = torch.cat([torch.zeros_like(pos_guess), occ_guess[..., None],
                            expd_guess[..., None], feats, corrs], dim=-1)
        res = self.mixer(mlp_in)
        return (pos_guess + res[..., :2], occ_guess + res[..., 2], expd_guess + res[..., 3],
                feats + res[..., 4:])

    def track(self, grids, query_points, video_hw):
        """The per-query part of the forward for one chunk of queries."""
        q_hi, q_lo = self.query_features(grids, query_points, video_hw)
        points, occ, expd = self.tracks_from_cost_volume(q_lo, grids[1], query_points,
                                                         video_hw)
        feats = None
        for _ in range(self.num_pips_iter):
            points, occ, expd, feats = self.refine_pips((q_hi, q_lo), grids, points, occ,
                                                        expd, last_iter=feats)
        return points, occ, expd

    def chunk_size(self, grids) -> int:
        """Queries per chunk: the largest per-query working set (the cost
        volume's [T, 16, h8, w8] conv maps, a few alive at once, or the
        mixer's [T, 4 * hidden] activations) within QUERY_CHUNK_BYTES."""
        t_n, gh, gw, _ = grids[1].shape
        per_query = 4 * t_n * max(48 * gh * gw, 24 * self.mixer_hidden_dim)
        return max(1, QUERY_CHUNK_BYTES // per_query)

    def forward(self, video, query_points, chunk: Optional[int] = None):
        """video [T, H, W, 3] in [-1, 1]; query_points [N, 3] (t, y, x) at
        video resolution. Returns tracks [N, T, 2] (x, y), occlusion and
        expected_dist [N, T]."""
        video_hw = video.shape[1:3]
        grids = self.feature_grids(video)
        cs = chunk or self.chunk_size(grids)
        outs = [self.track(grids, query_points[i:i + cs], video_hw)
                for i in range(0, max(query_points.shape[0], 1), cs)]
        return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions and cuBLAS matmuls in full float32 (cuDNN stays
    enabled: ``cudnn.flags`` would turn it off by default)."""
    cudnn = torch.backends.cudnn
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class TapirTracker:
    """Tracker-contract wrapper (interface.py:150-179): frames resized to
    256x256 unless ``keep_raw_res`` (``jax.image.resize``'s antialiased
    bilinear, ``core.interpolate.resize(..., "linear")``), queries (t, x, y)
    turned to (t, y, x) at that size, visibility = (1 - sigmoid(occ)) *
    (1 - sigmoid(expd)) > 0.5 and the query valid."""

    def __init__(self, model: Tapir, keep_raw_res: bool = False):
        self.model = model
        self.keep_raw_res = keep_raw_res

    def to(self, device):
        self.model.to(device)
        return self

    @torch.no_grad()
    def __call__(self, frames, queries, query_valid=None):
        t_n, h, w, _ = frames.shape
        rh, rw = (h, w) if self.keep_raw_res else INITIAL_RES
        flat = frames.float().permute(1, 2, 0, 3).reshape(h, w, t_n * 3)
        video = resize(flat, rh, rw, "linear").reshape(rh, rw, t_n, 3).permute(2, 0, 1, 3)
        video = video * 2.0 - 1.0
        q = torch.stack([queries[:, 0], convert_grid_coords(queries[:, 2], h, rh),
                         convert_grid_coords(queries[:, 1], w, rw)], dim=-1)
        with no_tf32():
            tracks, occ, expd = self.model(video, q)
        tracks = torch.stack([convert_grid_coords(tracks[..., 0], rw, w),
                              convert_grid_coords(tracks[..., 1], rh, h)], dim=-1)
        visibles = (1 - torch.sigmoid(occ)) * (1 - torch.sigmoid(expd)) > 0.5
        if query_valid is not None:
            visibles = visibles & query_valid[:, None]
        return tracks, visibles


def init_tapir_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """flax's initialisers from an explicit generator: conv and dense
    kernels normal with variance 1 / fan_in (lecun), biases 0, norm scales
    1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
    return model


def make_tapir_tracker(keep_raw_res: bool = False, ckpt_path: Optional[str] = None,
                       device="cuda") -> TapirTracker:
    """The tracker on ``device`` (default the card) with the released
    checkpoint (``tapir_port``), or with seeded random weights and a warning
    when it is not there, as the JAX package's does."""
    from pgdvs_tpu_torch.models.tracking.tapir_port import load_tapir_checkpoint

    model = Tapir()
    state = load_tapir_checkpoint(ckpt_path)
    if state is None:
        LOGGER.warning("TAPIR checkpoint unavailable (set PGDVS_CKPT_DIR); using random "
                       "weights - prefer the LK tracker for weight-free runs")
        init_tapir_weights(model, seed=0)
    else:
        model.load_state_dict(state)
    model.eval()
    return TapirTracker(model, keep_raw_res=keep_raw_res).to(device)
