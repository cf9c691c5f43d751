"""RAFT optical flow (Teed & Deng, ECCV 2020) in torch.

Counterpart of ``pgdvs_tpu.models.flow.raft``, the flow network of the
reference's preprocessing (``pgdvs/preprocess/compute_flow.py:221-238``: 32
iterations, forward and backward, ``raft-things.pth``). The submodules carry
the names of princeton-vl's state dict (``fnet.layer2.0.downsample.0``,
``cnet.norm1.running_var``, ``update_block.gru.convz1``,
``update_block.mask.2`` ...), so the released checkpoint loads with
``load_state_dict`` once its ``module.`` prefix is stripped (``raft_port``):

  * ``BasicEncoderRAFT``: 1/8-resolution residual encoder; the feature
    encoder with affine-less instance norm, the context encoder with batch
    norm in eval mode (running statistics, eps 1e-5);
  * ``build_corr_pyramid``: one [H8*W8, C] x [C, H8*W8] product / sqrt(C),
    then 2x2 average pools (a dimension that has reached 1 stays 1);
  * ``lookup_corr``: a radius-4 window per level through
    ``core.interpolate.bilinear_sample`` (zero padding, align_corners),
    one frame per query pixel, with the reference's transposed taps: the
    window's slow-axis offset goes to x;
  * ``UpdateBlock``: motion encoder, separable ConvGRU (1x5 then 5x1),
    flow head and the 0.25-scaled upsampling mask; ``convex_upsample``.

Tensors inside are NCHW with a batch; the forward and backward flows of a
pair run as one batch of two (``RAFTFlow``), the feature encoder once over
both frames. On a card the convolutions and the correlation run in float32
with TF32 off (``tapir.no_tf32``), so the card can be held to the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pgdvs_tpu_torch.core.interpolate import bilinear_sample
from pgdvs_tpu_torch.models.tracking.tapir import no_tf32

HDIM = 128
CDIM = 128
CORR_LEVELS = 4
CORR_RADIUS = 4


class BatchNormEval(nn.Module):
    """BatchNorm2d in eval mode: (x - running_mean) / sqrt(running_var +
    1e-5) * weight + bias, with BatchNorm2d's parameter names and no
    ``num_batches_tracked``."""

    def __init__(self, planes: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(planes))
        self.bias = nn.Parameter(torch.zeros(planes))
        self.register_buffer("running_mean", torch.zeros(planes))
        self.register_buffer("running_var", torch.ones(planes))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + 1e-5)
        return ((x - self.running_mean[:, None, None]) * inv[:, None, None]
                * self.weight[:, None, None] + self.bias[:, None, None])


def _norm(kind: str, planes: int) -> nn.Module:
    return nn.InstanceNorm2d(planes) if kind == "instance" else BatchNormEval(planes)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norm and ReLU; a strided 1x1 projection with its
    own norm (``downsample.0`` / ``downsample.1``) where the stride is not 1."""

    def __init__(self, in_planes: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride),
                                            _norm(norm, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoderRAFT(nn.Module):
    """NCHW images in [-1, 1] -> [B, output_dim, H / 8, W / 8]."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        for i, (cin, cout, st) in enumerate(((64, 64, 1), (64, 96, 2), (96, 128, 2))):
            self.add_module(f"layer{i + 1}", nn.Sequential(ResidualBlock(cin, cout, norm, st),
                                                           ResidualBlock(cout, cout, norm, 1)))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class MotionEncoder(nn.Module):
    """(flow, corr) -> 128 motion channels (126 convolved + the flow)."""

    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], dim=1))), flow], dim=1)


class SepConvGRU(nn.Module):
    """Convolutional GRU, a 1x5 pass then a 5x1 pass."""

    def __init__(self, hidden: int = HDIM, inp: int = 128 + HDIM):
        super().__init__()
        for suffix, kern, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                self.add_module(f"conv{gate}{suffix}",
                                nn.Conv2d(hidden + inp, hidden, kern, padding=pad))

    def forward(self, h, x):
        for suffix in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, inp: int = HDIM, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(inp, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    """BasicUpdateBlock: motion encoder, GRU, flow head, upsampling mask."""

    def __init__(self):
        super().__init__()
        self.encoder = MotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(HDIM, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, h, context, corr, flow):
        motion = self.encoder(flow, corr)
        h = self.gru(h, torch.cat([context, motion], dim=1))
        return h, 0.25 * self.mask(h), self.flow_head(h)


def build_corr_pyramid(fmap1, fmap2, num_levels: int = CORR_LEVELS):
    """All-pairs correlation pyramid of [B, C, H8, W8] feature maps: a list
    of [B, H8*W8, Hl, Wl] volumes, level 0 divided by sqrt(C), each next
    level a 2x2 average pool (odd sizes drop their last row / column; a
    dimension of 1 stays 1)."""
    b, c, h8, w8 = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, c, -1).transpose(1, 2),
                        fmap2.reshape(b, c, -1)) / math.sqrt(c)
    cur = corr.reshape(b, h8 * w8, h8, w8)
    pyr = [cur]
    for _ in range(num_levels - 1):
        _, n, hh, ww = cur.shape
        if hh >= 2:
            cur = cur[:, :, :hh // 2 * 2].reshape(b, n, hh // 2, 2, -1).mean(dim=3)
        if ww >= 2:
            cur = cur[..., :ww // 2 * 2].reshape(b, n, cur.shape[2], ww // 2, 2).mean(dim=4)
        pyr.append(cur)
    return pyr


def lookup_corr(pyr, coords, radius: int = CORR_RADIUS):
    """Per query pixel, the (2r+1)^2 window of each level around coords
    [B, H8, W8, 2] (x, y at level-0 scale) -> [B, L * (2r+1)^2, H8, W8].

    The taps follow princeton-vl's ``CorrBlock``: its window
    ``stack(meshgrid(dy, dx), -1)`` feeds the slow-axis offset to x, and the
    released checkpoint's ``convc1`` was trained against that enumeration."""
    b, h8, w8, _ = coords.shape
    n = h8 * w8
    dev = coords.device
    rr = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    off_slow, off_fast = torch.meshgrid(rr, rr, indexing="ij")
    off_slow, off_fast = off_slow.reshape(-1), off_fast.reshape(-1)
    frame = torch.arange(b * n, device=dev).reshape(b * n, 1)
    out = []
    for lvl, corr in enumerate(pyr):
        cl = coords.reshape(b * n, 2) / (2.0 ** lvl)
        xx = cl[:, 0:1] + off_slow[None]
        yy = cl[:, 1:2] + off_fast[None]
        vol = corr.reshape(b * n, corr.shape[2], corr.shape[3], 1)
        out.append(bilinear_sample(vol, xx, yy, zero_pad=True, frame=frame)[..., 0])
    return torch.cat(out, dim=-1).reshape(b, h8, w8, -1).permute(0, 3, 1, 2)


def convex_upsample(flow, mask):
    """Convex-combination 8x upsampling: flow [B, 2, H8, W8], mask
    [B, 576, H8, W8] (9 weights x 8x8 positions) -> [B, 2, 8 H8, 8 W8],
    the flow scaled by 8."""
    b, _, h8, w8 = flow.shape
    m = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h8, w8), dim=2)
    patches = F.unfold(8.0 * flow, (3, 3), padding=1).reshape(b, 2, 9, 1, 1, h8, w8)
    up = torch.sum(m * patches, dim=2)  # [B, 2, 8, 8, H8, W8]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h8, 8 * w8)


def _nchw(img):
    """[B, H, W, 3] in [0, 255] -> [B, 3, H, W] in [-1, 1]."""
    return 2.0 * (img.float().permute(0, 3, 1, 2) / 255.0) - 1.0


class RAFT(nn.Module):
    """RAFT in test mode: (img1, img2) in [0, 255] -> upsampled flow."""

    def __init__(self, iters: int = 32):
        super().__init__()
        self.iters = iters
        self.fnet = BasicEncoderRAFT(256, "instance")
        self.cnet = BasicEncoderRAFT(HDIM + CDIM, "batch")
        self.update_block = UpdateBlock()

    def refine(self, fmap1, fmap2, cnet_out, iters: int):
        """The recurrent part over [B, C, H8, W8] maps -> [B, 2, H, W]."""
        b, _, h8, w8 = fmap1.shape
        h = torch.tanh(cnet_out[:, :HDIM])
        context = F.relu(cnet_out[:, HDIM:])
        pyr = build_corr_pyramid(fmap1, fmap2)
        dev = fmap1.device
        gy, gx = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=dev),
                                torch.arange(w8, dtype=torch.float32, device=dev),
                                indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1)[None].expand(b, h8, w8, 2)
        coords1 = coords0
        up_mask = None
        for _ in range(iters):
            corr = lookup_corr(pyr, coords1)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            h, up_mask, delta = self.update_block(h, context, corr, flow)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        return convex_upsample((coords1 - coords0).permute(0, 3, 1, 2), up_mask)

    def forward(self, img1, img2, iters: int = 0):
        """img1 / img2 [H, W, 3] in [0, 255], H and W multiples of 8 ->
        flow [H, W, 2], (x, y) pixels."""
        x = _nchw(torch.stack([img1, img2]))
        with no_tf32():
            fmaps = self.fnet(x)
            flow = self.refine(fmaps[:1], fmaps[1:], self.cnet(x[:1]), iters or self.iters)
        return flow[0].permute(1, 2, 0)


def init_raft_weights(model: RAFT, seed: int = 0) -> RAFT:
    """torch's default initialisation from an explicit generator
    (convolution weights and biases uniform in ±1 / sqrt(fan_in); the batch
    norms' scale 1, offset 0, running mean 0 and variance 1), then the
    flow head's last convolution scaled by 0.1, so that random updates stay
    within the frame over the iterations (~1 px after 32 at 96x128). Random
    weights stand in for the released checkpoint, which is not in the
    repository."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                bound = 1.0 / math.sqrt(math.prod(mod.weight.shape[1:]))
                for t in (mod.weight, mod.bias):
                    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=gen))
            elif isinstance(mod, BatchNormEval):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        model.update_block.flow_head.conv2.weight.mul_(0.1)
        model.update_block.flow_head.conv2.bias.mul_(0.1)
    return model


class RAFTFlow:
    """The flow-model contract of preprocessing: frames [H, W, 3] in [0, 1]
    (numpy or torch) are padded to multiples of 8 by edge replication, the
    pad split across both sides (InputPadder's "sintel" mode), and run
    through RAFT for ``iters`` iterations on the model's device; returns
    (flow_fwd, flow_bwd) [H, W, 2] float32 tensors there. The pair is one
    batch of two: the feature encoder runs once over both frames."""

    def __init__(self, model: RAFT, iters: int = 32):
        self.model = model
        self.iters = iters

    @property
    def device(self):
        return next(self.model.parameters()).device

    def _padded(self, img1, img2):
        a = torch.as_tensor(img1, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(img2, dtype=torch.float32, device=self.device)
        h, w = a.shape[:2]
        ph, pw = (-h) % 8, (-w) % 8
        pads = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
        both = F.pad(torch.stack([a, b]).permute(0, 3, 1, 2) * 255.0, pads, mode="replicate")
        both = both.permute(0, 2, 3, 1)
        return both, (slice(ph // 2, ph // 2 + h), slice(pw // 2, pw // 2 + w))

    @torch.no_grad()
    def __call__(self, img1, img2):
        both, (sy, sx) = self._padded(img1, img2)
        m = self.model
        x = _nchw(both)
        with no_tf32():
            fmaps = m.fnet(x)
            flows = m.refine(fmaps, fmaps.flip(0), m.cnet(x), self.iters)
        flows = flows.permute(0, 2, 3, 1)[:, sy, sx]
        return flows[0], flows[1]

    @torch.no_grad()
    def one_way(self, img1, img2):
        """The forward flow alone [H, W, 2]: half the passes (the tiling
        protocols drive each direction per patch themselves)."""
        both, (sy, sx) = self._padded(img1, img2)
        return self.model(both[0], both[1], self.iters)[sy, sx]
