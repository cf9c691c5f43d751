"""MiDaS DPT-BEiT relative-depth backbone and ZoeDepth in torch.

Counterpart of ``pgdvs_tpu.models.depth.dpt_beit``: ZoeDepth over MiDaS
v3.1 ``dpt_beit_large_384``, the depth network of the reference's
preprocessing (``pgdvs/preprocess/compute_zoedepth.py:146-166``):

  * BEiT-L/16: patch convolution, cls token, 24 pre-norm blocks with a
    relative-position bias table each, q / v biases only, layer-scale
    gammas; hooks after blocks 5, 11, 17 and 23;
  * DPT reassemble: the readout projection (token and cls token -> linear
    + GELU), a 1x1 convolution to 256 / 512 / 1024 / 1024 channels, then
    x4 and x2 deconvolutions, identity and a stride-2 convolution;
  * ``scratch``: 3x3 convolutions to 256 channels, RefineNet fusion
    (residual units, x2 bilinear upsampling with align_corners=True, 1x1
    ``out_conv``) and the relative-depth head.

The submodules carry the names of the published checkpoint, which holds
them under ``core.core.``: timm's BEiT under ``pretrained.model``
(``blocks.{i}.attn.qkv``, ``gamma_1`` ...), the reassemble stages under
``pretrained.act_postprocess{n}`` (``0.project.0`` the readout, ``3`` the
1x1 convolution, ``4`` the deconvolution or strided convolution), the
fusion and the head under ``scratch``; ``zoe_port`` loads a checkpoint by
name. ``refinenet4`` has no ``resConfUnit1``: MiDaS never runs it.

As the JAX package does, the relative-position table is resized to the
input's token grid with ``jax.image.resize``'s Keys cubic
(``core.interpolate.resize``), not with ``F.interpolate``'s bicubic.
Tensors are NCHW with a batch. ``ZoeDepthDPT`` runs in float32 with TF32
off (``tapir.no_tf32``), so that the card can be held to the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pgdvs_tpu_torch.core.interpolate import resize, resize_axes
from pgdvs_tpu_torch.models.tracking.tapir import no_tf32


def gen_relative_position_index(h: int, w: int) -> np.ndarray:
    """timm BEiT relative_position_index for an (h, w) token grid (+cls)."""
    num_rel = (2 * h - 1) * (2 * w - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    n = h * w
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


def resize_rel_pos_table(table: torch.Tensor, src_hw, dst_hw) -> torch.Tensor:
    """The spatial part of a relative-position bias table [(2h-1)(2w-1)+3,
    heads] resized from the source grid's to the destination grid's with
    ``jax.image.resize(..., "cubic")`` (Keys a = -0.5, half-pixel centres,
    border taps dropped and renormalized, antialiased when shrinking); the
    three trailing cls entries kept."""
    sh, sw = 2 * src_hw[0] - 1, 2 * src_hw[1] - 1
    dh, dw = 2 * dst_hw[0] - 1, 2 * dst_hw[1] - 1
    if (sh, sw) == (dh, dw):
        return table
    heads = table.shape[-1]
    spatial = table[: sh * sw].reshape(sh, sw, heads)
    resized = resize(spatial, dh, dw, "cubic")
    return torch.cat([resized.reshape(dh * dw, heads), table[-3:]], 0)


class BeitAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, pretrained_grid: Tuple[int, int]):
        super().__init__()
        self.n_heads = n_heads
        self.pretrained_grid = tuple(pretrained_grid)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        num_rel = (2 * pretrained_grid[0] - 1) * (2 * pretrained_grid[1] - 1) + 3
        self.relative_position_bias_table = nn.Parameter(torch.zeros(num_rel, n_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, grid_hw, rel_index):
        """x [B, N, C] (N = grid tokens + cls); rel_index [N * N] long."""
        b, n, c = x.shape
        hd = c // self.n_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias)
        q, k, v = qkv.view(b, n, 3, self.n_heads, hd).permute(2, 0, 3, 1, 4)
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2)  # [B, heads, N, N]
        table = resize_rel_pos_table(self.relative_position_bias_table, self.pretrained_grid,
                                     grid_hw)
        # gathered per head into a contiguous [heads, N, N]
        rel = torch.index_select(table.t(), 1, rel_index).view(self.n_heads, n, n)
        attn = torch.softmax(logits + rel, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        # exact (erf) GELU, as timm's BEiT
        return self.fc2(F.gelu(self.fc1(x)))


class BeitBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, mlp_ratio: float,
                 pretrained_grid: Tuple[int, int]):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, n_heads, pretrained_grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x, grid_hw, rel_index):
        x = x + self.gamma_1 * self.attn(self.norm1(x), grid_hw, rel_index)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


def _resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.interpolate(mode="bilinear", align_corners=True)`` of NCHW."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    """MiDaS ResidualConvUnit_custom (bn=False): activation-first convs."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """MiDaS FeatureFusionBlock_custom (deconv / bn / expand off); without
    a skip input (``refinenet4``) it has no ``resConfUnit1``."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = _resize_bilinear_ac(x, x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(x)


class ProjectReadout(nn.Module):
    """DPT's "project" readout: each token concatenated with the cls token,
    then linear + exact GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        body = tokens[:, 1:]
        return self.project(torch.cat([body, tokens[:, :1].expand_as(body)], dim=-1))


class DPTBeitBackbone(nn.Module):
    """BEiT + DPT decoder; returns Zoe's hook set.

    Defaults are ``dpt_beit_large_384``. forward(img [B, 3, H, W],
    ImageNet-normalized, H and W multiples of 32) -> (relative depth
    [B, H, W], the head's 32-channel activation [B, 32, H, W], the
    bottleneck ``layer4_rn`` [B, features, H/32, W/32], the fusion outputs
    [r4, r3, r2, r1] at H/16 ... H/2).
    """

    def __init__(self, embed_dim: int = 1024, depth: int = 24, n_heads: int = 16,
                 mlp_ratio: float = 4.0, patch: int = 16, hooks: Sequence[int] = (5, 11, 17, 23),
                 features: int = 256,
                 reassemble_channels: Sequence[int] = (256, 512, 1024, 1024),
                 pretrained_grid: Tuple[int, int] = (24, 24),
                 head_features: Tuple[int, int] = (128, 32)):
        super().__init__()
        self.patch = patch
        self.hooks = tuple(hooks)
        self.embed_dim = embed_dim
        self._rel_index = {}  # (grid, device) -> the flattened relative-position index

        beit = nn.Module()
        beit.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        beit.patch_embed = nn.Module()
        beit.patch_embed.proj = nn.Conv2d(3, embed_dim, patch, stride=patch)
        beit.blocks = nn.ModuleList(BeitBlock(embed_dim, n_heads, mlp_ratio, pretrained_grid)
                                    for _ in range(depth))
        self.pretrained = nn.Module()
        self.pretrained.model = beit
        rc = reassemble_channels
        rescale = {1: nn.ConvTranspose2d(rc[0], rc[0], 4, stride=4),
                   2: nn.ConvTranspose2d(rc[1], rc[1], 2, stride=2),
                   4: nn.Conv2d(rc[3], rc[3], 3, stride=2, padding=1)}
        for n in range(1, 5):
            # Sequential indices of MiDaS's act_postprocess{n}: 1 and 2 are
            # the transpose / unflatten that hold no weights
            stages = [ProjectReadout(embed_dim), nn.Identity(), nn.Identity(),
                      nn.Conv2d(embed_dim, rc[n - 1], 1)]
            if n in rescale:
                stages.append(rescale[n])
            setattr(self.pretrained, f"act_postprocess{n}", nn.Sequential(*stages))

        self.scratch = nn.Module()
        for n in range(1, 5):
            setattr(self.scratch, f"layer{n}_rn",
                    nn.Conv2d(rc[n - 1], features, 3, padding=1, bias=False))
            setattr(self.scratch, f"refinenet{n}", FeatureFusionBlock(features, with_skip=n != 4))
        f1, f2 = head_features
        # output_conv.1 is MiDaS's x2 upsampling, run in forward
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(features, f1, 3, padding=1), nn.Identity(),
            nn.Conv2d(f1, f2, 3, padding=1), nn.ReLU(), nn.Conv2d(f2, 1, 1), nn.ReLU())

    def rel_index(self, grid_hw, device) -> torch.Tensor:
        key = (tuple(grid_hw), str(device))
        if key not in self._rel_index:
            idx = gen_relative_position_index(*grid_hw).reshape(-1)
            self._rel_index[key] = torch.from_numpy(idx).to(device)
        return self._rel_index[key]

    def forward(self, img):
        b, _, h, w = img.shape
        gh, gw = h // self.patch, w // self.patch
        beit = self.pretrained.model
        x = beit.patch_embed.proj(img).flatten(2).transpose(1, 2)  # [B, gh * gw, D]
        x = torch.cat([beit.cls_token.expand(b, -1, -1), x], dim=1)
        rel_index = self.rel_index((gh, gw), img.device)
        layers = []
        for i, block in enumerate(beit.blocks):
            x = block(x, (gh, gw), rel_index)
            if i in self.hooks:
                layers.append(x)

        maps = []
        for n, tokens in enumerate(layers, start=1):
            ap = getattr(self.pretrained, f"act_postprocess{n}")
            y = ap[0](tokens).transpose(1, 2).reshape(b, self.embed_dim, gh, gw)
            for stage in ap[3:]:
                y = stage(y)
            maps.append(y)

        sc = self.scratch
        rn = [getattr(sc, f"layer{n}_rn")(m) for n, m in enumerate(maps, start=1)]
        r4 = sc.refinenet4(rn[3])
        r3 = sc.refinenet3(r4, rn[2])
        r2 = sc.refinenet2(r3, rn[1])
        r1 = sc.refinenet1(r2, rn[0])

        head = sc.output_conv
        y = head[0](r1)
        y = _resize_bilinear_ac(y, y.shape[2] * 2, y.shape[3] * 2)
        out_conv_feat = F.relu(head[2](y))
        rel = F.relu(head[4](out_conv_feat))[:, 0]
        return rel, out_conv_feat, rn[3], [r4, r3, r2, r1]


# ImageNet normalization MiDaS applies before the core
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ZoeDepthDPT(nn.Module):
    """DPT-BEiT backbone (``midas``) + the checkpoint-faithful metric head
    (``head``) -> metric depth.

    variant: "single" (ZoeD_M12_N / _K; min / max_depth the domain's range:
    NYU 1e-3..10, KITTI 1e-3..80) or "nk" (ZoeD_M12_NK, two routed domain
    heads). forward(img [B, 3, H, W] in [0, 1]) -> depth [B, H, W]. The
    module holds no buffers, so it can be built on the meta device and
    filled by ``load_state_dict``.
    """

    def __init__(self, n_bins: int = 64, min_depth: float = 1e-3, max_depth: float = 10.0,
                 variant: str = "single", backbone_kwargs: Optional[dict] = None,
                 head_kwargs: Optional[dict] = None):
        super().__init__()
        from pgdvs_tpu_torch.models.depth.zoe_head import ZoeMetricHeadMulti, ZoeMetricHeadSingle

        bk = dict(backbone_kwargs or {})
        hk = dict(head_kwargs or {})
        self.variant = variant
        self.midas = DPTBeitBackbone(**bk)
        btl = bk.get("features", 256)
        if variant == "single":
            self.head = ZoeMetricHeadSingle(n_bins, min_depth=min_depth, max_depth=max_depth,
                                            bottleneck_features=btl, **hk)
        elif variant == "nk":
            self.head = ZoeMetricHeadMulti(bottleneck_features=btl, **hk)
        else:
            raise ValueError(f"unknown Zoe variant {variant!r}")

    def forward(self, img):
        mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)[:, None, None]
        with no_tf32():
            rel, out_conv_feat, l4_rn, pyramid = self.midas((img - mean) / std)
            depth = self.head(out_conv_feat, l4_rn, pyramid, rel)
        if self.variant == "nk":
            depth = depth[0]
        b, _, h, w = img.shape
        return resize_axes(depth[:, 0], (b, h, w), "linear")


def init_zoe_weights(model: nn.Module, seed: int = 0, layer_scale: float = 0.1) -> nn.Module:
    """Seeded, damped random weights for a ``ZoeDepthDPT`` (the released
    checkpoint is not in the repository): convolution and linear weights
    and biases uniform in ±1 / sqrt(fan_in) (torch's default bounds) from
    an explicit generator; layer norms scale 1, offset 0; BEiT's layer-scale
    gammas ``layer_scale`` (so that 24 blocks stay in range), its cls
    token, q / v biases and relative-position tables normal with std 0.02."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(t, bound):
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=gen))

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
                # a deconvolution with stride = kernel sums each output
                # pixel over its input channels only
                fan_in = (mod.weight.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                          else math.prod(mod.weight.shape[1:]))
                for t in (mod.weight, mod.bias):
                    if t is not None:
                        uniform(t, 1.0 / math.sqrt(fan_in))
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gamma_1", "gamma_2"):
                p.fill_(layer_scale)
            elif leaf in ("cls_token", "q_bias", "v_bias", "relative_position_bias_table",
                          "in_proj_bias"):
                p.copy_(torch.empty(p.shape).normal_(0.0, 0.02, generator=gen))
            elif leaf == "in_proj_weight":
                uniform(p, 1.0 / math.sqrt(p.shape[1]))
    return model
