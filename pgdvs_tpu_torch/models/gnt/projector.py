"""Epipolar projection + feature sampling for GNT (torch).

Counterpart of ``pgdvs_tpu.models.gnt.projector`` for the quad sampler as
the static renderer calls it (``epipolar_sample_fused(quad=True,
views_outer=True, with_ray_diff=False, emit_mask=False)``): each sample
point is projected into every source view and the fused full-resolution
[V, H, W, 3+F] map (rgb + align-corners-upsampled features) is sampled with
a zero-padded bilinear tap, stencil corner clamped to (W-2, H-2). The JAX
package packs the 2x2 stencil into channels to cut TPU gather rows; here
the four taps are gathered from the fused map directly — the same values.
Validity and the ray-difference code are left to the GNT kernel.
"""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.core.cameras import project_with
from pgdvs_tpu_torch.core.interpolate import resize_bilinear


def build_fused_maps(src_rgbs: torch.Tensor, src_feats: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """[V, H, W, 3] rgb + [V, Hf, Wf, F] features -> [V, H, W, 3+F] maps,
    features upsampled to full resolution (bilinear, align_corners)."""
    v, h, w, _ = src_rgbs.shape
    feats_up = torch.stack([resize_bilinear(f, h, w) for f in src_feats.float()])
    return torch.cat([src_rgbs.float(), feats_up], dim=-1).to(dtype).contiguous()


def project_all_views(pts: torch.Tensor, proj: torch.Tensor):
    """[R, S, 3] points, [V, 4, 4] K @ w2c -> uv [V, R, S, 2], z, in_front."""
    return project_with(proj[:, None, None], pts[None])


def epipolar_sample_quad(pts: torch.Tensor, proj: torch.Tensor,
                         fused_maps: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the fused maps at every projection.

    Args: pts [R, S, 3]; proj [V, 4, 4]; fused_maps [V, H, W, C].
    Returns rgb_feat [V, R, S, C] in the maps' dtype (zero outside
    [0, W-1] x [0, H-1]).
    """
    v, h, w, c = fused_maps.shape
    uv, _z, _front = project_all_views(pts, proj)
    x, y = uv[..., 0], uv[..., 1]
    sx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    sy = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    wx0 = torch.clamp(1.0 - torch.abs(x - sx), min=0.0)
    wx1 = torch.clamp(1.0 - torch.abs(x - (sx + 1.0)), min=0.0)
    wy0 = torch.clamp(1.0 - torch.abs(y - sy), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(y - (sy + 1.0)), min=0.0)
    offs = (torch.arange(v, device=pts.device) * (h * w)).view(v, 1, 1)
    base = (sy.long() * w + sx.long() + offs).reshape(-1)
    flat = fused_maps.reshape(v * h * w, c)
    out = None
    for dd, wgt in ((0, wy0 * wx0), (1, wy0 * wx1), (w, wy1 * wx0),
                    (w + 1, wy1 * wx1)):
        tap = flat[base + dd].float() * wgt.reshape(-1, 1)
        out = tap if out is None else out + tap
    return out.reshape(x.shape + (c,)).to(fused_maps.dtype)
