"""Epipolar projection + feature sampling for GNT (torch).

Counterpart of ``pgdvs_tpu.models.gnt.projector`` for its two samplers as
the static renderer calls them, views outer:

``epipolar_sample`` (the exact, reference-faithful sampler): rgb from the
full-resolution sources and features from the quarter-resolution ResUNet
output, each with its own zero-padded bilinear lookup
(``multiview_bilinear``), plus the ray-difference code and the validity
masks, which the split GNT kernels (K3) read.

The quad sampler (``epipolar_sample_fused(quad=True, views_outer=True,
with_ray_diff=False)``): each sample point is projected
into every source view and the fused full-resolution [V, H, W, 3+F(+1)]
map (rgb + align-corners-upsampled features + optionally the dynamic mask)
is sampled with a zero-padded bilinear tap, stencil corner clamped to
(W-2, H-2). The JAX package packs the 2x2 stencil into channels to cut TPU
gather rows; here the four taps are gathered from the fused map directly —
the same values. Without the dyn mask (``epipolar_sample_quad``) validity
and the ray-difference code are left to the GNT kernel; with it
(``epipolar_sample_quad_masked``) the sampler returns the validity masks
the masked kernel reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pgdvs_tpu_torch.core.cameras import (
    flat_cam_c2w,
    flat_cam_projection,
    pixel_inbound,
    project_with,
    ray_diff_features,
)
from pgdvs_tpu_torch.core.interpolate import resize_bilinear


def build_fused_maps(src_rgbs: torch.Tensor, src_feats: torch.Tensor,
                     src_invalid_masks=None, dtype=torch.bfloat16) -> torch.Tensor:
    """[V, H, W, 3] rgb + [V, Hf, Wf, F] features (+ [V, H, W, 1] dynamic
    masks, 1 = invalid) -> [V, H, W, 3+F(+1)] maps, features upsampled to
    full resolution (bilinear, align_corners), the mask as the trailing
    channel."""
    v, h, w, _ = src_rgbs.shape
    feats_up = torch.stack([resize_bilinear(f, h, w) for f in src_feats.float()])
    parts = [src_rgbs.float(), feats_up]
    if src_invalid_masks is not None:
        parts.append(src_invalid_masks.float())
    return torch.cat(parts, dim=-1).to(dtype).contiguous()


def project_all_views(pts: torch.Tensor, proj: torch.Tensor):
    """[R, S, 3] points, [V, 4, 4] K @ w2c -> uv [V, R, S, 2], z, in_front."""
    return project_with(proj[:, None, None], pts[None])


def _quad_taps(x: torch.Tensor, y: torch.Tensor, v: int, h: int, w: int):
    """Flat row indices of the stencil corner and the four zero-pad bilinear
    tap weights [(0,0), (0,1), (1,0), (1,1)] at pixel coordinates x, y
    [V, ...]."""
    sx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    sy = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    wx0 = torch.clamp(1.0 - torch.abs(x - sx), min=0.0)
    wx1 = torch.clamp(1.0 - torch.abs(x - (sx + 1.0)), min=0.0)
    wy0 = torch.clamp(1.0 - torch.abs(y - sy), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(y - (sy + 1.0)), min=0.0)
    offs = (torch.arange(v, device=x.device) * (h * w)).view((v,) + (1,) * (x.ndim - 1))
    base = (sy.long() * w + sx.long() + offs).reshape(-1)
    return base, ((0, wy0 * wx0), (1, wy0 * wx1), (w, wy1 * wx0),
                  (w + 1, wy1 * wx1))


def multiview_bilinear(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """Zero-padded bilinear samples of V same-size maps.

    Args: imgs [V, H, W, C]; x, y [V, ...] pixel coordinates per view.
    Returns [V, ..., C] in ``out_dtype`` (default: the maps' dtype), zero
    outside [0, W-1] x [0, H-1], stencil corner clamped to (W-2, H-2), as
    JAX's ``multiview_bilinear(zero_pad=True)``. Rows are gathered in the
    maps' dtype and lerped in float32 (JAX lerps in the maps' dtype), taps
    summed in JAX's order.
    """
    v, h, w, c = imgs.shape
    base, taps = _quad_taps(x, y, v, h, w)
    flat = imgs.reshape(v * h * w, c)
    out = None
    for dd, wgt in taps:
        tap = flat[base + dd].float() * wgt.reshape(-1, 1)
        out = tap if out is None else out + tap
    return out.reshape(x.shape + (c,)).to(out_dtype or imgs.dtype)


def epipolar_sample_quad(pts: torch.Tensor, proj: torch.Tensor,
                         fused_maps: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the fused maps at every projection.

    Args: pts [R, S, 3]; proj [V, 4, 4]; fused_maps [V, H, W, C].
    Returns rgb_feat [V, R, S, C] in the maps' dtype (zero outside
    [0, W-1] x [0, H-1]).
    """
    uv, _z, _front = project_all_views(pts, proj)
    return multiview_bilinear(fused_maps, uv[..., 0], uv[..., 1])


def epipolar_sample_quad_masked(pts: torch.Tensor, proj: torch.Tensor,
                                fused_maps: torch.Tensor):
    """``epipolar_sample_quad`` on maps whose trailing channel is the
    dynamic mask (``build_fused_maps(..., src_invalid_masks)``).

    Args: pts [R, S, 3]; proj [V, 4, 4]; fused_maps [V, H, W, C+1].
    Returns a dict, every entry views outer:
      rgb_feat [V, R, S, C] in the maps' dtype;
      mask_inbound [V, R, S] bool: in front and inside [0, W-1] x [0, H-1];
      mask_invalid [V, R, S] bool: the lerped mask channel > 1e-3;
      mask [V, R, S] bool: mask_inbound and not mask_invalid.

    The mask channel is lerped with the JAX package's bf16 arithmetic on its
    quad rows (``projector.quad_bilinear``: every product and partial sum
    rounded to bf16, (top pair) + (bottom pair)), so a tap whose value lies
    near the threshold falls on the same side.
    """
    v, h, w, c1 = fused_maps.shape
    c = c1 - 1
    uv, _z, in_front = project_all_views(pts, proj)
    base, taps = _quad_taps(uv[..., 0], uv[..., 1], v, h, w)
    flat = fused_maps.reshape(v * h * w, c1)

    def bf(x):
        return x.to(torch.bfloat16).float()

    feat, dyn = None, []
    for dd, wgt in taps:
        rows = flat[base + dd]
        f = rows[:, :c].float() * wgt.reshape(-1, 1)
        feat = f if feat is None else feat + f
        dyn.append(bf(rows[:, c].float() * bf(wgt.reshape(-1))))
    shape = uv.shape[:-1]
    inbound = pixel_inbound(uv, float(h), float(w)) & in_front
    lerped = bf(bf(dyn[0] + dyn[1]) + bf(dyn[2] + dyn[3]))
    invalid = lerped.reshape(shape) > 1e-3
    return {
        "rgb_feat": feat.reshape(shape + (c,)).to(fused_maps.dtype),
        "mask_inbound": inbound,
        "mask_invalid": invalid,
        "mask": inbound & ~invalid,
    }


class ExactMaps(NamedTuple):
    """What the exact sampler reads, per image: source rgb [V, H, W, 3] and
    ResUNet features [V, Hf, Wf, F] in the dtype to gather in, and the
    dynamic masks [V, H, W, 1] float32 (None without the dyn mask)."""

    rgbs: torch.Tensor
    feats: torch.Tensor
    invalid_masks: Optional[torch.Tensor] = None


def epipolar_sample(pts: torch.Tensor, tgt_cam: torch.Tensor, src_cams: torch.Tensor,
                    src_rgbs: torch.Tensor, src_feats: torch.Tensor,
                    src_invalid_masks=None):
    """Reference-exact epipolar sampling, views outer (JAX's
    ``epipolar_sample(views_outer=True)``).

    Args: pts [R, S, 3]; tgt_cam [34]; src_cams [V, 34]; src_rgbs
    [V, H, W, 3] and src_feats [V, Hf, Wf, F] in the dtype to gather in
    (the renderer passes bf16, JAX's ``sample_dtype``); src_invalid_masks
    optional [V, H, W, 1], 1 = dynamic.

    Returns a dict, every entry [V, R, S, *]:
      rgb_feat [V, R, S, 3+F] bf16: rgb at the projection (x, y), features
        at (x (Wf-1)/(W-1), y (Hf-1)/(H-1)) on the feature map itself;
      ray_diff [V, R, S, 4] float32;
      mask_inbound bool: in front and inside [0, W-1] x [0, H-1];
      mask_invalid bool: the float32 lerp of the dynamic mask > 1e-3
        (all False without masks);
      mask bool: mask_inbound and not mask_invalid.
    """
    h, w = src_rgbs.shape[1], src_rgbs.shape[2]
    hf, wf = src_feats.shape[1], src_feats.shape[2]
    uv, _z, in_front = project_all_views(pts, flat_cam_projection(src_cams))
    x, y = uv[..., 0], uv[..., 1]
    rgb = multiview_bilinear(src_rgbs, x, y, torch.bfloat16)
    feat = multiview_bilinear(src_feats, x * ((wf - 1.0) / (w - 1.0)),
                              y * ((hf - 1.0) / (h - 1.0)), torch.bfloat16)
    diff = ray_diff_features(pts[None], flat_cam_c2w(tgt_cam)[:3, 3],
                             flat_cam_c2w(src_cams)[:, None, None, :3, 3])
    inbound = pixel_inbound(uv, float(h), float(w)) & in_front
    if src_invalid_masks is not None:
        lerped = multiview_bilinear(src_invalid_masks.float(), x, y)[..., 0]
        invalid = lerped > 1e-3
    else:
        invalid = torch.zeros_like(inbound)
    return {
        "rgb_feat": torch.cat([rgb, feat], dim=-1),
        "ray_diff": diff,
        "mask_inbound": inbound,
        "mask_invalid": invalid,
        "mask": inbound & ~invalid,
    }
