"""Epipolar projection + feature sampling for GNT (torch).

Counterpart of ``pgdvs_tpu.models.gnt.projector`` for the samplers the
static renderer calls, views outer:

``epipolar_sample`` (the exact, reference-faithful sampler): rgb from the
full-resolution sources and features from the quarter-resolution ResUNet
output, each with its own zero-padded bilinear lookup
(``multiview_bilinear``), plus the ray-difference code and the validity
masks, which K2's unfolded mode reads.

The quad sampler (``epipolar_sample_fused(quad=True, views_outer=True,
with_ray_diff=False)``): each sample point is projected
into every source view and the fused full-resolution [V, H, W, 3+F(+1)]
map (rgb + align-corners-upsampled features + optionally the dynamic mask)
is sampled with a zero-padded bilinear tap, stencil corner clamped to
(W-2, H-2). The JAX package packs the 2x2 stencil into channels to cut TPU
gather rows; here the four taps are gathered from the fused map directly and
lerped with ``quad_bilinear``'s bf16 arithmetic (each tap weight, product
and partial sum rounded to bf16, (top pair) + (bottom pair)), so the samples
are JAX's bit for bit. Without the dyn mask (``epipolar_sample_quad``) validity
and the ray-difference code are left to the GNT kernel; with it
(``epipolar_sample_quad_masked``) the sampler returns the validity masks
the masked kernel reads. ``epipolar_sample_quad_raw`` leaves the lerp to
K2's fold_lerp mode: the four taps' rows and the fractional offsets.

``epipolar_sample`` and ``epipolar_sample_quad_masked``, the two samplers
the presets run with the dyn mask, take their plain versions
(``epipolar_sample_plain``, ``epipolar_sample_quad_masked_plain``) for CPU
tensors and one hand kernel (``kernels/epipolar.py``) for CUDA tensors;
the other samplers are plain torch on every device.

The fused and quad_i8 samplers (``epipolar_sample_fused``) repeat the JAX
package's arithmetic on its own maps: ``multiview_bilinear`` in bf16 on the
fused maps (``fused``), ``quad_bilinear`` on int8 quad maps
(``build_quad_maps``, ``quantize_quad_maps``, ``FlatQuadMaps``) dequantized
to bf16 (``quad_i8``), with the validity masks.

The patch sampler (``epipolar_sample_patch_raw``, the JAX package's fast
preset): rays come in by x bx pixel blocks; per (view, block, sample) ONE
row of the fy x fx-pixel patch maps is gathered at the block's anchor, and
every tap's 2x2 bilinear stencil becomes fy*fx coefficients over that row.
A tap whose stencil cell lies outside the block's footprint is clamped to
its border (``patch_clamp_fraction`` counts them). The combine of rows and
coefficients is left to the GNT kernel (K1's ``patch_rows`` mode).
``epipolar_sample_patch`` is JAX's combine outside the kernel (2x2 blocks
only), which no renderer path takes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pgdvs_tpu_torch.core.cameras import (
    flat_cam_c2w,
    flat_cam_projection,
    pixel_inbound,
    project_with,
    ray_diff_features,
)
from pgdvs_tpu_torch.core.interpolate import resize_bilinear
from pgdvs_tpu_torch.kernels import epipolar as epipolar_kernel


def build_fused_maps(src_rgbs: torch.Tensor, src_feats: torch.Tensor,
                     src_invalid_masks=None, dtype=torch.bfloat16) -> torch.Tensor:
    """[V, H, W, 3] rgb + [V, Hf, Wf, F] features (+ [V, H, W, 1] dynamic
    masks, 1 = invalid) -> [V, H, W, 3+F(+1)] maps in ``dtype``, the
    features cast to ``dtype`` and upsampled to full resolution (bilinear,
    align_corners, taps accumulated in float32), the mask as the trailing
    channel: the JAX package's ``build_fused_maps(..., dtype=bf16)`` bit for
    bit."""
    v, h, w, _ = src_rgbs.shape
    feats_up = torch.stack([resize_bilinear(f, h, w) for f in src_feats.to(dtype)])
    parts = [src_rgbs.to(dtype), feats_up]
    if src_invalid_masks is not None:
        parts.append(src_invalid_masks.to(dtype))
    return torch.cat(parts, dim=-1).contiguous()


class FlatQuadMaps(NamedTuple):
    """Quad maps as one row table (``pgdvs_tpu.models.gnt.projector.
    FlatQuadMaps``): row (v, y, x) holds the fused-map pixels (y, x),
    (y, x+1), (y+1, x), (y+1, x+1), edge-clamped, back to back; int8 with
    per-channel dequantization ``scales`` [4C] (``quantize_quad_maps``) or
    in the fused maps' dtype (scales None)."""

    flat: torch.Tensor                     # [V*H*W, 4C]
    vhw: Tuple[int, int, int]              # (V, H, W)
    scales: Optional[torch.Tensor] = None  # [4C] float32


def build_quad_maps(src_rgbs: torch.Tensor, src_feats: torch.Tensor,
                    src_invalid_masks=None) -> torch.Tensor:
    """The bf16 fused maps with the 2x2 bilinear stencil packed into
    channels: [V, H, W, 4C], pixel (y, x) holding the fused rows (y, x),
    (y, x+1), (y+1, x), (y+1, x+1), edge-clamped (the last column and row
    repeat)."""
    fused = build_fused_maps(src_rgbs, src_feats, src_invalid_masks)
    right = torch.cat([fused[:, :, 1:], fused[:, :, -1:]], dim=2)
    rowp = torch.cat([fused, right], dim=-1)                      # [V, H, W, 2C]
    down = torch.cat([rowp[:, 1:], rowp[:, -1:]], dim=1)
    return torch.cat([rowp, down], dim=-1)


def flatten_quad_maps(qmaps: torch.Tensor, scales=None) -> FlatQuadMaps:
    """[V, H, W, 4C] (``build_quad_maps`` / ``quantize_quad_maps``) ->
    ``FlatQuadMaps``."""
    v, h, w, c4 = qmaps.shape
    return FlatQuadMaps(qmaps.reshape(v * h * w, c4), (v, h, w), scales)


def quantize_quad_maps(qmaps: torch.Tensor):
    """Per-channel symmetric int8 quantization of a quad map: (int8 maps
    [V, H, W, 4C], scales [4C] float32), scale = max(|channel|, 1e-8) / 127,
    values rounded half to even. The scales are those of the 4C quad
    channels: the shifted copies lose column 0 / row 0 to the edge clamp,
    so their maxima can differ from the fused channel's."""
    f = qmaps.float()
    scale = torch.clamp(f.abs().amax(dim=(0, 1, 2)), min=1e-8) / 127.0
    return torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8), scale


def quad_bilinear(qmaps, x: torch.Tensor, y: torch.Tensor, scales=None) -> torch.Tensor:
    """Zero-padded bilinear samples read from quad maps, one row per tap.

    Args: qmaps [V, H, W, 4C] or ``FlatQuadMaps`` (its scales unless
    ``scales`` is given); x, y [V, ...] pixel coordinates per view.
    Returns [V, ..., C], zero outside [0, W-1] x [0, H-1]. With scales the
    int8 row is dequantized as int8 -> bf16 times the bf16 scale; the four
    products and sums run in the row's dtype, (top pair) + (bottom pair),
    every step rounded, as the JAX package computes them.
    """
    if isinstance(qmaps, FlatQuadMaps):
        scales = qmaps.scales if scales is None else scales
        (v, h, w), flat = qmaps.vhw, qmaps.flat
    else:
        v, h, w, _ = qmaps.shape
        flat = qmaps.reshape(v * h * w, -1)
    c = flat.shape[-1] // 4
    base, taps = _quad_taps(x, y, v, h, w)
    row = flat[base]                                              # [N, 4C]
    if scales is not None:
        row = row.to(torch.bfloat16) * scales.to(torch.bfloat16)
    corners = [row[:, k * c:(k + 1) * c] for k in range(4)]
    return _quad_lerp(corners, taps).reshape(x.shape + (c,))


def _quad_lerp(corners, taps) -> torch.Tensor:
    """The bilinear combine of the four tap rows [N, C] (corners (0,0),
    (0,1), (1,0), (1,1)) in the rows' dtype, as the JAX package's
    ``quad_bilinear`` computes it: each weight computed in float32 and cast
    to that dtype, each product and partial sum rounded to it, (top pair) +
    (bottom pair)."""
    wgt = [t[1].reshape(-1, 1).to(corners[0].dtype) for t in taps]
    top = corners[0] * wgt[0] + corners[1] * wgt[1]
    bot = corners[2] * wgt[2] + corners[3] * wgt[3]
    return top + bot


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
                       out_dtype=None, lerp_dtype=torch.float32) -> torch.Tensor:
    """Zero-padded bilinear samples of V same-size maps.

    Args: imgs [V, H, W, C]; x, y [V, ...] pixel coordinates per view.
    Returns [V, ..., C] in ``out_dtype`` (default: the maps' dtype), zero
    outside [0, W-1] x [0, H-1], stencil corner clamped to (W-2, H-2), as
    JAX's ``multiview_bilinear(zero_pad=True)``, taps summed in JAX's order.
    Rows are gathered in the maps' dtype and lerped in ``lerp_dtype``: the
    maps' own dtype repeats JAX's arithmetic (each tap weight, product and
    partial sum rounded to it); float32 rounds once at the end.
    """
    v, h, w, c = imgs.shape
    base, taps = _quad_taps(x, y, v, h, w)
    flat = imgs.reshape(v * h * w, c)
    out = None
    for dd, wgt in taps:
        tap = flat[base + dd].to(lerp_dtype) * wgt.reshape(-1, 1).to(lerp_dtype)
        out = tap if out is None else out + tap
    return out.reshape(x.shape + (c,)).to(out_dtype or imgs.dtype)


def _sample_fused_quad(pts: torch.Tensor, proj: torch.Tensor, fused_maps: torch.Tensor):
    """Project into every view and lerp the fused maps' four taps with
    ``_quad_lerp``: (samples [V, R, S, C] in the maps' dtype, uv, in_front)."""
    v, h, w, c = fused_maps.shape
    uv, _z, in_front = project_all_views(pts, proj)
    base, taps = _quad_taps(uv[..., 0], uv[..., 1], v, h, w)
    flat = fused_maps.reshape(v * h * w, c)
    out = _quad_lerp([flat[base + dd] for dd, _ in taps], taps)
    return out.reshape(uv.shape[:-1] + (c,)), uv, in_front


def epipolar_sample_quad(pts: torch.Tensor, proj: torch.Tensor,
                         fused_maps: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the fused maps at every projection.

    Args: pts [R, S, 3]; proj [V, 4, 4]; fused_maps [V, H, W, C] bf16.
    Returns rgb_feat [V, R, S, C] in the maps' dtype (zero outside
    [0, W-1] x [0, H-1]): the JAX package's quad sampler bit for bit.
    """
    return _sample_fused_quad(pts, proj, fused_maps)[0]


def epipolar_sample_quad_masked(pts: torch.Tensor, proj: torch.Tensor,
                                fused_maps: torch.Tensor):
    """``epipolar_sample_quad`` on maps whose trailing channel is the
    dynamic mask (``build_fused_maps(..., src_invalid_masks)``): the plain
    version (``epipolar_sample_quad_masked_plain``) for CPU tensors, the
    hand kernel (``kernels/epipolar.py``) for CUDA tensors, which writes
    rgb_feat contiguous and takes only bf16 maps.
    """
    if pts.device.type == "cpu":
        return epipolar_sample_quad_masked_plain(pts, proj, fused_maps)
    return epipolar_kernel.sample_quad_masked(pts, proj, fused_maps)


def epipolar_sample_quad_masked_plain(pts: torch.Tensor, proj: torch.Tensor,
                                      fused_maps: torch.Tensor):
    """``epipolar_sample_quad_masked`` in plain torch, on any device.

    Args: pts [R, S, 3]; proj [V, 4, 4]; fused_maps [V, H, W, C+1] bf16.
    Returns a dict, every entry views outer:
      rgb_feat [V, R, S, C] in the maps' dtype;
      mask_inbound [V, R, S] bool: in front and inside [0, W-1] x [0, H-1];
      mask_invalid [V, R, S] bool: the lerped mask channel > 1e-3;
      mask [V, R, S] bool: mask_inbound and not mask_invalid.

    Features and mask channel are lerped together with the JAX package's
    bf16 arithmetic (``_quad_lerp``), so a tap whose mask value lies near
    the threshold falls on the same side.
    """
    _v, h, w, _c1 = fused_maps.shape
    sampled, uv, in_front = _sample_fused_quad(pts, proj, fused_maps)
    inbound = pixel_inbound(uv, float(h), float(w)) & in_front
    invalid = sampled[..., -1].float() > 1e-3
    return {
        "rgb_feat": sampled[..., :-1],
        "mask_inbound": inbound,
        "mask_invalid": invalid,
        "mask": inbound & ~invalid,
    }


def epipolar_sample_quad_raw(pts: torch.Tensor, proj: torch.Tensor,
                             fused_maps: torch.Tensor):
    """Raw quad rows and fractional offsets, for K2's fold_lerp mode
    (``gnt_fused_apply_mono3(..., fold_lerp=True, frac=...)``, which combines
    them): the JAX package's ``epipolar_sample_quad_raw`` on the rows of
    its ``build_quad_maps``. No preset reaches it; the unmasked maps only.

    Args: pts [R, S, 3]; proj [V, 4, 4]; fused_maps [V, H, W, C].
    Returns a dict, every entry views outer:
      rows [V, R, S, 4C] in the maps' dtype: the fused map's pixels
        (sy, sx), (sy, sx+1), (sy+1, sx), (sy+1, sx+1), edge-clamped;
      frac [V, R, S, 2] float32: (x - sx, y - sy), with sx = floor(x)
        clamped to [0, W-2] and sy = floor(y) to [0, H-2];
      mask_inbound, mask [V, R, S] bool: in front and inside
        [0, W-1] x [0, H-1]; mask_invalid: all False.
    """
    v, h, w, _c = fused_maps.shape
    uv, _z, in_front = project_all_views(pts, proj)
    x, y = uv[..., 0], uv[..., 1]
    sx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    sy = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    ix, iy = sx.long(), sy.long()
    ix1, iy1 = torch.clamp(ix + 1, max=w - 1), torch.clamp(iy + 1, max=h - 1)
    vi = torch.arange(v, device=pts.device).view(v, 1, 1)
    rows = torch.cat([fused_maps[vi, iy, ix], fused_maps[vi, iy, ix1],
                      fused_maps[vi, iy1, ix], fused_maps[vi, iy1, ix1]], dim=-1)
    inbound = pixel_inbound(uv, float(h), float(w)) & in_front
    return {
        "rows": rows,
        "frac": torch.stack([x - sx, y - sy], dim=-1),
        "mask_inbound": inbound,
        "mask_invalid": torch.zeros_like(inbound),
        "mask": inbound,
    }


def epipolar_sample_fused(pts: torch.Tensor, proj: torch.Tensor, maps, with_mask: bool,
                          quad: bool = False, scales=None):
    """One bilinear tap set per (sample, view) on per-image fused maps: the
    ``fused`` mode (``build_fused_maps``, features double-interpolated,
    lerped in the maps' dtype through ``multiview_bilinear``) or, with
    ``quad``, the quad maps (``FlatQuadMaps``, int8 with scales for
    ``quad_i8``, through ``quad_bilinear``); the JAX package's
    ``epipolar_sample_fused(views_outer=True, with_ray_diff=False)``.

    Args: pts [R, S, 3]; proj [V, 4, 4]; maps [V, H, W, C(+1)] or
    FlatQuadMaps; with_mask: the maps' trailing channel is the dynamic mask.
    Returns a dict, every entry views outer:
      rgb_feat [V, R, S, C] bf16 (the maps' dtype, or bf16 from int8);
      mask_inbound [V, R, S] bool: in front and inside [0, W-1] x [0, H-1];
      mask_invalid [V, R, S] bool: the lerped mask channel > 1e-3, compared
        in its dtype (all False without the mask);
      mask [V, R, S] bool: mask_inbound and not mask_invalid.
    """
    v, h, w = maps.vhw if isinstance(maps, FlatQuadMaps) else maps.shape[:3]
    uv, _z, in_front = project_all_views(pts, proj)
    x, y = uv[..., 0], uv[..., 1]
    if quad:
        sampled = quad_bilinear(maps, x, y, scales)
    else:
        sampled = multiview_bilinear(maps, x, y, lerp_dtype=maps.dtype)
    inbound = pixel_inbound(uv, float(h), float(w)) & in_front
    if with_mask:
        invalid = sampled[..., -1] > torch.tensor(1e-3, dtype=sampled.dtype)
        sampled = sampled[..., :-1]
    else:
        invalid = torch.zeros_like(inbound)
    return {"rgb_feat": sampled, "mask_inbound": inbound, "mask_invalid": invalid,
            "mask": inbound & ~invalid}


class FlatPatchMaps(NamedTuple):
    """fy x fx-pixel patch maps as one row table: row (v, y, x) holds the
    fused-map pixels (y+i, x+j), edge-clamped, at channel block p = i*fx + j
    (``pgdvs_tpu.models.gnt.projector.FlatPatchMaps``)."""

    flat: torch.Tensor               # [V*H*W, fy*fx*C]
    vhw: Tuple[int, int, int]        # (V, H, W)
    foot: Tuple[int, int] = (4, 4)   # (fy, fx) patch footprint in pixels
    block: Tuple[int, int] = (2, 2)  # (by, bx) ray block it serves


# ray-block name -> ((by, bx) pixel block, (fy, fx) patch footprint): the
# footprint is the block plus 2 per axis (intra-block spread + the 2x2 stencil)
PATCH_BLOCKS = {"2x2": ((2, 2), (4, 4)), "4x2": ((4, 2), (6, 4))}


def build_patch_maps(src_rgbs: torch.Tensor, src_feats: torch.Tensor,
                     foot=(4, 4), block=(2, 2)) -> FlatPatchMaps:
    """The bf16 fused maps (``build_fused_maps``, no dynamic mask) with an
    fy x fx-pixel footprint packed into channels: fy*fx times their memory
    (2.66 GB for 4x2 at 10 x 288 x 550 x 35)."""
    fused = build_fused_maps(src_rgbs, src_feats)
    v, h, w, c = fused.shape
    fy, fx = foot
    dev = fused.device
    ys = torch.clamp(torch.arange(h, device=dev)[:, None] + torch.arange(fy, device=dev),
                     max=h - 1)                                    # [H, fy]
    xs = torch.clamp(torch.arange(w, device=dev)[:, None] + torch.arange(fx, device=dev),
                     max=w - 1)                                    # [W, fx]
    patch = fused[:, ys[:, None, :, None], xs[None, :, None, :]]   # [V, H, W, fy, fx, C]
    return FlatPatchMaps(patch.reshape(v * h * w, fy * fx * c), (v, h, w),
                         tuple(foot), tuple(block))


def _patch_gather(pts: torch.Tensor, proj: torch.Tensor, pmaps: FlatPatchMaps):
    """Anchor selection and the one row gather per (view, block, sample).

    The anchor is the least stencil cell over the block's taps that can
    contribute (within 1 px of the image; 1e9 for the others), clipped to
    [0, W-fx] x [0, H-fy]. Returns (rows [V, B, S, fy*fx*C], x, y, sx, sy
    [V, R, S], ax, ay [V, B, S]) where B = R / (by*bx).
    """
    (v, h, w), flat = pmaps.vhw, pmaps.flat
    fy, fx = pmaps.foot
    nb = pmaps.block[0] * pmaps.block[1]
    r, s = pts.shape[0], pts.shape[1]
    if r % nb != 0:
        raise ValueError(f"patch mode needs rays % {nb} == 0, got {r}")
    b = r // nb
    uv, _z, _front = project_all_views(pts, proj)
    x, y = uv[..., 0], uv[..., 1]
    sx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    sy = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    reach = (x > -1.0) & (x < float(w)) & (y > -1.0) & (y < float(h))

    def anchor(cell, hi):
        least = cell.masked_fill(~reach, 1e9).reshape(v, b, nb, s).amin(dim=2)
        return torch.clamp(least, 0, max(hi, 0))

    ax, ay = anchor(sx, w - fx), anchor(sy, h - fy)
    offs = (torch.arange(v, device=pts.device) * (h * w)).view(v, 1, 1)
    base = ay.long() * w + ax.long() + offs
    rows = flat[base.reshape(-1)].reshape(v, b, s, flat.shape[-1])
    return rows, x, y, sx, sy, ax, ay


def epipolar_sample_patch_raw(pts: torch.Tensor, proj: torch.Tensor,
                              pmaps: FlatPatchMaps):
    """Raw patch rows and per-tap stencil coefficients, for K1's
    ``patch_rows`` mode (``gnt_fused_mono4_patch``).

    Args: pts [R, S, 3] with rays in by x bx pixel blocks (``patch_ray_perm``);
    proj [V, 4, 4]; pmaps from ``build_patch_maps``.
    Returns {"rows": [V, R/(by*bx), S, n_pos*C] (the maps' dtype),
    "coef": [V, R/4, 4, S, n_pos] in the rows' dtype}, n_pos = fy*fx:
    ray r's features at sample s are sum_p rows[v, r // (by*bx), s, p*C:(p+1)*C]
    * coef[v, r // 4, r % 4, s, p]. The coefficients are the zero-padded
    bilinear weights at the stencil cell's offset (dy, dx) from the anchor,
    each clipped to [0, fy-2] x [0, fx-2], computed in float32 and rounded
    once, as the JAX package does.
    """
    rows, x, y, sx, sy, ax, ay = _patch_gather(pts, proj, pmaps)
    v, b, s, _ = rows.shape
    fy, fx = pmaps.foot
    nb = pmaps.block[0] * pmaps.block[1]
    r = pts.shape[0]

    def bcast(a):  # [V, B, S] -> [V, R, S]
        return a[:, :, None, :].expand(v, b, nb, s).reshape(v, r, s)

    wx0 = torch.clamp(1.0 - torch.abs(x - sx), min=0.0)
    wx1 = torch.clamp(1.0 - torch.abs(x - (sx + 1.0)), min=0.0)
    wy0 = torch.clamp(1.0 - torch.abs(y - sy), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(y - sy - 1.0), min=0.0)
    dx = torch.clamp(sx - bcast(ax), 0.0, float(fx - 2))[..., None]
    dy = torch.clamp(sy - bcast(ay), 0.0, float(fy - 2))[..., None]
    pi = torch.arange(fy, dtype=torch.float32, device=pts.device)
    pj = torch.arange(fx, dtype=torch.float32, device=pts.device)
    cy = wy0[..., None] * (dy == pi) + wy1[..., None] * (dy == pi - 1.0)   # [V, R, S, fy]
    cx = wx0[..., None] * (dx == pj) + wx1[..., None] * (dx == pj - 1.0)   # [V, R, S, fx]
    coef = (cy[..., :, None] * cx[..., None, :]).to(rows.dtype)
    return {"rows": rows, "coef": coef.reshape(v, r // 4, 4, s, fy * fx)}


def epipolar_sample_patch(pts: torch.Tensor, proj: torch.Tensor,
                          pmaps: FlatPatchMaps) -> torch.Tensor:
    """The JAX package's XLA-combine patch sampler (2x2 ray blocks only),
    which it reaches with mono3 + patch and no preset picks: the rows and
    anchors of ``_patch_gather``, each tap's 2x2 stencil at its offset
    (dy, dx) from the anchor, clipped to [0, 2]^2, combined outside the
    kernel as 16 separable coefficients in the rows' dtype (rounded, then
    accumulated position by position, as JAX does).

    Args: pts [R, S, 3] with rays in 2x2 pixel blocks (``patch_ray_perm``);
    proj [V, 4, 4]; pmaps from ``build_patch_maps(foot=(4, 4), block=(2, 2))``.
    Returns rgb_feat [V, R, S, C] in the maps' dtype (K1's ``rgb_feat``
    contract; validity, ray-diff and point code are the kernel's).
    """
    if pmaps.block != (2, 2):
        raise ValueError("the XLA-combine patch sampler supports only 2x2 ray blocks "
                         f"(got {pmaps.block}); larger blocks need K1's patch_rows mode")
    rows, x, y, sx, sy, ax, ay = _patch_gather(pts, proj, pmaps)
    v, b, s, c16 = rows.shape
    c = c16 // 16
    dt = rows.dtype

    def per_tap(q):  # [V, R, S] -> [V, B, S, 4]
        return q.reshape(v, b, 4, s).permute(0, 1, 3, 2)

    wx0 = per_tap(torch.clamp(1.0 - torch.abs(x - sx), min=0.0))
    wx1 = per_tap(torch.clamp(1.0 - torch.abs(x - (sx + 1.0)), min=0.0))
    wy0 = per_tap(torch.clamp(1.0 - torch.abs(y - sy), min=0.0))
    wy1 = per_tap(torch.clamp(1.0 - torch.abs(y - sy - 1.0), min=0.0))
    dx = torch.clamp(per_tap(sx) - ax[..., None], 0.0, 2.0)
    dy = torch.clamp(per_tap(sy) - ay[..., None], 0.0, 2.0)
    cy = [(wy0 * (dy == i) + wy1 * (dy == i - 1)).to(dt) for i in range(4)]
    cx = [(wx0 * (dx == j) + wx1 * (dx == j - 1)).to(dt) for j in range(4)]
    out = torch.zeros((v, b, s, 4, c), dtype=dt, device=rows.device)
    for i in range(4):
        for j in range(4):
            p = i * 4 + j
            out = out + rows[:, :, :, None, p * c:(p + 1) * c] * (cy[i] * cx[j])[..., None]
    return out.permute(0, 1, 3, 2, 4).reshape(v, pts.shape[0], s, c)


def patch_clamp_counts(pts: torch.Tensor, proj: torch.Tensor, pmaps: FlatPatchMaps):
    """(clamped, in reach): the taps within reach of the image, and those
    of them whose stencil cell falls outside the block's footprint and is
    clamped to its border (sampled up to 2 px off against quad)."""
    _, x, y, sx, sy, ax, ay = _patch_gather(pts, proj, pmaps)
    (v, h, w), (fy, fx) = pmaps.vhw, pmaps.foot
    nb = pmaps.block[0] * pmaps.block[1]
    b, s = ax.shape[1], ax.shape[2]
    reach = ((x > -1.0) & (x < float(w)) & (y > -1.0) & (y < float(h))).reshape(v, b, nb, s)
    dx = sx.reshape(v, b, nb, s) - ax[:, :, None, :]
    dy = sy.reshape(v, b, nb, s) - ay[:, :, None, :]
    clamped = reach & ((dx < 0) | (dx > fx - 2) | (dy < 0) | (dy > fy - 2))
    return clamped.sum(), reach.sum()


def patch_clamp_fraction(pts: torch.Tensor, proj: torch.Tensor,
                         pmaps: FlatPatchMaps) -> torch.Tensor:
    """Share of the in-reach taps clamped to the block's border
    (``patch_clamp_counts``). Near 0 for rig-like cameras; a large value
    flags a rig that stretches blocks past the footprint."""
    clamped, reach = patch_clamp_counts(pts, proj, pmaps)
    return clamped / torch.clamp(reach, min=1)


class ExactMaps(NamedTuple):
    """What the exact sampler reads, per image: source rgb [V, H, W, 3] and
    ResUNet features [V, Hf, Wf, F] in the dtype to gather in, and the
    dynamic masks [V, H, W, 1] float32 (None without the dyn mask)."""

    rgbs: torch.Tensor
    feats: torch.Tensor
    invalid_masks: Optional[torch.Tensor] = None


def epipolar_sample(pts: torch.Tensor, tgt_cam: torch.Tensor, src_cams: torch.Tensor,
                    src_rgbs: torch.Tensor, src_feats: torch.Tensor,
                    src_invalid_masks=None, out_dtype=torch.bfloat16,
                    lerp_dtype=torch.float32):
    """Reference-exact epipolar sampling, views outer: the plain version
    (``epipolar_sample_plain``, which documents the arguments) for CPU
    tensors, the hand kernel (``kernels/epipolar.py``) for CUDA tensors,
    which takes only bf16 maps lerped in float32 into bf16 samples."""
    if pts.device.type == "cpu":
        return epipolar_sample_plain(pts, tgt_cam, src_cams, src_rgbs, src_feats,
                                     src_invalid_masks, out_dtype, lerp_dtype)
    return epipolar_kernel.sample_exact(pts, tgt_cam, src_cams, src_rgbs, src_feats,
                                        src_invalid_masks, out_dtype, lerp_dtype)


def epipolar_sample_plain(pts: torch.Tensor, tgt_cam: torch.Tensor, src_cams: torch.Tensor,
                          src_rgbs: torch.Tensor, src_feats: torch.Tensor,
                          src_invalid_masks=None, out_dtype=torch.bfloat16,
                          lerp_dtype=torch.float32):
    """Reference-exact epipolar sampling, views outer (JAX's
    ``epipolar_sample(views_outer=True)``), in plain torch on any device.

    Args: pts [R, S, 3]; tgt_cam [34]; src_cams [V, 34]; src_rgbs
    [V, H, W, 3] and src_feats [V, Hf, Wf, F] in the dtype to gather in
    (the renderer passes bf16, JAX's ``sample_dtype``); src_invalid_masks
    optional [V, H, W, 1], 1 = dynamic; out_dtype / lerp_dtype: the
    samples' dtype and the one they are lerped in (``multiview_bilinear``;
    the training path passes its network's dtype for both, as JAX's flax
    path samples).

    Returns a dict, every entry [V, R, S, *]:
      rgb_feat [V, R, S, 3+F] in out_dtype: rgb at the projection (x, y),
        features at (x (Wf-1)/(W-1), y (Hf-1)/(H-1)) on the feature map
        itself;
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
    rgb = multiview_bilinear(src_rgbs, x, y, out_dtype, lerp_dtype)
    feat = multiview_bilinear(src_feats, x * ((wf - 1.0) / (w - 1.0)),
                              y * ((hf - 1.0) / (h - 1.0)), out_dtype, lerp_dtype)
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
