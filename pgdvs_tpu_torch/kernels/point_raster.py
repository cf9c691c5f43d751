"""Z-buffered point splatting (torch).

Counterpart of ``pgdvs_tpu.kernels.point_raster``, which replaces
pytorch3d's ``PointsRasterizer`` + ``NormWeightedCompositor`` (the
reference's ``st_geo_renderer.py:85-120`` and ``pgdvs_renderer_dyn.py:
671-724``). Each point covers the pixels within a radius of its projection;
two passes over the static ``(2 * ceil(r_px) + 1)^2`` footprint:

  1. a z-buffer: ``scatter_reduce_(..., "amin")`` of the point depths over
     the covered pixels;
  2. every covering point within a relative depth band of the front surface
     adds ``w * colour`` and ``w`` (``w = 1 - d^2 / r^2``) by ``index_add_``;
     the sum is normalised at the end.

Plain tensor code on both devices (the JAX package does this in XLA, not
Pallas). Rounding follows the JAX function: ``torch.round`` rounds half to
even as ``jnp.round`` does, and the int casts truncate. On the card
``index_add_`` sums with atomics in an order that varies, so card results
agree with the CPU to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from pgdvs_tpu_torch.core import cameras

_FAR = 1e30


def footprint_px(radius: float, image_hw, ndc_radius: bool = True):
    """(radius in pixels, footprint half-extent): an NDC radius is in
    pytorch3d units, where the shorter image side spans [-1, 1]."""
    h, w = image_hw
    r_px = radius * min(h, w) / 2.0 if ndc_radius else radius
    return r_px, max(math.ceil(r_px), 1)


def point_taps(points, flat_cam, image_hw, valid, r_px: float, fp: int):
    """Project the points and list their footprint taps: (z [N], with 1e30
    where a point is padded or behind the camera, [(pixel index, d^2,
    covered) per tap]); the index is h * w where a tap misses."""
    h, w = image_hw
    uv, z, in_front = cameras.project_points(points.float(), flat_cam)
    ok = valid.bool() & in_front
    z = torch.where(ok, z, torch.full_like(z, _FAR))
    px, py = uv[:, 0], uv[:, 1]
    cx = torch.round(px).to(torch.int64)
    cy = torch.round(py).to(torch.int64)
    taps = []
    for dy in range(-fp, fp + 1):
        for dx in range(-fp, fp + 1):
            xi, yi = cx + dx, cy + dy
            d2 = (xi.float() - px) ** 2 + (yi.float() - py) ** 2
            cover = ok & (d2 <= r_px * r_px) & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            taps.append((torch.where(cover, yi * w + xi, torch.full_like(xi, h * w)), d2, cover))
    return z, taps


def zbuffer_pass(z, taps, n_pix: int):
    """Pass 1: [n_pix + 1] the nearest depth covering each pixel (1e30 where
    none); slot n_pix takes what misses."""
    zbuf = torch.full((n_pix + 1,), _FAR, dtype=torch.float32, device=z.device)
    far = torch.full_like(z, _FAR)
    for idx, _d2, cover in taps:
        zbuf.scatter_reduce_(0, idx, torch.where(cover, z, far), reduce="amin")
    return zbuf


def composite_pass(z, taps, zbuf, colors, image_hw, r_px: float, depth_band: float):
    """Pass 2: the colours of the covering points within ``depth_band`` of
    the front surface, weighted by ``1 - d^2 / r^2`` and normalised: image
    [H, W, C] and alpha [H, W, 1]."""
    h, w = image_hw
    cols = colors.float()
    num = torch.zeros((h * w + 1, cols.shape[1]), dtype=torch.float32, device=z.device)
    den = torch.zeros((h * w + 1,), dtype=torch.float32, device=z.device)
    zero = torch.zeros_like(z)
    for idx, d2, cover in taps:
        front = z <= zbuf[idx.clamp(0, h * w - 1)] * (1.0 + depth_band)
        wgt = torch.clamp(torch.where(cover & front, 1.0 - d2 / (r_px * r_px), zero), min=0.0)
        num.index_add_(0, idx, cols * wgt[:, None])
        den.index_add_(0, idx, wgt)
    num = num[:h * w].reshape(h, w, -1)
    den = den[:h * w].reshape(h, w, 1)
    alpha = (den > 0.0).float()
    return num / torch.clamp(den, min=1e-8) * alpha, alpha


@torch.no_grad()
def rasterize_points(points, colors, flat_cam, image_hw, valid=None, radius: float = 0.01,
                     depth_band: float = 0.01, ndc_radius: bool = True):
    """Render a (padded) coloured point cloud into a target camera.

    Args:
      points: [N, 3] world points; colors: [N, C]; flat_cam: [34].
      image_hw: (H, W); valid: [N] bool for padded entries.
      radius: point radius, in NDC units (``ndc_radius``) or pixels.
      depth_band: relative depth tolerance of the front surface.

    Returns image [H, W, C] (0 where nothing splats) and alpha [H, W, 1]
    (1 where any point covered the pixel).
    """
    h, w = image_hw
    if valid is None:
        valid = torch.ones((points.shape[0],), dtype=torch.bool, device=points.device)
    r_px, fp = footprint_px(radius, image_hw, ndc_radius)
    z, taps = point_taps(points, flat_cam, image_hw, valid, r_px, fp)
    zbuf = zbuffer_pass(z, taps, h * w)
    return composite_pass(z, taps, zbuf, colors, image_hw, r_px, depth_band)
