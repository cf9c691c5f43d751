"""Plain reference of PGDVS's pure-geometry static layer (Zhao et al., ICLR
2024, the ``st_cvd_*`` rows): the whole video's static pixels as one point
cloud, cleaned by statistical outlier removal, splatted into the target.

Written from the method's description and the reference implementation's
documented behaviour (its ``nvidia_eval_pure_geo.py`` aggregation and
pytorch3d's ``PointsRasterizer`` + ``NormWeightedCompositor``), in plain
torch / numpy, with nothing of the program:

* ``aggregate_static_cloud``: each frame's static pixels (integer pixel
  centres) lifted by their z-depth through the frame's camera, in float64;
  a frame after the first adds only the static pixels that the cloud so far
  does not cover, a pixel being covered where a cloud point in front of the
  camera projects inside [0, w-1] x [0, h-1] and its coordinates, truncated,
  name it (``covered_pixels``, which can also name the pixels whose
  coverage turns on a projection's rounding: a point of one frame seen
  again by the same camera projects onto integer coordinates).
* ``static_outlier_rule``: the mean of each point's K nearest squared
  distances from direct differences, in query blocks against the whole
  cloud (``render.knn_means``), kept below median + t * std
  (``render.outlier_threshold``).
* ``splat_points``: each kept point covers the pixels whose integer centres
  lie within its radius of its projection (the radius in NDC units, the
  shorter image side spanning [-1, 1], as pytorch3d's); a pixel's front
  depth is the least depth covering it; the points within a relative depth
  band of it add w * colour and w, w = 1 - d^2 / r^2; colour = the sums'
  ratio, mask = 1 where the weights sum above 0.

``low=True`` is the control, one precision step down from what the
configuration states (float32 points and colours, float32 sums): the
unprojected points in bf16 and their colours in 4 bits (the frames' 8), the
K-NN's points and distances in bf16, the splat's colours and weights in
bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import render


def _bf16_np(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def unproject(frame):
    """[H*W, 3] float64: the frame's pixels (integer centres, row-major)
    lifted by their z-depth."""
    h, w = frame["depth"].shape
    k = np.asarray(frame["k"], np.float64)[:3, :3]
    c2w = np.asarray(frame["c2w"], np.float64)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([gx, gy, np.ones_like(gx)], -1).reshape(-1, 3).astype(np.float64)
    dirs = pix @ (c2w[:3, :3] @ np.linalg.inv(k)).T
    return c2w[:3, 3] + dirs * np.asarray(frame["depth"], np.float64).reshape(-1, 1)


def covered_pixels(xyz, k, c2w, h, w, tie_px=0.0):
    """(sure, maybe) [H*W] bool: the pixels that the points xyz [N, 3] name
    in the camera (k [3, 3], c2w [4, 4]): in front, inside [0, w-1] x
    [0, h-1], the projected coordinates truncated. A projection within
    ``tie_px`` of a truncation or an image bound is a tie: ``sure`` holds
    the pixels named whichever way the ties go, ``maybe`` those named
    some way; without ties the two are equal."""
    k = np.asarray(k, np.float64)[:3, :3]
    c2w = np.asarray(c2w, np.float64)
    cam = (np.asarray(xyz, np.float64) - c2w[:3, 3]) @ c2w[:3, :3]  # R^T (x - t)
    pix = cam @ k.T
    z = pix[:, 2]
    u, v = (pix[:, j] / np.maximum(z, 1e-8) for j in (0, 1))
    e = tie_px
    cols = (np.floor(u - e), np.floor(u + e))
    rows = (np.floor(v - e), np.floor(v + e))
    front = z > 0
    sure_pt = (front & (cols[0] == cols[1]) & (rows[0] == rows[1]) & (u - e >= 0)
               & (u + e <= w - 1) & (v - e >= 0) & (v + e <= h - 1))
    sure = np.zeros(h * w, bool)
    sure[(rows[0][sure_pt] * w + cols[0][sure_pt]).astype(np.int64)] = True
    near = front & (u + e >= 0) & (u - e <= w - 1) & (v + e >= 0) & (v - e <= h - 1)
    maybe = sure.copy()
    for c in cols:
        for r in rows:
            ok = near & (c >= 0) & (c <= w - 1) & (r >= 0) & (r <= h - 1)
            maybe[(r[ok] * w + c[ok]).astype(np.int64)] = True
    return sure, maybe


def aggregate_static_cloud(frames, low=False):
    """The video's static cloud: {"xyz" [N, 3], "rgb" [N, 3] float32,
    "starts" [F + 1] (the first row each frame adds, then N), "covered" [F]
    ([H*W] bool per frame, the pixels the cloud so far covers; none for the
    first)}.

    frames: in video order, dicts of ``rgb`` [H, W, 3] in [0, 1], ``depth``
    [H, W] z-depth, ``static`` [H, W] bool, ``k`` [3, 3] intrinsics at this
    size, ``c2w`` [4, 4] (OpenCV axes). ``low``: the points in bf16 and the
    colours in 4 bits (the control)."""
    xyz, rgb, starts, covered = [np.zeros((0, 3))], [np.zeros((0, 3))], [0], []
    n = 0
    for i, fr in enumerate(frames):
        h, w = fr["depth"].shape
        pts = unproject(fr)
        col = np.asarray(fr["rgb"], np.float64).reshape(-1, 3)
        if low:
            pts, col = _bf16_np(pts), np.round(col * 15.0) / 15.0
        cov = np.zeros(h * w, bool)
        if i > 0 and n:
            cov = covered_pixels(np.concatenate(xyz), fr["k"], fr["c2w"], h, w)[0]
        covered.append(cov if i > 0 else None)
        add = np.asarray(fr["static"], bool).reshape(-1) & ~cov
        xyz.append(pts[add])
        rgb.append(col[add])
        n += int(add.sum())
        starts.append(n)
    return {"xyz": np.concatenate(xyz).astype(np.float32),
            "rgb": np.concatenate(rgb).astype(np.float32),
            "starts": starts, "covered": covered}


def static_outlier_rule(points, valid, k=50, std_thres=0.2, low=False):
    """(means [N], threshold, keep [N]) of the static cloud's statistical
    outlier removal: ``render.knn_means`` (direct differences, query blocks)
    and ``render.outlier_threshold``, in float64 for the rule."""
    means = render.knn_means(points, valid, k, low)
    thres = float(render.outlier_threshold(means, valid, std_thres))
    return means, thres, valid & (means.double() < thres)


def radius_px(radius, hw):
    """The NDC radius in pixels: the shorter image side spans [-1, 1]."""
    return radius * min(hw) / 2.0


def _footprint(points, flat_cam, hw, r):
    """Per (point, tap): the covered pixel's flat index (h * w where it is
    not covered), d^2 and z; the taps are the integer pixels from
    floor(x) - ceil(r) to floor(x) + ceil(r) + 1 (likewise in y)."""
    h, w = hw
    proj = render.cam_k(flat_cam).double() @ torch.linalg.inv(render.cam_c2w(flat_cam).double())
    p = points.double()
    cam = p @ proj[:3, :3].T + proj[:3, 3]
    z = cam[:, 2]
    front = z > 0
    x = cam[:, 0] / torch.clamp(z, min=1e-8)
    y = cam[:, 1] / torch.clamp(z, min=1e-8)
    x0, y0 = torch.floor(x), torch.floor(y)
    c = math.ceil(r)
    idx, d2 = [], []
    for dy in range(-c, c + 2):
        for dx in range(-c, c + 2):
            xi, yi = x0 + dx, y0 + dy
            dd = (xi - x) ** 2 + (yi - y) ** 2
            cover = front & (dd <= r * r) & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx.append(torch.where(cover, yi * w + xi, torch.full_like(xi, h * w)).long())
            d2.append(dd)
    return torch.stack(idx, 1), torch.stack(d2, 1), z


def footprint_reach(points, which, flat_cam, hw, radius=0.01):
    """[H*W] bool: the pixels that the points ``which`` [N] cover."""
    h, w = hw
    idx, _d2, _z = _footprint(points[which], flat_cam, hw, radius_px(radius, hw))
    reach = torch.zeros(h * w + 1, dtype=torch.bool, device=points.device)
    reach[idx.reshape(-1)] = True
    return reach[:h * w]


@torch.no_grad()
def splat_points(points, colors, keep, flat_cam, hw, radius=0.01, depth_band=0.01, low=False):
    """rgb [H, W, 3] float32 and mask [H, W, 1] of the kept points
    (``keep`` [N] bool) splatted into the camera ``flat_cam`` [34]."""
    h, w = hw
    r = radius_px(radius, hw)
    idx, d2, z = _footprint(points[keep], flat_cam, hw, r)
    zt = z[:, None].expand_as(d2)
    zbuf = torch.full((h * w + 1,), float("inf"), dtype=torch.float64, device=points.device)
    zbuf.scatter_reduce_(0, idx.reshape(-1), zt.reshape(-1), reduce="amin")
    band = zt <= zbuf[idx] * (1.0 + depth_band)
    wgt = torch.where(band & (idx < h * w), 1.0 - d2 / (r * r), torch.zeros_like(d2))
    col = colors[keep].double()
    if low:
        wgt = wgt.to(torch.bfloat16).float()
        col = col.to(torch.bfloat16).float()
    acc = wgt.dtype
    num = torch.zeros((h * w + 1, col.shape[1]), dtype=acc, device=points.device)
    den = torch.zeros((h * w + 1,), dtype=acc, device=points.device)
    num.index_add_(0, idx.reshape(-1), (wgt[..., None] * col.to(acc)[:, None, :]).reshape(-1, 3))
    den.index_add_(0, idx.reshape(-1), wgt.reshape(-1))
    num, den = num[:h * w], den[:h * w]
    mask = den > 0
    rgb = torch.where(mask[:, None], num / torch.where(mask, den, 1.0)[:, None], 0.0)
    return rgb.float().reshape(h, w, 3), mask.float().reshape(h, w, 1)
