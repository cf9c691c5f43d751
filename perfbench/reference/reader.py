"""Plain reference of one NVIDIA evaluation item, from what the benchmark wrote.

For a target in the monocular video (frame f, camera f % 12): temporal
sources f - 1 and f + 1 (the one that exists, twice, at either end); spatial
sources the nearest cameras (by centre distance) among the frames within 12
of f, f itself left out; images at half the raw size: rgb as the mean of
each 2x2 block of the written uint8 frame, rounded half up; depth
1 / (disparity + 1e-8) and the evaluation masks at the even (OpenCV
nearest) / odd (PIL nearest) raw pixel; flows as written; cameras
[h, w, K at the evaluation size, c2w]; depth range [0.8 min z, 1.2 q90 z]
of the spatial sources' points in the target camera.
"""

from __future__ import annotations

import numpy as np

N_CAMS = 12


def temporal_ids(f, n):
    ids = [t for t in (f - 1, f + 1) if 0 <= t < n]
    return ids * 2 if len(ids) == 1 else ids


def spatial_distances(f, n, c2w_of, n_spatial):
    """The ``n_spatial`` smallest camera-centre distances to frame f's camera
    over its pool, ascending."""
    pool = [g for g in range(max(0, f - N_CAMS), min(n, f + N_CAMS)) if g != f]
    d = sorted(float(np.linalg.norm(c2w_of(g)[:3, 3] - c2w_of(f)[:3, 3])) for g in pool)
    return np.asarray(d[:n_spatial])


def half_rgb(src_u8):
    s = src_u8.astype(np.float64)
    h, w = s.shape[0] // 2, s.shape[1] // 2
    mean = s[:2 * h, :2 * w].reshape(h, 2, w, 2, 3).mean(axis=(1, 3))
    return (np.floor(mean + 0.5) / 255.0).astype(np.float32)


def half_depth(depth_raw):
    disp = (1.0 / depth_raw).astype(np.float32)
    return (1.0 / (disp[::2, ::2].astype(np.float64) + 1e-8)).astype(np.float32)


def half_mask(mask_raw):
    """A source's dynamic mask: the odd raw pixels (PIL nearest)."""
    return (mask_raw[1::2, 1::2] > 0).astype(np.float32)


def half_eval_mask(mask_raw):
    """The target's evaluation mask: the even raw pixels (OpenCV nearest)."""
    return (mask_raw[::2, ::2] > 0).astype(np.float32)


def flat_cam(eval_hw, raw_hw, c2w):
    (eh, ew), (rh, rw) = eval_hw, raw_hw
    f = 0.8 * max(rh, rw)
    k = np.eye(4)
    k[0, 0], k[0, 2] = f * ew / rw, rw / 2.0 * ew / rw
    k[1, 1], k[1, 2] = f * eh / rh, rh / 2.0 * eh / rh
    return np.concatenate([[eh, ew], k.ravel(), np.asarray(c2w).ravel()]).astype(np.float32)


def depth_range(depths, cams, tgt_c2w):
    pts = []
    for d, cam in zip(depths, cams):
        h, w = d.shape[:2]
        k = cam[2:18].reshape(4, 4).astype(np.float64)
        c2w = cam[18:34].reshape(4, 4).astype(np.float64)
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pix = np.stack([gx, gy, np.ones_like(gx)], -1).reshape(-1, 3).astype(np.float64)
        dirs = pix @ (c2w[:3, :3] @ np.linalg.inv(k[:3, :3])).T
        pts.append(c2w[:3, 3] + dirs * d.reshape(-1, 1).astype(np.float64))
    pts = np.concatenate(pts)
    z = (np.linalg.inv(tgt_c2w) @ np.concatenate([pts, np.ones_like(pts[:, :1])], 1).T)[2]
    return np.array([max(1e-16, 0.8 * z.min()), max(2e-16, 1.2 * np.quantile(z, 0.9))])
