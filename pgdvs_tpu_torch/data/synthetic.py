"""Analytic synthetic dynamic scene — ground truth for tests and benches.

A numpy copy of ``pgdvs_tpu.data.synthetic`` (whose camera packing imports
jax): the same seed-free analytic scene and the same arrays, key by key.

The reference has no test assets; this module replaces them. A procedurally
textured static background plane plus a moving dynamic square are ray-cast
*analytically* (no renderer in the loop), so every contract input — rgb,
depth, flow, dynamic masks, poses — and every target view is exact. End-to-
end renders can therefore be scored against analytic ground truth.

Scene (world units): background plane at z = Z_BG with smooth texture
``bg_color(x, y)``; a dynamic square (side SQ_SIZE) on the plane z = Z_DYN
whose center moves linearly with time; cameras translate on a small arc
looking down +z.
"""

from __future__ import annotations

import numpy as np


Z_BG = 6.0
Z_DYN = 3.0
SQ_SIZE = 1.2


def make_flat_cam(h, w, intrinsics, c2w) -> np.ndarray:
    """[h, w, K.ravel(), c2w.ravel()] as a float32 34-vector."""
    return np.concatenate(
        [
            np.asarray([h, w], np.float32),
            np.asarray(intrinsics, np.float32).reshape(16),
            np.asarray(c2w, np.float32).reshape(16),
        ]
    )


def bg_color(x, y):
    """Smooth RGB texture on the background plane."""
    r = 0.5 + 0.45 * np.sin(1.3 * x + 0.7 * y)
    g = 0.5 + 0.45 * np.cos(0.9 * x - 1.1 * y)
    b = 0.5 + 0.45 * np.sin(0.5 * x * y)
    return np.stack([r, g, b], axis=-1)


def dyn_color(u, v):
    """Texture on the dynamic square (local coords in [0, 1])."""
    r = 0.2 + 0.8 * u
    g = 0.9 - 0.7 * v
    b = 0.5 + 0.5 * np.sin(6.0 * (u + v))
    return np.stack([r, g, b], axis=-1)


def square_center(t: float) -> np.ndarray:
    """Dynamic square center at time t (moves along x, slight y drift)."""
    return np.array([-1.0 + 2.0 * t, 0.3 * np.sin(2.0 * np.pi * t), Z_DYN])


def camera_pose(i: int, n: int) -> np.ndarray:
    """Translation-only c2w for frame i of n (looking +z)."""
    c2w = np.eye(4)
    s = i / max(n - 1, 1)
    c2w[:3, 3] = [0.6 * np.sin(2 * np.pi * s) * 0.3, 0.15 * np.cos(2 * np.pi * s) * 0.3, 0.0]
    return c2w


def intrinsics(h: int, w: int) -> np.ndarray:
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.8 * max(h, w)
    k[0, 2] = w / 2.0
    k[1, 2] = h / 2.0
    return k


def render_frame(h: int, w: int, c2w: np.ndarray, t: float):
    """Analytically ray-cast one frame.

    Returns dict: rgb [H,W,3], depth [H,W,1] (z-depth), dyn_mask [H,W,1],
    plus the per-pixel world hit points [H,W,3] (for flow computation).
    """
    k = intrinsics(h, w)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    # translation-only cameras: ray dir = K^-1 [u, v, 1]
    dx = (gx - k[0, 2]) / k[0, 0]
    dy = (gy - k[1, 2]) / k[1, 1]
    cam_o = c2w[:3, 3]

    # intersection with dynamic plane
    t_dyn = Z_DYN - cam_o[2]
    pd = np.stack(
        [cam_o[0] + dx * t_dyn, cam_o[1] + dy * t_dyn, np.full_like(dx, Z_DYN)], -1
    )
    c = square_center(t)
    local = (pd[..., :2] - (c[:2] - SQ_SIZE / 2)) / SQ_SIZE
    hit_dyn = np.all((local >= 0) & (local <= 1), axis=-1)

    # background
    t_bg = Z_BG - cam_o[2]
    pb = np.stack(
        [cam_o[0] + dx * t_bg, cam_o[1] + dy * t_bg, np.full_like(dx, Z_BG)], -1
    )

    rgb = np.where(
        hit_dyn[..., None], dyn_color(local[..., 0], local[..., 1]), bg_color(pb[..., 0], pb[..., 1])
    ).astype(np.float32)
    depth = np.where(hit_dyn, t_dyn, t_bg).astype(np.float32)[..., None]
    pts = np.where(hit_dyn[..., None], pd, pb).astype(np.float32)
    return {
        "rgb": np.clip(rgb, 0.0, 1.0),
        "depth": depth,
        "dyn_mask": hit_dyn.astype(np.float32)[..., None],
        "points": pts,
        "local": local,
        "hit_dyn": hit_dyn,
    }


def _project(pts, k, c2w):
    rel = pts - c2w[:3, 3]
    u = k[0, 0] * rel[..., 0] / rel[..., 2] + k[0, 2]
    v = k[1, 1] * rel[..., 1] / rel[..., 2] + k[1, 2]
    return np.stack([u, v], -1)


def flow_between(h, w, frame_a, c2w_a, t_a, c2w_b, t_b):
    """Exact forward flow a->b from 3D correspondences.

    Dynamic pixels follow the square's motion; static pixels follow the
    camera-induced parallax of their background point.
    """
    k = intrinsics(h, w)
    pts = frame_a["points"].copy()
    motion = square_center(t_b) - square_center(t_a)
    pts_b = np.where(frame_a["hit_dyn"][..., None], pts + motion, pts)
    uv_b = _project(pts_b, k, c2w_b)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv_a = np.stack([gx, gy], -1).astype(np.float64)
    return (uv_b - uv_a).astype(np.float32)


def make_contract_data(
    h: int = 64,
    w: int = 80,
    n_spatial: int = 4,
    n_frames: int = 8,
    tgt_time: float = 0.5,
    seed: int = 0,
    k_track: int = 0,
):
    """Assemble a full renderer-contract dict for one novel view.

    The target camera is a held-out pose at fractional time ``tgt_time``;
    temporal sources are the two nearest integer frames; spatial sources are
    the n nearest cameras. ``k_track > 0`` additionally emits the ±K
    track-source keys the track branch consumes (rgb/dyn_mask/depth/
    flat_cam/time/n_actual _src_track_{fwd,bwd}).
    """
    k = intrinsics(h, w)
    times = np.linspace(0.0, 1.0, n_frames)
    poses = [camera_pose(i, n_frames) for i in range(n_frames)]
    frames = [render_frame(h, w, poses[i], times[i]) for i in range(n_frames)]

    # temporal neighbors around tgt_time
    i1 = int(np.clip(np.searchsorted(times, tgt_time) - 1, 0, n_frames - 2))
    i2 = i1 + 1

    tgt_c2w = np.eye(4)
    tgt_c2w[:3, 3] = 0.5 * (poses[i1][:3, 3] + poses[i2][:3, 3]) + np.array(
        [0.02, -0.01, 0.0]
    )
    tgt = render_frame(h, w, tgt_c2w, tgt_time)

    # spatial sources: nearest cameras by distance
    dists = [np.linalg.norm(p[:3, 3] - tgt_c2w[:3, 3]) for p in poses]
    sp_idx = np.argsort(dists)[:n_spatial]

    def flat(c2w):
        return np.asarray(make_flat_cam(h, w, k, c2w), np.float32)

    flow_fwd = flow_between(h, w, frames[i1], poses[i1], times[i1], poses[i2], times[i2])
    flow_bwd = flow_between(h, w, frames[i2], poses[i2], times[i2], poses[i1], times[i1])

    def sgather(key_fn):
        return np.stack([key_fn(frames[j]) for j in sp_idx])

    static_rgb_sp = np.stack(
        [
            frames[j]["rgb"] * (1 - frames[j]["dyn_mask"])
            for j in sp_idx
        ]
    )
    data = {
        "seq_ids": np.zeros((13,), np.float32),
        "rgb_tgt": tgt["rgb"],
        "rgb_src_spatial": sgather(lambda f: f["rgb"]),
        "dyn_rgb_src_spatial": sgather(lambda f: f["rgb"] * f["dyn_mask"]),
        "static_rgb_src_spatial": static_rgb_sp,
        "rgb_src_temporal": np.stack([frames[i1]["rgb"], frames[i2]["rgb"]]),
        "dyn_rgb_src_temporal": np.stack(
            [frames[j]["rgb"] * frames[j]["dyn_mask"] for j in (i1, i2)]
        ),
        "static_rgb_src_temporal": np.stack(
            [frames[j]["rgb"] * (1 - frames[j]["dyn_mask"]) for j in (i1, i2)]
        ),
        "dyn_mask_src_spatial": sgather(lambda f: f["dyn_mask"]),
        "dyn_mask_src_temporal": np.stack(
            [frames[i1]["dyn_mask"], frames[i2]["dyn_mask"]]
        ),
        "flow_fwd": flow_fwd,
        "flow_fwd_occ_mask": np.zeros((h, w, 1), np.float32),
        "flow_bwd": flow_bwd,
        "flow_bwd_occ_mask": np.zeros((h, w, 1), np.float32),
        "flat_cam_tgt": flat(tgt_c2w),
        "flat_cam_src_spatial": np.stack([flat(poses[j]) for j in sp_idx]),
        "flat_cam_src_temporal": np.stack([flat(poses[i1]), flat(poses[i2])]),
        "depth_src_temporal": np.stack(
            [frames[i1]["depth"], frames[i2]["depth"]]
        ),
        "depth_range": np.array([Z_DYN * 0.5, Z_BG * 1.3], np.float32),
        "time_tgt": np.array([tgt_time], np.float32),
        "time_src_temporal": np.array([times[i1], times[i2]], np.float32),
        "eval_mask": np.ones((h, w, 3), np.float32),
        "misc": {"tgt_dyn_mask": tgt["dyn_mask"]},
    }

    # aggregated static point cloud (pure-geometry mode): static pixels of
    # every other frame, subsampled
    pcl, rgbs = [], []
    for j in range(0, n_frames, 2):
        f = frames[j]
        st = f["dyn_mask"][..., 0] == 0
        pcl.append(f["points"][st][::3])
        rgbs.append(f["rgb"][st][::3])
    st_pcl = np.concatenate([np.concatenate(pcl), np.concatenate(rgbs)], axis=1)
    data["st_pcl_rgb"] = st_pcl.astype(np.float32)
    data["st_pcl_valid"] = np.ones((st_pcl.shape[0],), bool)

    if k_track > 0:
        # ±K tracking windows around the temporal pair, padded with copies
        # of the nearest real frame when the sequence runs out (the
        # reference pads with the temporal frames themselves —
        # pgdvs_renderer_dyn_track.py:599-764; n_actual marks real slots)
        fwd_ids = [max(j, 0) for j in range(i1 - k_track, i1)]
        bwd_ids = [min(j, n_frames - 1) for j in range(i2 + 1, i2 + 1 + k_track)]
        n_fwd = sum(1 for j in range(i1 - k_track, i1) if j >= 0)
        n_bwd = sum(1 for j in range(i2 + 1, i2 + 1 + k_track) if j < n_frames)
        for name, ids, n_act in (("fwd", fwd_ids, n_fwd), ("bwd", bwd_ids, n_bwd)):
            data[f"rgb_src_track_{name}"] = np.stack(
                [frames[j]["rgb"] for j in ids]
            )
            data[f"dyn_mask_src_track_{name}"] = np.stack(
                [frames[j]["dyn_mask"] for j in ids]
            )
            data[f"depth_src_track_{name}"] = np.stack(
                [frames[j]["depth"] for j in ids]
            )
            data[f"flat_cam_src_track_{name}"] = np.stack(
                [flat(poses[j]) for j in ids]
            )
            data[f"time_src_track_{name}"] = np.asarray(
                [times[j] for j in ids], np.float32
            )
            data[f"n_actual_src_track_{name}"] = np.array([n_act], np.int64)
    return data
