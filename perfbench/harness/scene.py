"""The benchmark's synthetic dynamic scene, drawn from the seed.

A copy of the analytic scene of ``pgdvs_tpu_torch/data/synthetic.py`` (a
textured background plane, a textured square moving in front of it,
translation-only cameras on a small arc), every texture, the square's path,
the arc and the target views drawn from the seed. The moving rectangle's
size in world units is the traffic's ``dyn_size`` (at depth 3, 1.2 x 1.2
covers ~176 x 176 pixels, 19.6 % of a 288x550 frame); its path is scaled to
the room that size leaves, so that it stays inside every frame. Every seed
gives the same amount of dynamic content and the same work per view; only
its place and look move.

Everything is numpy on the host (``render_frame``), then stacked on the
device once (``Scene``).
"""

from __future__ import annotations

import numpy as np
import torch

Z_BG, Z_DYN = 6.0, 3.0
# the frame's half-width at depth Z_DYN (a landscape frame: the focal length
# is 0.8 times its width) and the arc's largest offsets
HALF_X, ARC_X, ARC_Y = 1.875, 0.18, 0.055
# the room, each side of the path's centre, that the paths' draws were made
# for: a 1.2 x 1.2 square in a 288x550 frame
ROOM_X, ROOM_Y = HALF_X - 0.6 - ARC_X, HALF_X * 288 / 550 - 0.6 - ARC_Y


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per (seed, stream); any integer seed."""
    return np.random.default_rng([seed % (1 << 63), stream])


class SceneParams:
    """The seeded constants of one scene."""

    def __init__(self, seed: int, n_frames: int, hw=(288, 550), dyn_size=(1.2, 1.2)):
        r = rng_for(seed, 1)
        self.n_frames = n_frames
        self.dyn_size = np.asarray(dyn_size, np.float64)
        room_x = HALF_X - self.dyn_size[0] / 2 - ARC_X
        room_y = HALF_X * min(hw) / max(hw) - self.dyn_size[1] / 2 - ARC_Y
        if room_x <= 0 or room_y <= 0:
            raise ValueError(f"a {dyn_size} rectangle does not fit a {hw} frame")
        sx, sy = room_x / ROOM_X, room_y / ROOM_Y
        self.bg_freq = r.uniform(0.8, 1.2, 5) * np.array([1.3, 0.7, 0.9, 1.1, 0.5])
        self.bg_phase = r.uniform(0, 2 * np.pi, 3)
        self.dyn_phase = r.uniform(0, 2 * np.pi)
        direction = 1.0 if r.uniform() < 0.5 else -1.0
        # the rectangle stays inside every frame: at depth 3 a 288x550 frame
        # spans +-1.875 by +-0.982 around its camera, which the arc moves by
        # at most 0.18 by 0.055; the path's offsets are drawn for a 1.2 x 1.2
        # square there and scaled to the room the rectangle leaves
        self.sq_x = (sx * r.uniform(-0.05, 0.05), sx * direction * r.uniform(0.75, 0.9))
        self.sq_y = (sy * r.uniform(-0.03, 0.03), sy * r.uniform(0.1, 0.2),
                     r.uniform(0, 2 * np.pi))
        self.arc = (r.uniform(0.12, 0.18), r.uniform(0.035, 0.055), r.uniform(0, 2 * np.pi))

    def bg_color(self, x, y):
        f, p = self.bg_freq, self.bg_phase
        return np.stack([0.5 + 0.45 * np.sin(f[0] * x + f[1] * y + p[0]),
                         0.5 + 0.45 * np.cos(f[2] * x - f[3] * y + p[1]),
                         0.5 + 0.45 * np.sin(f[4] * x * y + p[2])], axis=-1)

    def dyn_color(self, u, v):
        return np.stack([0.2 + 0.8 * u, 0.9 - 0.7 * v,
                         0.5 + 0.5 * np.sin(6.0 * (u + v) + self.dyn_phase)], axis=-1)

    def square_center(self, t):
        x0, vx = self.sq_x
        y0, ay, py = self.sq_y
        return np.array([x0 + vx * (2.0 * t - 1.0), y0 + ay * np.sin(2 * np.pi * t + py), Z_DYN])

    def camera_pose(self, s):
        """Translation-only c2w at arc parameter s in [0, 1]."""
        rx, ry, ph = self.arc
        c2w = np.eye(4)
        c2w[:3, 3] = [rx * np.sin(2 * np.pi * s + ph), ry * np.cos(2 * np.pi * s + ph), 0.0]
        return c2w


def intrinsics(h, w):
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.8 * max(h, w)
    k[0, 2], k[1, 2] = w / 2.0, h / 2.0
    return k


def render_frame(p: SceneParams, h, w, c2w, t):
    """Ray-cast one frame analytically: rgb [H, W, 3], z-depth [H, W, 1],
    dynamic mask [H, W, 1], world hit points [H, W, 3], the square hit."""
    k = intrinsics(h, w)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dx, dy = (gx - k[0, 2]) / k[0, 0], (gy - k[1, 2]) / k[1, 1]
    o = c2w[:3, 3]
    t_dyn = Z_DYN - o[2]
    pd = np.stack([o[0] + dx * t_dyn, o[1] + dy * t_dyn, np.full_like(dx, Z_DYN)], -1)
    c = p.square_center(t)
    local = (pd[..., :2] - (c[:2] - p.dyn_size / 2)) / p.dyn_size
    hit = np.all((local >= 0) & (local <= 1), axis=-1)
    t_bg = Z_BG - o[2]
    pb = np.stack([o[0] + dx * t_bg, o[1] + dy * t_bg, np.full_like(dx, Z_BG)], -1)
    rgb = np.where(hit[..., None], p.dyn_color(local[..., 0], local[..., 1]),
                   p.bg_color(pb[..., 0], pb[..., 1]))
    return {
        "rgb": np.clip(rgb, 0.0, 1.0).astype(np.float32),
        "depth": np.where(hit, t_dyn, t_bg).astype(np.float32)[..., None],
        "dyn_mask": hit.astype(np.float32)[..., None],
        "points": np.where(hit[..., None], pd, pb).astype(np.float32),
        "hit": hit,
    }


def flow_between(p: SceneParams, h, w, frame_a, t_a, c2w_b, t_b):
    """Exact forward flow [H, W, 2] from frame a (at t_a) to a camera c2w_b
    at t_b: the square's pixels follow its motion, the rest the parallax."""
    k = intrinsics(h, w)
    motion = p.square_center(t_b) - p.square_center(t_a)
    pts = np.where(frame_a["hit"][..., None], frame_a["points"] + motion, frame_a["points"])
    rel = pts - c2w_b[:3, 3]
    uv_b = np.stack([k[0, 0] * rel[..., 0] / rel[..., 2] + k[0, 2],
                     k[1, 1] * rel[..., 1] / rel[..., 2] + k[1, 2]], -1)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (uv_b - np.stack([gx, gy], -1)).astype(np.float32)


def flat_cam(h, w, c2w):
    return np.concatenate([[h, w], intrinsics(h, w).ravel(), np.asarray(c2w).ravel()]
                          ).astype(np.float32)


class Scene:
    """One seeded scene of ``n_frames`` frames at ``hw`` and ``n_targets``
    novel views, each a renderer contract on ``device``: a held-out pose near
    its temporal pair at a fractional time (never on a frame), its
    ``n_spatial`` nearest frames as spatial sources, the pair's forward
    flow, and its softsplat noise, a standard normal drawn on the device."""

    def __init__(self, seed, hw, n_frames, n_targets, n_spatial, device, dyn_size=(1.2, 1.2)):
        h, w = hw
        p = SceneParams(seed, n_frames, hw, dyn_size)
        times = np.linspace(0.0, 1.0, n_frames)
        poses = [p.camera_pose(i / max(n_frames - 1, 1)) for i in range(n_frames)]
        frames = [render_frame(p, h, w, poses[i], times[i]) for i in range(n_frames)]
        r = rng_for(seed, 2)
        # the pairs (i1, i1 + 1) in a seeded order, cycled: every seed gets
        # the same number of targets, at fractions of the gap in [0.2, 0.8]
        pairs = r.permutation(n_frames - 1)
        pair_ids = [int(pairs[i % (n_frames - 1)]) for i in range(n_targets)]
        fracs = r.uniform(0.2, 0.8, n_targets)
        offsets = r.uniform(0.01, 0.03, (n_targets, 2)) * r.choice([-1.0, 1.0], (n_targets, 2))
        dev = torch.device(device)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        rgb = to_dev(np.stack([f["rgb"] for f in frames]))
        mask = to_dev(np.stack([f["dyn_mask"] for f in frames]))
        depth = to_dev(np.stack([f["depth"] for f in frames]))
        cams = to_dev(np.stack([flat_cam(h, w, c) for c in poses]))
        flows = {}
        self.targets, self.frame_ids = [], []
        gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
        for i in range(n_targets):
            i1 = pair_ids[i]
            i2 = i1 + 1
            t_tgt = times[i1] + fracs[i] * (times[i2] - times[i1])
            c2w = np.eye(4)
            c2w[:3, 3] = 0.5 * (poses[i1][:3, 3] + poses[i2][:3, 3])
            c2w[:2, 3] += offsets[i]
            dists = [np.linalg.norm(q[:3, 3] - c2w[:3, 3]) for q in poses]
            sp = torch.as_tensor(np.sort(np.argsort(dists, kind="stable")[:n_spatial]),
                                 device=dev)
            if i1 not in flows:
                flows[i1] = to_dev(flow_between(p, h, w, frames[i1], times[i1], poses[i2],
                                                times[i2]))
            tp = torch.tensor([i1, i2], device=dev)
            self.frame_ids.append(sp.tolist())
            self.targets.append({
                "rgb_src_spatial": rgb[sp],
                "dyn_mask_src_spatial": mask[sp],
                "flat_cam_src_spatial": cams[sp],
                "flat_cam_tgt": to_dev(flat_cam(h, w, c2w)),
                "depth_range": torch.tensor([Z_DYN * 0.5, Z_BG * 1.3], device=dev),
                "rgb_src_temporal": rgb[tp],
                "dyn_mask_src_temporal": mask[tp],
                "depth_src_temporal": depth[tp],
                "flat_cam_src_temporal": cams[tp],
                "flow_fwd": flows[i1],
                "flow_fwd_occ_mask": torch.zeros((h, w, 1), device=dev),
                "time_tgt": torch.tensor([t_tgt], dtype=torch.float32, device=dev),
                "time_src_temporal": torch.tensor([times[i1], times[i2]], dtype=torch.float32,
                                                  device=dev),
                "noise": torch.randn((h, w, 3), generator=gen, device=dev),
            })

