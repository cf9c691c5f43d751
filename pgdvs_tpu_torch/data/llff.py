"""LLFF pose files (poses_bounds.npy / poses_bounds_cvd.npy).

The counterpart of ``pgdvs_tpu.data.llff``: the stored [3, 5] blocks are
[down, right, back | hwf]; columns are rotated to [right, up, back] and then
flipped to OpenCV's [right, down, forward].
"""

from __future__ import annotations

import numpy as np


def load_poses_bounds(path):
    """Parse a poses_bounds(_cvd).npy file into (all_hwf [N, 3] of (h, w,
    focal), all_c2w [N, 4, 4] OpenCV camera-to-world float32, bounds [N, 2])."""
    poses_arr = np.load(str(path), allow_pickle=False)  # [N, 17]
    n = poses_arr.shape[0]
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])  # [3, 5, N]
    bounds = poses_arr[:, -2:]
    # [down, right, back] -> [right, up, back]
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)  # [N, 3, 5]
    all_hwf = poses[:, :, 4].copy()
    homo = np.zeros((n, 1, 4), np.float32)
    homo[..., 3] = 1
    all_c2w = np.concatenate((poses[:, :, :4], homo), axis=1)
    # [right, up, back] (LLFF) -> [right, down, forward] (OpenCV)
    all_c2w[..., 1:3] *= -1
    return all_hwf, all_c2w, bounds


def hwf_to_intrinsics4(hwf, tgt_shape=None):
    """(h, w, f) -> 4x4 K, optionally rescaled to a target (h, w)."""
    h, w, f = float(hwf[0]), float(hwf[1]), float(hwf[2])
    k = np.eye(4)
    k[0, 0] = f
    k[1, 1] = f
    k[0, 2] = w / 2.0
    k[1, 2] = h / 2.0
    if tgt_shape is not None:
        th, tw = tgt_shape
        k[0, :] *= tw / w
        k[1, :] *= th / h
    return k
