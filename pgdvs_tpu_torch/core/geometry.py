"""Pose / quaternion geometry.

Host-side (numpy) pose utilities the readers call, and torch unprojection:
the counterpart of ``pgdvs_tpu.core.geometry`` (quaternion slerp pose
interpolation, qvec <-> rotmat, pose recentering, source-view ranking),
the same arithmetic function by function.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdvs_tpu_torch.core.cameras import get_rays, inverse_intrinsics3


# ---------------------------------------------------------------------------
# quaternion <-> rotation matrix (host-side numpy; wxyz convention)
# ---------------------------------------------------------------------------


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """Unit quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat_to_qvec(rot: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion [w, x, y, z] with w >= 0, by
    the symmetric-eigenvector method (robust near 180-degree rotations)."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = rot.flat
    k = (
        np.array(
            [
                [rxx - ryy - rzz, 0, 0, 0],
                [ryx + rxy, ryy - rxx - rzz, 0, 0],
                [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
                [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(k)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def quat_slerp(q0: np.ndarray, q1: np.ndarray, t: float, shortest: bool = True) -> np.ndarray:
    """Spherical linear interpolation between unit quaternions ([w,x,y,z]).

    ``shortest=False`` does not sign-flip antipodal pairs (the reference's
    ``interpolate``), so it rotates the long way when the dot is negative.
    """
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if shortest and dot < 0.0:
        q1 = -q1
        dot = -dot
    if dot > 1.0 - 1e-9:  # nearly parallel: lerp + renormalize
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1.0 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


def linear_pose_interp(trans_a, rot_a, trans_b, rot_b, t: float):
    """Interpolate two rigid poses: lerp the translation, slerp the rotation
    (no shortest path, as the reference). Returns (rot 3x3, translation 3)."""
    q = quat_slerp(rotmat_to_qvec(rot_a), rotmat_to_qvec(rot_b), float(t), shortest=False)
    trans = np.asarray(trans_a) + float(t) * (np.asarray(trans_b) - np.asarray(trans_a))
    return qvec_to_rotmat(q), trans


def interpolate_c2w(c2w_a: np.ndarray, c2w_b: np.ndarray, t: float) -> np.ndarray:
    """Slerp+lerp interpolation of two 4x4 camera-to-world matrices."""
    rot, trans = linear_pose_interp(c2w_a[:3, 3], c2w_a[:3, :3], c2w_b[:3, 3], c2w_b[:3, :3], t)
    out = np.eye(4, dtype=c2w_a.dtype)
    out[:3, :3] = rot
    out[:3, 3] = trans
    return out


# ---------------------------------------------------------------------------
# pose set helpers (host-side)
# ---------------------------------------------------------------------------


def average_pose(poses: np.ndarray) -> np.ndarray:
    """LLFF-style average camera pose of an [N, 3/4, 4] pose stack."""
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return _view_matrix(vec2, up, center)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Recenter an [N, 4, 4] c2w stack so the average pose is the identity."""
    c2w = np.eye(4)
    c2w[:3, :4] = average_pose(poses)
    return np.linalg.inv(c2w) @ poses


def _normalize(x):
    return x / np.linalg.norm(x)


def _view_matrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def rotation_geodesic_dist(r_ref: np.ndarray, rs: np.ndarray) -> np.ndarray:
    """Angular distance between a rotation and a stack of rotations."""
    tr = np.trace(np.einsum("nji,jk->nik", rs, r_ref), axis1=1, axis2=2)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0 + 1e-6, 1.0 - 1e-6))


def sort_poses_wrt_ref(ref_c2w: np.ndarray, c2ws: np.ndarray, metric: str = "dist",
                       scene_center=(0.0, 0.0, 0.0), tgt_id: int = -1) -> np.ndarray:
    """Indices of ``c2ws`` sorted most-similar to ``ref_c2w`` first, by
    ``dist`` (camera-centre distance), ``vector`` (angle between the centres
    seen from scene_center), ``matrix`` / ``geodesic`` (rotation geodesic
    distance) or ``dist_matrix`` (the min-max-normalized sum of the two).
    ``tgt_id >= 0`` pushes that index to the end."""
    t_ref = ref_c2w[:3, 3]
    t = c2ws[:, :3, 3]
    if metric == "dist":
        d = np.linalg.norm(t - t_ref, axis=-1)
    elif metric == "vector":
        center = np.asarray(scene_center, np.float64)
        v_ref = t_ref - center
        v = t - center
        vu = v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-6)
        ru = v_ref / (np.linalg.norm(v_ref) + 1e-6)
        d = np.arccos(np.clip(vu @ ru, -1.0, 1.0))
    elif metric in ("matrix", "geodesic"):
        d = rotation_geodesic_dist(ref_c2w[:3, :3], c2ws[:, :3, :3])
    elif metric == "dist_matrix":
        d1 = rotation_geodesic_dist(ref_c2w[:3, :3], c2ws[:, :3, :3])
        d1 = (d1 - d1.min()) / (d1.max() - d1.min() + 1e-8)
        d2 = np.linalg.norm(t - t_ref, axis=-1)
        d2 = (d2 - d2.min()) / (d2.max() - d2.min() + 1e-8)
        d = d1 + d2
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if tgt_id >= 0:
        d = d.copy()
        d[tgt_id] = 1e8
    return np.argsort(d)


# ---------------------------------------------------------------------------
# unprojection (torch)
# ---------------------------------------------------------------------------


def unproject_depth(depth, intrinsics, c2w) -> torch.Tensor:
    """Lift an [H, W] z-depth map to world points [H, W, 3] in float32 on
    the inputs' device (numpy inputs: the CPU), through ``get_rays``
    (point = o + d * depth, d unnormalized)."""
    depth, intrinsics, c2w = (torch.as_tensor(x, dtype=torch.float32)
                              for x in (depth, intrinsics, c2w))
    h, w = depth.shape
    rays_o, rays_d, _, _ = get_rays(h, w, intrinsics, c2w)
    return (rays_o + rays_d * depth.reshape(-1, 1)).reshape(h, w, 3)


def uv_depth_to_world(uv: torch.Tensor, depth: torch.Tensor,
                      intrinsics: torch.Tensor, c2w: torch.Tensor):
    """Lift pixel (x, y) [..., 2] with z-depth [...] to world points [..., 3]."""
    pix = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    mat = c2w[:3, :3] @ inverse_intrinsics3(intrinsics[:3, :3])
    return c2w[:3, 3] + (pix @ mat.T) * depth[..., None]
