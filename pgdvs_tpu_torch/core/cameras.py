"""Camera contract and projection math (torch).

Cameras travel as a flat 34-vector ``[h, w, K.ravel()(16), c2w.ravel()(16)]``,
the same wire format as ``pgdvs_tpu.core.cameras``. Every function is plain
float32 tensor math, batched over leading dims, on whatever device its
inputs live on.
"""

from __future__ import annotations

import torch


def make_flat_cam(h, w, intrinsics, c2w) -> torch.Tensor:
    """Pack image size + 4x4 intrinsics + 4x4 cam-to-world into a 34-vector."""
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32).reshape(-1, 16)
    c2w = torch.as_tensor(c2w, dtype=torch.float32).reshape(-1, 16)
    hw = torch.tensor([h, w], dtype=torch.float32).expand(intrinsics.shape[0], 2)
    flat = torch.cat([hw, intrinsics, c2w], dim=-1)
    return flat[0] if flat.shape[0] == 1 else flat


def flat_cam_intrinsics(flat_cam: torch.Tensor) -> torch.Tensor:
    """[..., 34] -> [..., 4, 4] intrinsics."""
    return flat_cam[..., 2:18].reshape(flat_cam.shape[:-1] + (4, 4))


def flat_cam_c2w(flat_cam: torch.Tensor) -> torch.Tensor:
    """[..., 34] -> [..., 4, 4] camera-to-world."""
    return flat_cam[..., 18:34].reshape(flat_cam.shape[:-1] + (4, 4))


def inverse_se3(mat4: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 (rotation + translation)."""
    rot_t = mat4[..., :3, :3].transpose(-1, -2)
    t_new = -(rot_t @ mat4[..., :3, 3:4])
    out = torch.zeros_like(mat4)
    out[..., :3, :3] = rot_t
    out[..., :3, 3:4] = t_new
    out[..., 3, 3] = 1.0
    return out


def inverse_intrinsics3(k3: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [[fx, s, cx], [0, fy, cy], [0, 0, 1]]."""
    fx, s, cx = k3[..., 0, 0], k3[..., 0, 1], k3[..., 0, 2]
    fy, cy = k3[..., 1, 1], k3[..., 1, 2]
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    rows = [
        torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1),
        torch.stack([zero, 1.0 / fy, -cy / fy], -1),
        torch.stack([zero, zero, one], -1),
    ]
    return torch.stack(rows, dim=-2)


def flat_cam_projection(flat_cam: torch.Tensor) -> torch.Tensor:
    """K @ w2c [..., 4, 4] — the combined world->pixel matrix."""
    return flat_cam_intrinsics(flat_cam) @ inverse_se3(flat_cam_c2w(flat_cam))


def project_with(proj: torch.Tensor, xyz: torch.Tensor, eps: float = 1e-8,
                 clip: float = 1e6):
    """Project [..., 3] points with [..., 4, 4] (or [..., 3, 4]) K @ w2c
    matrices (leading dims broadcast against the points').

    Returns uv [..., 2] (clipped to +-clip), z [...], in_front [...] bool.
    """
    p = proj[..., :3, :]
    cam = torch.einsum("...ij,...j->...i", p[..., :3], xyz) + p[..., 3]
    z = cam[..., 2]
    uv = cam[..., :2] / torch.clamp(z[..., None], min=eps)
    return uv.clamp(-clip, clip), z, z > 0


def project_points(xyz: torch.Tensor, flat_cam: torch.Tensor, eps: float = 1e-8,
                   clip: float = 1e6):
    """Project world points into a flat-34 camera: uv, z, in_front."""
    return project_with(flat_cam_projection(flat_cam), xyz, eps, clip)


def pixel_inbound(uv: torch.Tensor, h: float, w: float) -> torch.Tensor:
    """True where uv = (x, y) lies inside [0, w-1] x [0, h-1]."""
    return (
        (uv[..., 0] >= 0)
        & (uv[..., 0] <= w - 1.0)
        & (uv[..., 1] >= 0)
        & (uv[..., 1] <= h - 1.0)
    )


def get_rays(h: int, w: int, intrinsics: torch.Tensor, c2w: torch.Tensor,
             stride: int = 1):
    """Per-pixel rays at integer pixel centres (no +0.5 offset), on the
    pixels ``[::stride, ::stride]`` of the h x w image.

    Returns rays_o [n, 3], rays_d [n, 3] (unnormalized, z-depth
    parameterized), uv [n, 2] pixel (x, y), and (rh, rw), n = rh * rw.
    """
    dev = c2w.device
    ys = torch.arange(0, h, stride, dtype=torch.float32, device=dev)
    xs = torch.arange(0, w, stride, dtype=torch.float32, device=dev)
    rh, rw = ys.shape[0], xs.shape[0]
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    u, v = grid_x.reshape(-1), grid_y.reshape(-1)
    pix = torch.stack([u, v, torch.ones_like(u)], dim=0)  # [3, n]
    cam2pix = c2w[:3, :3] @ inverse_intrinsics3(intrinsics[:3, :3])
    rays_d = (cam2pix @ pix).T.contiguous()
    rays_o = c2w[:3, 3].expand(rays_d.shape).contiguous()
    return rays_o, rays_d, torch.stack([u, v], dim=-1), (rh, rw)


def ray_diff_features(xyz: torch.Tensor, tgt_center: torch.Tensor,
                      src_center: torch.Tensor, eps: float = 1e-6):
    """Per-(point, source-view) ray-difference code [..., 4].

    Unit direction of (dir_to_target_cam - dir_to_source_cam) plus their
    dot product. Centers are camera positions ([3], or broadcastable
    [..., 3]).
    """
    to_tgt = tgt_center - xyz
    to_src = src_center - xyz
    to_tgt = to_tgt / (torch.linalg.norm(to_tgt, dim=-1, keepdim=True) + eps)
    to_src = to_src / (torch.linalg.norm(to_src, dim=-1, keepdim=True) + eps)
    diff = to_tgt - to_src
    diff_norm = torch.linalg.norm(diff, dim=-1, keepdim=True)
    dot = torch.sum(to_tgt * to_src, dim=-1, keepdim=True)
    return torch.cat([diff / torch.clamp(diff_norm, min=eps), dot], dim=-1)
