"""Pixel + depth -> world lifting (torch)."""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.core.cameras import inverse_intrinsics3


def uv_depth_to_world(uv: torch.Tensor, depth: torch.Tensor,
                      intrinsics: torch.Tensor, c2w: torch.Tensor):
    """Lift pixel (x, y) [..., 2] with z-depth [...] to world points [..., 3]."""
    pix = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    mat = c2w[:3, :3] @ inverse_intrinsics3(intrinsics[:3, :3])
    return c2w[:3, 3] + (pix @ mat.T) * depth[..., None]
