"""Deterministic along-ray sample placement (torch).

Counterpart of ``pgdvs_tpu.core.sampling.sample_z_vals`` /
``sample_along_rays`` for the deterministic path. Stratified jitter and PDF
importance sampling (fine samples) are outside the ported slice.
"""

from __future__ import annotations

import torch


def sample_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                  inv_uniform: bool) -> torch.Tensor:
    """[n_rays] near/far -> [n_rays, n_samples] increasing z values.

    With inv_uniform the samples are uniform in 1/z (disparity).
    """
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                       device=near.device)
    if inv_uniform:
        start, end = 1.0 / near, 1.0 / far
        return 1.0 / (start[:, None] + (end - start)[:, None] * t[None, :])
    return near[:, None] + (far - near)[:, None] * t[None, :]


def sample_along_rays(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      depth_range: torch.Tensor, n_samples: int,
                      inv_uniform: bool = False):
    """Place points along rays: pts [n, S, 3], z_vals [n, S]."""
    z_vals = sample_z_vals(depth_range[:, 0], depth_range[:, 1], n_samples,
                           inv_uniform)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return pts, z_vals
