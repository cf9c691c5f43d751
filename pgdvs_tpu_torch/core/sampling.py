"""Along-ray sample placement (torch).

Counterpart of ``pgdvs_tpu.core.sampling``: deterministic coarse z values
(``sample_z_vals`` / ``sample_along_rays``) and inverse-CDF importance
sampling for the fine pass (``sample_pdf`` / ``sample_fine_z_vals``).
Stratified jitter of the coarse samples is outside the ported slice; the
fine samples' random path takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def linspace(stop: float, num: int, device=None) -> torch.Tensor:
    """``num`` float32 values from 0 to ``stop`` inclusive, as XLA evaluates
    ``jnp.linspace(0, stop, num)``: i * (stop * (1 / (num - 1))), each
    factor rounded to float32, then ``stop`` exactly (``torch.linspace``
    steps from both ends and differs from it by an ulp here and there).
    Made on ``device`` with no host-to-device copy."""
    if num < 2:
        return torch.zeros((num,), dtype=torch.float32, device=device)
    step = float(np.float32(stop) * np.float32(1.0 / (num - 1)))
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    return torch.cat([i * step, torch.full((1,), stop, dtype=torch.float32, device=device)])


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, one float32 add at a time from the
    left: what XLA's CPU ``jnp.cumsum`` gives (and its ``jnp.sum`` over a
    short row, the last entry); torch's CPU cumsum accumulates in float64
    and CUDA's scans in another order. One small op per entry: for the fine
    pass's bins (S - 2 of them)."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, dim=-1)


def sample_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                  inv_uniform: bool) -> torch.Tensor:
    """[n_rays] near/far -> [n_rays, n_samples] increasing z values.

    With inv_uniform the samples are uniform in 1/z (disparity).
    """
    t = linspace(1.0, n_samples, device=near.device)
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


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` positions from per-bin weights.

    The reference's CDF inversion, vectorized as the JAX package does it:
    weights get +1e-5, the PDF's sum and the CDF are running float32 sums
    (``running_sum``); ``above`` counts the CDF starts <= u over
    ``cdf[:, :M]`` (``searchsorted(..., right=True)``), ``below =
    max(above - 1, 0)``; a CDF span under 1e-5 is replaced by 1.

    Args: bins [n_rays, M+1] bin edges; weights [n_rays, M] non-negative;
    deterministic: u = linspace(0, 1) (what the renderer uses), else u
    uniform from ``generator``.
    Returns [n_rays, n_samples].
    """
    n_rays, m = weights.shape
    weights = weights + 1e-5
    pdf = weights / running_sum(weights)[:, -1:]
    cdf = running_sum(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [n, M+1]
    if deterministic:
        u = linspace(1.0, n_samples, device=bins.device).expand(n_rays, n_samples)
    else:
        u = torch.rand((n_rays, n_samples), generator=generator, dtype=bins.dtype,
                       device=bins.device)
    above = torch.searchsorted(cdf[:, :m].contiguous(), u.contiguous(), right=True)
    below = torch.clamp(above - 1, min=0)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_fine_z_vals(z_vals: torch.Tensor, weights: torch.Tensor, n_importance: int,
                       inv_uniform: bool, deterministic: bool = True,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Importance-resample fine z values from the coarse pass's weights and
    merge-sort them with the coarse ones: [n_rays, S + n_importance].

    The first and last coarse weights are dropped; in inv_uniform mode the
    PDF is built over the flipped inverse-depth midpoints (so the bins
    increase), as the reference does.
    """
    w = weights[:, 1:-1]
    if inv_uniform:
        inv_z = 1.0 / z_vals
        inv_mid = 0.5 * (inv_z[:, 1:] + inv_z[:, :-1])
        z_fine = 1.0 / sample_pdf(torch.flip(inv_mid, dims=[1]), torch.flip(w, dims=[1]),
                                  n_importance, deterministic, generator)
    else:
        z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        z_fine = sample_pdf(z_mid, w, n_importance, deterministic, generator)
    return torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
