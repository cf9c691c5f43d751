"""Softmax splatting (Niklaus & Liu, CVPR 2020), plain torch.

Counterpart of ``pgdvs_tpu.kernels.softsplat``, which is an XLA scatter-add
in the JAX package (no Pallas kernel). Every source pixel lands at
``(x + flow_x, y + flow_y)`` and adds into its 4 integer neighbours with
bilinear weights (``index_add_`` on a flat buffer with a trash row for
out-of-image targets). On CUDA ``index_add_`` uses atomics, so sums come out
in a run-dependent order: compare with a tolerance.
"""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.core.interpolate import backwarp


def softsplat(image: torch.Tensor, flow: torch.Tensor, metric=None,
              mode: str = "soft") -> torch.Tensor:
    """Forward-splat image [H, W, C] along flow [H, W, 2].

    mode: 'sum' | 'avg' | 'linear' | 'soft', optionally with an
    '-addeps' / '-zeroeps' / '-clipeps' suffix; 'linear' and 'soft' need
    metric [H, W, 1].
    """
    base, _, eps_mode = mode.partition("-")
    if base not in ("sum", "avg", "linear", "soft"):
        raise ValueError(f"unknown softsplat mode {mode!r}")
    if base in ("linear", "soft") and metric is None:
        raise ValueError(f"mode {mode!r} requires a metric")
    if eps_mode not in ("", "addeps", "zeroeps", "clipeps"):
        raise ValueError(f"unknown eps mode in {mode!r}")

    h, w, _ = image.shape
    img = image.float()
    if base == "sum":
        payload = img
    elif base == "avg":
        payload = torch.cat([img, torch.ones_like(img[..., :1])], dim=-1)
    else:
        m = metric.float() if base == "linear" else torch.exp(metric.float())
        payload = torch.cat([img * m, m], dim=-1)

    out = _scatter_bilinear(payload, flow.float())
    if base == "sum":
        return out.to(image.dtype)
    num, den = out[..., :-1], out[..., -1:]
    if eps_mode in ("", "addeps"):
        den = den + 1e-7
    elif eps_mode == "zeroeps":
        den = torch.where(den == 0.0, torch.ones_like(den), den)
    else:
        den = torch.clamp(den, min=1e-7)
    return (num / den).to(image.dtype)


def _scatter_bilinear(payload: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Scatter-add payload [H, W, C] to its flow targets, bilinear footprint."""
    h, w, c = payload.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=flow.device),
        torch.arange(w, dtype=torch.float32, device=flow.device),
        indexing="ij",
    )
    fx = gx + flow[..., 0]
    fy = gy + flow[..., 1]
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    fx = torch.where(finite, fx, torch.full_like(fx, -1e9))
    fy = torch.where(finite, fy, torch.full_like(fy, -1e9))
    x0, y0 = torch.floor(fx), torch.floor(fy)
    flat = payload.reshape(h * w, c)
    out = torch.zeros((h * w + 1, c), dtype=torch.float32, device=payload.device)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wx = (xi + 1.0 - fx) if dx == 0 else (fx - (xi - 1.0))
        wy = (yi + 1.0 - fy) if dy == 0 else (fy - (yi - 1.0))
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & finite
        idx = torch.where(valid, yi * w + xi, torch.full_like(xi, h * w))
        wgt = torch.where(valid, wx * wy, torch.zeros_like(wx))
        out.index_add_(0, idx.long().reshape(-1), flat * wgt.reshape(-1, 1))
    return out[: h * w].reshape(h, w, c)


def brightness_metric(rgb_src1, rgb_src2, flow_12, alpha: float):
    """``-alpha * mean_c |I1 - backwarp(I2, flow_12)|`` clipped to +-alpha,
    [H, W, 1]: more photo-consistent pixels get more splatting weight."""
    l1 = torch.mean(torch.abs(rgb_src1 - backwarp(rgb_src2, flow_12)), dim=-1,
                    keepdim=True)
    return torch.clamp(-alpha * l1, -alpha, alpha)
