"""Masked PSNR / SSIM, the DynIBaR evaluation protocol (numpy, on the host).

The port's own copy of ``pgdvs_tpu.metrics.psnr_ssim`` (plain numpy; the
port imports nothing of the JAX package), which matches the reference
metrics:

  * images are uint8-quantized, then rescaled to [0, 1] before the metrics
    (``quantize_uint8``);
  * PSNR: masked MSE in float64, ``10 log10(1 / mse)``; mse == 0 -> 0;
  * SSIM: skimage ``structural_similarity(full=True, channel_axis=2,
    data_range=2.0)`` (the protocol's data_range of 2.0 on [0, 1] images is
    kept for comparability), masked mean over the full SSIM map; a scipy
    replica of the map where skimage is not installed.

Metrics are per image and small; they run on the host.
"""

from __future__ import annotations

import math

import numpy as np


def quantize_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8 and back, the evaluator's pre-metric rounding."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8).astype(
        np.float64
    ) / 255.0


def masked_psnr(img1, img2, mask) -> float:
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mask = np.asarray(mask, np.float64)
    num_valid = np.sum(mask) + 1e-8
    mse = np.sum((img1 - img2) ** 2 * mask) / num_valid
    if mse == 0:
        return 0.0
    return 10.0 * math.log10(1.0 / mse)


def _ssim_map(img1, img2, data_range=2.0):
    """skimage structural_similarity(full=True) map, per channel, numpy.

    Matches skimage defaults: 7x7 uniform window, K1=0.01, K2=0.03,
    unbiased covariance normalization (crop of win//2 border handled by
    returning the full map exactly as skimage does — skimage computes over
    'valid' correlation internally via uniform_filter, same as a mean
    filter with reflect... skimage uses uniform_filter (nearest-pad); we
    replicate with scipy.ndimage.uniform_filter).
    """
    from scipy.ndimage import uniform_filter

    win = 7
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    np_ = win ** 2
    cov_norm = np_ / (np_ - 1)

    def f(x):
        return uniform_filter(x, size=win)

    ux = f(img1)
    uy = f(img2)
    uxx = f(img1 * img1)
    uyy = f(img2 * img2)
    uxy = f(img1 * img2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def masked_ssim(img1, img2, mask, data_range: float = 2.0) -> float:
    """Masked mean of the full SSIM map (DynIBaR protocol).

    Uses skimage when available (bit parity); falls back to the local
    replica otherwise.
    """
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mask = np.asarray(mask, np.float64)
    try:
        import skimage.metrics

        _, ssim_map = skimage.metrics.structural_similarity(
            img1, img2, full=True, channel_axis=2, data_range=data_range
        )
    except ImportError:  # pragma: no cover
        ssim_map = np.stack(
            [
                _ssim_map(img1[..., c], img2[..., c], data_range)
                for c in range(img1.shape[-1])
            ],
            axis=-1,
        )
    num_valid = np.sum(mask) + 1e-8
    return float(np.sum(ssim_map * mask) / num_valid)
