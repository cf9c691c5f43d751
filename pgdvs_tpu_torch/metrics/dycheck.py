"""DyCheck (iPhone) metrics: mPSNR / mSSIM / mLPIPS with covisibility masks.

The port's counterpart of ``pgdvs_tpu.metrics.dycheck``:

  * mPSNR: -10 / ln 10 * ln(masked mean squared error);
  * mSSIM: tf.image.ssim-style Gaussian-window SSIM (filter 11, sigma 1.5)
    whose blur is a partial convolution against the mask (two separable
    "valid" passes per channel, the mask carried from the first pass into
    the second), so masked pixels do not enter the window statistics;
  * mLPIPS: LPIPS on the mask-multiplied images, the spatial map's masked
    mean (``metrics.lpips``).

Images are [H, W, C] float32 tensors, masks [H, W, 1]. The convolutions
run in float32 (TF32 off on a card), as the JAX package runs them at
``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from pgdvs_tpu_torch.metrics.lpips import lpips_distance, no_tf32


def masked_mean(x, mask=None):
    if mask is None:
        return torch.mean(x)
    mask = mask.expand(x.shape)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1e-8)


def compute_psnr(img0, img1, mask=None):
    mse = (img0 - img1) ** 2
    return -10.0 / math.log(10.0) * torch.log(masked_mean(mse, mask))


def _conv_valid(z, f2):
    """2D "valid" correlation of z [H, W] with f2 [kh, kw]."""
    return F.conv2d(z[None, None], f2[None, None])[0, 0]


def _partial_blur(z, m2, f2):
    z_ = _conv_valid(z * m2, f2)
    m_ = _conv_valid(m2, torch.ones_like(f2))
    norm = torch.sum(torch.ones_like(f2))
    out = torch.where(m_ != 0, z_ * norm / m_, torch.zeros_like(z_))
    return out, (m_ != 0).to(z.dtype)


@torch.no_grad()
def compute_ssim(img0, img1, mask=None, max_val: float = 1.0, filter_size: int = 11,
                 filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Gaussian-window SSIM with partial-convolution masking (0-d tensor)."""
    if mask is None:
        mask = torch.ones_like(img0[..., :1])
    m = mask[..., 0]

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((torch.arange(filter_size, dtype=torch.float32, device=img0.device) - hw + shift)
           / filter_sigma) ** 2
    filt = torch.exp(-0.5 * f_i)
    filt = filt / torch.sum(filt)

    def filt_fn(z):
        # separable: rows then columns, per channel
        out = []
        for c in range(z.shape[-1]):
            z1, m1 = _partial_blur(z[..., c], m, filt[None, :])
            out.append(_partial_blur(z1, m1, filt[:, None])[0])
        return torch.stack(out, -1)

    with no_tf32() if img0.is_cuda else contextlib.nullcontext():
        mu0 = filt_fn(img0)
        mu1 = filt_fn(img1)
        mu00 = mu0 * mu0
        mu11 = mu1 * mu1
        mu01 = mu0 * mu1
        sigma00 = filt_fn(img0 ** 2) - mu00
        sigma11 = filt_fn(img1 ** 2) - mu11
        sigma01 = filt_fn(img0 * img1) - mu01

    sigma00 = torch.clamp(sigma00, min=0.0)
    sigma11 = torch.clamp(sigma11, min=0.0)
    sigma01 = torch.sign(sigma01) * torch.minimum(torch.sqrt(sigma00 * sigma11),
                                                  torch.abs(sigma01))

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return torch.mean(numer / denom)


def compute_lpips(net, img0, img1, mask=None):
    """Masked LPIPS on mask-multiplied images (the DyCheck protocol), on the
    net's device."""
    if mask is None:
        mask = torch.ones_like(img0[..., :1])
    dmap = lpips_distance(net, img0 * mask, img1 * mask, spatial=True)  # [H, W, 1]
    return masked_mean(dmap, mask)
