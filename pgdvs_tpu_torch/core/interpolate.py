"""Image sampling in torch, channel-last, pixel-unit coordinates.

Counterpart of ``pgdvs_tpu.core.interpolate``: ``bilinear_sample`` is torch
``grid_sample(align_corners=True, padding_mode='zeros')`` once coordinates
are in pixels (or edge-clamped with ``zero_pad=False``); callers that need
the ``align_corners=False`` convention subtract half a pixel themselves.
``resize`` is ``jax.image.resize`` for the cubic, linear and nearest methods;
``resize_axes`` is its cubic and linear methods on every axis of any rank.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdvs_tpu_torch.core.sampling import linspace


def _gather(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, frame=None):
    """img [H, W, C], or [T, H, W, C] with integer ``frame`` indices
    broadcast against ix; clipped integer ix/iy [...] -> [..., C]."""
    h, w, c = img.shape[-3:]
    idx = iy * w + ix
    if frame is not None:
        idx = idx + frame * (h * w)
    return img.reshape(-1, c)[idx.reshape(-1)].reshape(ix.shape + (c,))


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    zero_pad: bool = True, frame=None) -> torch.Tensor:
    """Bilinearly sample img [H, W, C] at pixel coordinates x, y [...]; with
    ``frame`` (integer, broadcast against x), img [T, H, W, C] at those
    frames.

    zero_pad: taps outside the image contribute zero (on an axis one pixel
    wide the second tap always lies outside, as in JAX's narrow-image path;
    its path for 8 channels and more reads the edge there); otherwise the
    coordinate is edge-clamped.
    """
    h, w = img.shape[-3], img.shape[-2]
    sx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    sy = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    if zero_pad:
        wx0 = torch.clamp(1.0 - torch.abs(x - sx), min=0.0)
        wx1 = torch.clamp(1.0 - torch.abs(x - (sx + 1.0)), min=0.0)
        wy0 = torch.clamp(1.0 - torch.abs(y - sy), min=0.0)
        wy1 = torch.clamp(1.0 - torch.abs(y - (sy + 1.0)), min=0.0)
        # a one-pixel-wide axis has no second tap: it lies outside, so zero
        if w < 2:
            wx1 = torch.zeros_like(wx1)
        if h < 2:
            wy1 = torch.zeros_like(wy1)
    else:
        fx = torch.clamp(x, 0, w - 1.0) - sx
        fy = torch.clamp(y, 0, h - 1.0) - sy
        wx0, wx1, wy0, wy1 = 1.0 - fx, fx, 1.0 - fy, fy
    ix0 = sx.long()
    iy0 = sy.long()
    ix1 = torch.clamp(ix0 + 1, max=w - 1)
    iy1 = torch.clamp(iy0 + 1, max=h - 1)
    out = (
        _gather(img, ix0, iy0, frame) * (wy0 * wx0)[..., None]
        + _gather(img, ix1, iy0, frame) * (wy0 * wx1)[..., None]
        + _gather(img, ix0, iy1, frame) * (wy1 * wx0)[..., None]
        + _gather(img, ix1, iy1, frame) * (wy1 * wx1)[..., None]
    )
    return out.to(img.dtype)


def nearest_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Nearest-neighbour sample (round half to even), edge-clamped."""
    h, w = img.shape[0], img.shape[1]
    ix = torch.clamp(torch.round(x), 0, w - 1).long()
    iy = torch.clamp(torch.round(y), 0, h - 1).long()
    return _gather(img, ix, iy)


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out[y, x] = img(x + flow_x, y + flow_y), bilinear, zero padding."""
    h, w = img.shape[0], img.shape[1]
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device),
        indexing="ij",
    )
    return bilinear_sample(img, gx + flow[..., 0], gy + flow[..., 1])


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of [H, W, C] with torch F.interpolate corner mapping,
    edge-clamped, as the JAX package's ``resize_bilinear`` computes it: the
    sample grid as XLA evaluates ``jnp.linspace``, the four tap weights
    rounded to the image's dtype and the taps accumulated in float32, then
    rounded to that dtype (bit-equal to JAX on bf16 feature maps)."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    if align_corners:
        ys = linspace(h - 1.0, out_h, device=dev)
        xs = linspace(w - 1.0, out_w, device=dev)
    else:
        ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (
            h / out_h) - 0.5
        xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (
            w / out_w) - 0.5
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    sx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    sy = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    fx = torch.clamp(x, 0, w - 1.0) - sx
    fy = torch.clamp(y, 0, h - 1.0) - sy
    ix0, iy0 = sx.long(), sy.long()
    ix1, iy1 = torch.clamp(ix0 + 1, max=w - 1), torch.clamp(iy0 + 1, max=h - 1)
    out = None
    for ix, iy, wgt in ((ix0, iy0, (1.0 - fy) * (1.0 - fx)), (ix1, iy0, (1.0 - fy) * fx),
                        (ix0, iy1, fy * (1.0 - fx)), (ix1, iy1, fy * fx)):
        tap = _gather(img, ix, iy).float() * wgt.to(img.dtype).float()[..., None]
        out = tap if out is None else out + tap
    return out.to(img.dtype)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 at |offsets| x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """The linear kernel max(0, 1 - |x|) at offsets x >= 0."""
    return torch.clamp(1.0 - x, min=0.0)


def _resize_weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """[n_in, n_out] weights of one axis of ``jax.image.resize`` with
    ``kernel`` (``jax.image.scale_and_translate``'s ``compute_weight_mat``):
    half-pixel centres, the kernel widened by the downsampling factor
    (antialiasing), each column renormalized to sum 1, columns whose sample
    lies outside the input zeroed."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)
    # JAX rounds both factors to float32 before it uses them
    sample_f = ((torch.arange(n_out, dtype=f32, device=device) + 0.5)
                * float(np.float32(inv_scale)) - 0.5)
    kernel_scale = float(np.float32(max(inv_scale, 1.0)))
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None])
    weights = kernel(x / kernel_scale)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(f32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize(img: torch.Tensor, out_h: int, out_w: int, method: str) -> torch.Tensor:
    """``jax.image.resize(img, (out_h, out_w, C), method)`` for [H, W, C]
    float32 images, ``method`` "cubic", "linear" or "nearest".

    cubic: separable Keys cubic (a = -0.5) weight matrices on half-pixel
    centres, antialiased when downsampling, renormalized at the border
    (``torch.nn.functional.interpolate``'s bicubic uses a = -0.75 and none
    of the rest). linear: the same with the triangle kernel. nearest: source index floor((i + 0.5) * in / out) in
    float32, half-pixel centres (torch's "nearest" floors i * in / out).
    An axis whose size does not change is left as it is.
    """
    h, w = img.shape[0], img.shape[1]
    if method == "nearest":
        def index(n_in, n_out):
            pos = (torch.arange(n_out, dtype=torch.float32, device=img.device) + 0.5) * n_in
            return torch.floor(pos / n_out).long()

        if out_h != h:
            img = img[index(h, out_h)]
        if out_w != w:
            img = img[:, index(w, out_w)]
        return img
    kernels = {"cubic": _keys_cubic, "linear": _triangle}
    if method not in kernels:
        raise ValueError(f"unknown resize method {method!r}; valid: cubic | linear | nearest")
    kernel = kernels[method]
    img = img.float()
    if out_h != h:
        img = torch.einsum("hwc,ho->owc", img, _resize_weights(h, out_h, kernel, img.device))
    if out_w != w:
        img = torch.einsum("hwc,wp->hpc", img, _resize_weights(w, out_w, kernel, img.device))
    return img


def resize_axes(x: torch.Tensor, shape, method: str = "linear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for float32 tensors of any
    rank, ``method`` "cubic" or "linear": every axis whose size changes is
    resized with ``resize``'s weight matrices, the channel axis as well
    (JAX resizes whichever axes ``shape`` changes)."""
    kernels = {"cubic": _keys_cubic, "linear": _triangle}
    if method not in kernels:
        raise ValueError(f"unknown resize method {method!r}; valid: cubic | linear")
    x = x.float()
    for axis, n_out in enumerate(shape):
        n_in = x.shape[axis]
        if n_in != n_out:
            w = _resize_weights(n_in, n_out, kernels[method], x.device)
            x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x
