"""Image sampling in torch, channel-last, pixel-unit coordinates.

Counterpart of ``pgdvs_tpu.core.interpolate``: ``bilinear_sample`` is torch
``grid_sample(align_corners=True, padding_mode='zeros')`` once coordinates
are in pixels (or edge-clamped with ``zero_pad=False``); callers that need
the ``align_corners=False`` convention subtract half a pixel themselves.
"""

from __future__ import annotations

import torch


def _gather(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor):
    """img [H, W, C]; clipped integer ix/iy [...] -> [..., C]."""
    h, w, c = img.shape
    idx = (iy * w + ix).reshape(-1)
    return img.reshape(h * w, c)[idx].reshape(ix.shape + (c,))


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    zero_pad: bool = True) -> torch.Tensor:
    """Bilinearly sample img [H, W, C] at pixel coordinates x, y [...].

    zero_pad: taps outside the image contribute zero; otherwise the
    coordinate is edge-clamped.
    """
    h, w = img.shape[0], img.shape[1]
    sx = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    sy = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    if zero_pad:
        wx0 = torch.clamp(1.0 - torch.abs(x - sx), min=0.0)
        wx1 = torch.clamp(1.0 - torch.abs(x - (sx + 1.0)), min=0.0)
        wy0 = torch.clamp(1.0 - torch.abs(y - sy), min=0.0)
        wy1 = torch.clamp(1.0 - torch.abs(y - (sy + 1.0)), min=0.0)
    else:
        fx = torch.clamp(x, 0, w - 1.0) - sx
        fy = torch.clamp(y, 0, h - 1.0) - sy
        wx0, wx1, wy0, wy1 = 1.0 - fx, fx, 1.0 - fy, fy
    ix0 = sx.long()
    iy0 = sy.long()
    ix1 = torch.clamp(ix0 + 1, max=w - 1)
    iy1 = torch.clamp(iy0 + 1, max=h - 1)
    out = (
        _gather(img, ix0, iy0) * (wy0 * wx0)[..., None]
        + _gather(img, ix1, iy0) * (wy0 * wx1)[..., None]
        + _gather(img, ix0, iy1) * (wy1 * wx0)[..., None]
        + _gather(img, ix1, iy1) * (wy1 * wx1)[..., None]
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
    """Bilinear resize of [H, W, C] with torch F.interpolate corner mapping."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    if align_corners:
        ys = torch.linspace(0.0, h - 1.0, out_h, device=dev)
        xs = torch.linspace(0.0, w - 1.0, out_w, device=dev)
    else:
        ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (
            h / out_h) - 0.5
        xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (
            w / out_w) - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return bilinear_sample(img, gx, gy, zero_pad=False)
