"""ZoeDepth's inference protocol around the network, in torch.

Counterpart of ``pgdvs_tpu.models.depth.zoe_infer``: the reference calls
``model.infer(X)`` on raw-resolution [0, 1] images
(``compute_zoedepth.py:257``), which

  1. reflect-pads by ``int(sqrt(dim / 2) * 3)`` per side;
  2. resizes to the network size (384x512) keeping the aspect ratio,
     scaling as little as possible, to multiples of 32, bilinear with
     align_corners=True;
  3. runs the network and averages with the prediction of the
     horizontally flipped input (the flip runs in the same batch);
  4. resizes back to the padded size, bicubic with align_corners=False
     (a = -0.75, taps clamped at the edges), and crops the padding.

The JAX package writes these resizes in numpy after torch's
``F.interpolate``; here they are ``F.interpolate`` itself, on the image's
device, the bicubic in float64 as the numpy version computes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def resize_output_size(in_h, in_w, out_h, out_w, keep_aspect=True, multiple=32):
    """HF get_resize_output_image_size / original midas Resize("minimal")."""

    def constrain(val):
        x = int(np.round(val / multiple) * multiple)
        if x < 0:
            x = math.ceil(val / multiple) * multiple
        return x

    scale_h = out_h / in_h
    scale_w = out_w / in_w
    if keep_aspect:
        # scale as little as possible
        if abs(1 - scale_w) < abs(1 - scale_h):
            scale_h = scale_w
        else:
            scale_w = scale_h
    return constrain(scale_h * in_h), constrain(scale_w * in_w)


def _interpolate_hw(img: torch.Tensor, out_h: int, out_w: int, **kwargs) -> torch.Tensor:
    """``F.interpolate`` of [H, W] or [H, W, C]."""
    x = img[..., None] if img.ndim == 2 else img
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(out_h, out_w), **kwargs)[0]
    out = out.permute(1, 2, 0)
    return out[..., 0] if img.ndim == 2 else out


def resize_bilinear_ac(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch F.interpolate(mode='bilinear', align_corners=True) of [H, W]
    or [H, W, C]."""
    return _interpolate_hw(img, out_h, out_w, mode="bilinear", align_corners=True)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch F.interpolate(mode='bicubic', align_corners=False) of [H, W] or
    [H, W, C], in float64."""
    return _interpolate_hw(img.double(), out_h, out_w, mode="bicubic", align_corners=False)


def zoe_infer(depth_fn, img: torch.Tensor, net_hw=(384, 512), pad_input=True,
              with_flip_aug=True) -> torch.Tensor:
    """Run ``depth_fn`` under the reference's infer protocol.

    depth_fn: [B, 3, H', W'] in [0, 1] -> metric depth [B, H', W'] (B = 2
    with the flip); img: [H, W, 3] float in [0, 1] on the device the
    network runs on. Returns depth [H, W] float32 there.
    """
    x = img.float().permute(2, 0, 1)[None]
    h, w = x.shape[-2:]
    pad_h = pad_w = 0
    if pad_input:
        pad_h = int(np.sqrt(h / 2) * 3)
        pad_w = int(np.sqrt(w / 2) * 3)
        x = F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    ph, pw = x.shape[-2:]
    nh, nw = resize_output_size(ph, pw, net_hw[0], net_hw[1])
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=True)

    if with_flip_aug:
        d = depth_fn(torch.cat([x, x.flip(-1)])).float()
        d = (d[0] + d[1].flip(-1)) / 2.0
    else:
        d = depth_fn(x).float()[0]

    d = resize_bicubic(d, ph, pw).float()
    return d[pad_h:ph - pad_h, pad_w:pw - pad_w]
