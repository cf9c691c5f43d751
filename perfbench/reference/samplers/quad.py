"""``quad``: the features upsampled to the image with align-corners bilinear
interpolation, stacked with the rgb and the dynamic mask into one map, read
by zero-padded bilinear interpolation."""

import torch
import torch.nn.functional as F

from perfbench.reference.render import bilinear


def prepare(src, feats, masks):
    h, w = src.shape[1:3]
    up = F.interpolate(feats.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                       align_corners=True).permute(0, 2, 3, 1)
    return torch.cat([src, up, masks], dim=-1)


def sample(maps, x, y):
    s = bilinear(maps, x, y)
    return s[..., :-1], s[..., -1]
