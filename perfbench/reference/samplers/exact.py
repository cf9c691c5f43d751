"""``exact``: rgb and the dynamic mask read on the image, the features on
their own quarter-size map at the scaled position, each by zero-padded
bilinear interpolation."""

import torch

from perfbench.reference.render import bilinear


def prepare(src, feats, masks):
    return src, feats, masks


def sample(prepared, x, y):
    src, feats, masks = prepared
    h, w = src.shape[1:3]
    hf, wf = feats.shape[1:3]
    rgb_feat = torch.cat([bilinear(src, x, y),
                          bilinear(feats, x * ((wf - 1.0) / (w - 1.0)),
                                   y * ((hf - 1.0) / (h - 1.0)))], dim=-1)
    return rgb_feat, bilinear(masks, x, y)[..., 0]
