"""ResUNet image feature extractor for GNT (torch).

Counterpart of ``pgdvs_tpu.models.gnt.feature_net.ResUNet``: a ResNet34-style
encoder (BasicBlock stacks [3, 4, 6], strides 2/2/2 above a stride-2 7x7
stem) with reflect-padded convs and stat-free affine InstanceNorm
(eps 1e-5), a two-level decoder (x2 align-corners bilinear upsample, reflect
conv, InstanceNorm, ELU, centre pad/crop skip concat) and a 1x1 out conv to
32 channels at 1/4 resolution. Submodule names follow the reference torch
network. The public layout is NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False):
    return nn.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2, bias=bias,
                     padding_mode="reflect")


def _norm(c: int):
    return nn.InstanceNorm2d(c, eps=1e-5, affine=True,
                             track_running_stats=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = _norm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _norm(planes)
        self.downsample = (
            nn.Sequential(_conv(cin, planes, 1, stride), _norm(planes))
            if downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ConvINElu(nn.Module):
    """Reflect conv (with bias) + InstanceNorm + ELU."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = _conv(cin, cout, k, bias=True)
        self.bn = _norm(cout)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class UpConv(nn.Module):
    """x2 bilinear (align_corners) upsample, then ConvINElu."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvINElu(cin, cout)

    def forward(self, x):
        h, w = x.shape[-2:]
        x = F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                          align_corners=True)
        return self.conv(x)


def _match_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Centre pad (or crop, for negative amounts) x's H, W to ref's."""
    dh = ref.shape[-2] - x.shape[-2]
    dw = ref.shape[-1] - x.shape[-1]
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class ResUNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6), out_channels: int = 32):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _norm(64)
        cin = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256), layers)):
            stack = [BasicBlock(cin, planes, 2, downsample=True)]
            stack += [BasicBlock(planes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*stack))
            cin = planes
        self.upconv3 = UpConv(256, 128)
        self.iconv3 = ConvINElu(128 + 128, 128)
        self.upconv2 = UpConv(128, 64)
        self.iconv2 = ConvINElu(64 + 64, out_channels)
        self.out_conv = nn.Conv2d(out_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] -> features [N, H/4, W/4, out_channels]."""
        h = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x1 = self.layer1(h)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        u3 = self.upconv3(x3)
        u3 = self.iconv3(torch.cat([u3, _match_to(x2, u3)], dim=1))
        u2 = self.upconv2(u3)
        u2 = self.iconv2(torch.cat([u2, _match_to(x1, u2)], dim=1))
        return self.out_conv(u2).permute(0, 2, 3, 1)
