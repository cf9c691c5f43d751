"""The plain networks of the reference: GNT, its ResUNet and LPIPS's AlexNet.

Plain torch modules, float32, with no kernel, cache or batching. They follow
the published GNT (Wang et al., ICLR 2023, as PGDVS uses it) and the LPIPS
v0.1 AlexNet metric, and carry the parameter names of the program's modules
so that one state dict, made by the benchmark, loads into both sides.

``low=True`` computes them one precision step below what the configuration
states, for the control: every GNT product with both operands rounded to
fp8 e4m3 (per-tensor scale, float32 accumulation) where the program states
bf16, the ResUNet in bf16 where it states float32.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

FP8_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to fp8 e4m3 with a per-tensor scale (amax -> 448), back in
    float32."""
    scale = torch.clamp(t.detach().abs().amax(), min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, layer: nn.Linear, low: bool) -> torch.Tensor:
    if not low:
        return F.linear(x, layer.weight, layer.bias)
    return F.linear(round_fp8(x), round_fp8(layer.weight), layer.bias)


def pos_code(x: torch.Tensor, n_freqs: int = 10) -> torch.Tensor:
    """NeRF's positional code [x, sin(2^k x), cos(2^k x), ...], k < n_freqs,
    each term evaluated directly."""
    parts = [x]
    for k in range(n_freqs):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


def _mlp(x, seq, low):
    return linear(F.relu(linear(x, seq[0], low)), seq[2], low)


class _FF(nn.Module):
    def __init__(self, dim, hid):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hid), nn.Linear(hid, dim)


class _ViewAttn(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.q_fc = nn.Linear(dim, dim, bias=False)
        self.k_fc = nn.Linear(dim, dim, bias=False)
        self.v_fc = nn.Linear(dim, dim, bias=False)
        self.pos_fc = nn.Sequential(nn.Linear(4, dim // 8), nn.ReLU(), nn.Linear(dim // 8, dim))
        self.attn_fc = nn.Sequential(nn.Linear(dim, dim // 8), nn.ReLU(),
                                     nn.Linear(dim // 8, dim))
        self.out_fc = nn.Linear(dim, dim)


class _ViewBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _ViewAttn(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = _FF(dim, 4 * dim)


class _RayAttn(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.q_fc = nn.Linear(dim, dim, bias=False)
        self.k_fc = nn.Linear(dim, dim, bias=False)
        self.v_fc = nn.Linear(dim, dim, bias=False)
        self.out_fc = nn.Linear(dim, dim)


class _RayBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _RayAttn(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = _FF(dim, 4 * dim)


class GNT(nn.Module):
    """Alternating view transformers (subtraction attention over the source
    views, masked, with the ray-difference code) and ray transformers
    (4-head attention over the samples); the point and view codes are
    injected after every even view block; rgb from the sample-mean of the
    normalised tokens; the per-sample weights are the last ray block's
    head-mean attention of the first query."""

    def __init__(self, netwidth=64, depth=8, in_feat_ch=32, heads=4):
        super().__init__()
        w = netwidth
        self.depth, self.heads = depth, heads
        self.rgbfeat_fc = nn.Sequential(nn.Linear(3 + in_feat_ch, w), nn.ReLU(), nn.Linear(w, w))
        self.view_crosstrans = nn.ModuleList(_ViewBlock(w) for _ in range(depth))
        self.view_selftrans = nn.ModuleList(_RayBlock(w) for _ in range(depth))
        self.q_fcs = nn.ModuleList(
            nn.Sequential(nn.Linear(w + 126, w), nn.ReLU(), nn.Linear(w, w))
            for _ in range(depth // 2))
        self.norm = nn.LayerNorm(w, eps=1e-6)
        self.rgb_fc = nn.Linear(w, 3)

    def _view(self, blk, q, k, pos, mask, low):
        a = blk.attn
        x = blk.attn_norm(q)
        qp = linear(x, a.q_fc, low)
        kp = linear(k, a.k_fc, low)
        vp = linear(kp, a.v_fc, low)
        pe = _mlp(pos, a.pos_fc, low)
        logits = _mlp(kp - qp[..., None, :] + pe, a.attn_fc, low)
        none_valid = mask.sum(dim=-2, keepdim=True) == 0
        keep = (mask > 0) | none_valid
        attn = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-2)
        x = linear(((vp + pe) * attn).sum(dim=-2), a.out_fc, low) + q
        return x + linear(F.relu(linear(blk.ff_norm(x), blk.ff.fc1, low)), blk.ff.fc2, low)

    def _ray(self, blk, x, low):
        a = blk.attn
        y = blk.attn_norm(x)
        hd = y.shape[-1] // self.heads

        def heads(t):
            return t.reshape(t.shape[:-1] + (self.heads, hd)).transpose(-2, -3)

        q = heads(linear(y, a.q_fc, low))
        k = heads(linear(y, a.k_fc, low))
        v = heads(linear(y, a.v_fc, low))
        if low:
            q, k, v = round_fp8(q), round_fp8(k), round_fp8(v)
        attn = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, dim=-1)
        pv = (round_fp8(attn) if low else attn) @ v
        x = x + linear(pv.transpose(-2, -3).reshape(x.shape), a.out_fc, low)
        x = x + linear(F.relu(linear(blk.ff_norm(x), blk.ff.fc1, low)), blk.ff.fc2, low)
        return x, attn.mean(dim=-3)[..., 0, :]

    def forward(self, rgb_feat, ray_diff, mask, pts, viewdirs, low=False):
        """rgb_feat [R, S, V, C], ray_diff [R, S, V, 4], mask [R, S, V, 1],
        pts [R, S, 3], viewdirs [R, 3] (unit) -> rgb [R, 3], weights [R, S]."""
        pcode = pos_code(pts)
        vcode = pos_code(viewdirs)[:, None, :].expand(pcode.shape)
        h = _mlp(rgb_feat, self.rgbfeat_fc, low)
        q = h.max(dim=-2).values
        weights = None
        for i in range(self.depth):
            q = self._view(self.view_crosstrans[i], q, h, ray_diff, mask, low)
            if i % 2 == 0:
                q = _mlp(torch.cat([q, pcode, vcode], -1), self.q_fcs[i // 2], low)
            q, weights = self._ray(self.view_selftrans[i], q, low)
        return linear(self.norm(q).mean(dim=-2), self.rgb_fc, low), weights


def _conv(cin, cout, k, stride=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2, bias=bias,
                     padding_mode="reflect")


def _inorm(c):
    return nn.InstanceNorm2d(c, eps=1e-5, affine=True, track_running_stats=False)


class _Basic(nn.Module):
    def __init__(self, cin, planes, stride=1, down=False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 3, stride), _inorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _inorm(planes)
        self.downsample = (nn.Sequential(_conv(cin, planes, 1, stride), _inorm(planes))
                           if down else None)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class _ConvINElu(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv, self.bn = _conv(cin, cout, 3, bias=True), _inorm(cout)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class _Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = _ConvINElu(cin, cout)

    def forward(self, x):
        h, w = x.shape[-2:]
        return self.conv(F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                                       align_corners=True))


def _centre(x, ref):
    dh, dw = ref.shape[-2] - x.shape[-2], ref.shape[-1] - x.shape[-1]
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class ResUNet(nn.Module):
    """GNT's feature network: a ResNet-34-style encoder (blocks 3, 4, 6 at
    64, 128, 256 channels, stride 2 each, under a stride-2 7x7 stem), with
    reflect padding and affine instance norms, and a two-level decoder
    (x2 align-corners upsampling, skip concatenation) to 32 channels at a
    quarter of the image size."""

    def __init__(self, layers=(3, 4, 6), out_channels=32):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), _inorm(64)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256), layers)):
            blocks = [_Basic(cin, planes, 2, True)] + [_Basic(planes, planes) for _ in range(1, n)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            cin = planes
        self.upconv3, self.iconv3 = _Up(256, 128), _ConvINElu(256, 128)
        self.upconv2, self.iconv2 = _Up(128, 64), _ConvINElu(128, out_channels)
        self.out_conv = nn.Conv2d(out_channels, out_channels, 1)

    def forward(self, x):
        """x [N, H, W, 3] -> [N, H/4, W/4, C]."""
        h = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x1 = self.layer1(h)
        x2 = self.layer2(x1)
        u3 = self.upconv3(self.layer3(x2))
        u3 = self.iconv3(torch.cat([u3, _centre(x2, u3)], 1))
        u2 = self.upconv2(u3)
        u2 = self.iconv2(torch.cat([u2, _centre(x1, u2)], 1))
        return self.out_conv(u2).permute(0, 2, 3, 1)


ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))


class AlexLPIPS(nn.Module):
    """LPIPS v0.1 (Zhang et al., CVPR 2018) on AlexNet conv1-5: ImageNet
    scaling, relu features, max-pool 3/2 after conv1 and conv2; per layer
    the channel-normalised squared difference weighted by the linear head."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for cout, k, s, p in ALEX:
            convs.append(nn.Conv2d(cin, cout, k, s, p))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(nn.Parameter(torch.zeros(c)) for c, *_ in ALEX)

    def features(self, x):
        shift = torch.tensor((-0.030, -0.088, -0.188), device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor((0.458, 0.448, 0.450), device=x.device).view(1, 3, 1, 1)
        x = (x - shift.to(x.dtype)) / scale.to(x.dtype)
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return feats
