"""GNT — generalizable NeRF transformer, plain torch.

The counterpart of ``pgdvs_tpu.models.gnt.network.GNT``: alternating view
transformers (per-channel subtraction attention over source views,
ray-difference positional code) and ray transformers (4-head attention
over samples), ``q_fcs`` injecting the sinusoidal point / view codes after
every even view block, then ``rgb_fc(mean_s LayerNorm(q))``. The returned per-sample weights are the
last ray transformer's head-mean of its FIRST query row. With
``ret_view_std=True`` it also returns the per-block view-consistency
diagnostics (``masked_view_std`` of the projected features before the
blocks, of each view block's keys after), which no hand kernel computes.

Submodule names follow the reference torch network
(``view_crosstrans.{i}``, ``view_selftrans.{i}``, ``rgbfeat_fc.{0,2}``),
except ``q_fcs``, which holds one entry per even block (``q_fcs.{i // 2}``).

This module is the plain version the hand kernel
(``pgdvs_tpu_torch.kernels.gnt_fused``) is held against.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

POSENC = 63


def sinusoidal_embed(x: torch.Tensor, n_freqs: int = 10) -> torch.Tensor:
    """[x, sin(2^k x), cos(2^k x), ...] for k = 0..n_freqs-1.

    The octave ladder is built by the double-angle recurrence from one
    sin/cos pair, exactly as the JAX package does, so both give the same
    values to f32 rounding.
    """
    parts = [x]
    s, c = torch.sin(x), torch.cos(x)
    for _ in range(n_freqs):
        parts.append(s)
        parts.append(c)
        s, c = 2.0 * s * c, c * c - s * s
    return torch.cat(parts, dim=-1)


def masked_view_std(k: torch.Tensor, valid: torch.Tensor, eps: float = 1e-6):
    """Per-(ray, sample) std of k over the valid views, and its normalized
    form (std / (mean |k| + eps)), as the JAX package computes them.

    Unbiased std over the valid views; exactly one valid view gives 0; no
    valid view gives the std over all views (the reference unmasks those
    rows).

    Args: k [..., V, C]; valid [..., V, 1] (1 = valid).
    Returns (std [..., C], normalized std [..., C]).
    """
    v = k.shape[-2]
    cnt = valid.sum(dim=-2)                                      # [..., 1]
    all_invalid = cnt == 0
    eff_valid = torch.where(all_invalid[..., None, :], torch.ones_like(valid), valid)
    eff_cnt = torch.where(all_invalid, torch.full_like(cnt, float(v)), cnt)
    mean = (k * eff_valid).sum(dim=-2) / eff_cnt
    var = (((k - mean[..., None, :]) ** 2 * eff_valid).sum(dim=-2)
           / torch.clamp(eff_cnt - 1.0, min=1.0))
    std = torch.sqrt(var)
    norm_std = std / ((k.abs() * eff_valid).sum(dim=-2) / eff_cnt + eps)
    single = eff_cnt == 1
    return (torch.where(single, torch.zeros_like(std), std),
            torch.where(single, torch.zeros_like(norm_std), norm_std))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hid_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hid_dim)
        self.fc2 = nn.Linear(hid_dim, dim)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class ViewAttention(nn.Module):
    """softmax_v(attn_fc(k - q + pos_fc(ray_diff))) over source views.

    Invalid views are masked out; a (ray, sample) whose views are all
    invalid attends to every view un-masked.
    """

    def __init__(self, dim: int):
        super().__init__()
        self.q_fc = nn.Linear(dim, dim, bias=False)
        self.k_fc = nn.Linear(dim, dim, bias=False)
        self.v_fc = nn.Linear(dim, dim, bias=False)
        self.pos_fc = nn.Sequential(
            nn.Linear(4, dim // 8), nn.ReLU(), nn.Linear(dim // 8, dim)
        )
        self.attn_fc = nn.Sequential(
            nn.Linear(dim, dim // 8), nn.ReLU(), nn.Linear(dim // 8, dim)
        )
        self.out_fc = nn.Linear(dim, dim)

    def forward(self, q, k, pos, mask, ret_view_std=False):
        # q [..., S, C]; k [..., S, V, C]; pos [..., S, V, 4]; mask [..., S, V, 1]
        # with ret_view_std also the channel means of masked_view_std(k_fc(k))
        qp = self.q_fc(q)
        kp = self.k_fc(k)
        vp = self.v_fc(kp)
        pos_emb = self.pos_fc(pos)
        logits = self.attn_fc(kp - qp[..., None, :] + pos_emb)
        cnt = mask.sum(dim=-2, keepdim=True)
        eff_mask = torch.where(cnt == 0, torch.ones_like(mask), mask)
        logits = logits.masked_fill(eff_mask == 0, float("-inf"))
        attn = torch.softmax(logits, dim=-2)
        out = self.out_fc(((vp + pos_emb) * attn).sum(dim=-2))
        if not ret_view_std:
            return out
        std, norm_std = masked_view_std(kp, mask)
        return out, std.mean(dim=-1), norm_std.mean(dim=-1)


class ViewTransformer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViewAttention(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim, dim * 4)

    def forward(self, q, k, pos, mask, ret_view_std=False):
        attn = self.attn(self.attn_norm(q), k, pos, mask, ret_view_std)
        x = (attn[0] if ret_view_std else attn) + q
        y = self.ff(self.ff_norm(x)) + x
        return (y, *attn[1:]) if ret_view_std else y


class RayAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int = 4):
        super().__init__()
        self.n_heads = n_heads
        self.q_fc = nn.Linear(dim, dim, bias=False)
        self.k_fc = nn.Linear(dim, dim, bias=False)
        self.v_fc = nn.Linear(dim, dim, bias=False)
        self.out_fc = nn.Linear(dim, dim)

    def forward(self, x):
        hd = x.shape[-1] // self.n_heads

        def split(t):  # [..., S, C] -> [..., H, S, hd]
            return t.reshape(t.shape[:-1] + (self.n_heads, hd)).transpose(-2, -3)

        q, k, v = split(self.q_fc(x)), split(self.k_fc(x)), split(self.v_fc(x))
        attn = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, dim=-1)
        out = (attn @ v).transpose(-2, -3).reshape(x.shape)
        # per-sample weights: head-mean of the first query row
        return self.out_fc(out), attn.mean(dim=-3)[..., 0, :]


class RayTransformer(nn.Module):
    def __init__(self, dim: int, n_heads: int = 4):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = RayAttention(dim, n_heads)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim, dim * 4)

    def forward(self, x):
        y, weights = self.attn(self.attn_norm(x))
        x = x + y
        return x + self.ff(self.ff_norm(x)), weights


class GNT(nn.Module):
    """Per-sample view aggregation + along-ray reasoning (float32).

    ``ret_view_std`` adds the diagnostics to the outputs; the renderer then
    runs this module, the plain network, in place of the hand kernels
    (as the JAX package turns its kernels off for them)."""

    def __init__(self, netwidth: int = 64, depth: int = 8, in_feat_ch: int = 32,
                 ret_view_std: bool = False):
        super().__init__()
        if depth % 2:
            raise ValueError("GNT depth must be even")
        self.netwidth, self.depth, self.in_feat_ch = netwidth, depth, in_feat_ch
        self.ret_view_std = ret_view_std
        self.rgbfeat_fc = nn.Sequential(
            nn.Linear(3 + in_feat_ch, netwidth), nn.ReLU(),
            nn.Linear(netwidth, netwidth),
        )
        self.view_crosstrans = nn.ModuleList(
            ViewTransformer(netwidth) for _ in range(depth)
        )
        self.view_selftrans = nn.ModuleList(
            RayTransformer(netwidth) for _ in range(depth)
        )
        self.q_fcs = nn.ModuleList(
            nn.Sequential(
                nn.Linear(netwidth + 2 * POSENC, netwidth), nn.ReLU(),
                nn.Linear(netwidth, netwidth),
            )
            for _ in range(depth // 2)
        )
        self.norm = nn.LayerNorm(netwidth, eps=1e-6)
        self.rgb_fc = nn.Linear(netwidth, 3)

    def forward(self, rgb_feat, ray_diff, mask, pts, ray_d):
        """rgb_feat [..., S, V, 3+F], ray_diff [..., S, V, 4],
        mask [..., S, V, 1], pts [..., S, 3], ray_d [..., 3] ->
        {"rgb": [..., 3], "weights": [..., S]} and, with ret_view_std,
        "view_std" / "view_std_normalized" [..., S, depth+1]: the channel
        mean of ``masked_view_std`` of the projected features over all views
        (entry 0), then of each view block's keys over the valid views."""
        viewdirs = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
        return self.forward_codes(
            rgb_feat, ray_diff, mask, pts, sinusoidal_embed(viewdirs)
        )

    def forward_codes(self, rgb_feat, ray_diff, mask, pts, view_code, pts_code=None):
        """As ``forward``, with the view-direction embedding
        ``view_code [..., 63]`` given instead of ``ray_d``, and the point
        embedding ``pts_code [..., S, 63]`` given instead of made from
        ``pts`` when it is not None (then ``pts`` is not read)."""
        if pts_code is None:
            pts_code = sinusoidal_embed(pts)
        view_code = view_code[..., None, :].expand(
            pts_code.shape[:-1] + (view_code.shape[-1],)
        )
        h = self.rgbfeat_fc(rgb_feat)
        q = h.max(dim=-2).values
        weights = None
        stds = []
        if self.ret_view_std:
            std, norm_std = masked_view_std(h, torch.ones_like(mask))
            stds.append((std.mean(dim=-1), norm_std.mean(dim=-1)))
        for i in range(self.depth):
            q = self.view_crosstrans[i](q, h, ray_diff, mask, self.ret_view_std)
            if self.ret_view_std:
                q, std, norm_std = q
                stds.append((std, norm_std))
            if i % 2 == 0:
                q = self.q_fcs[i // 2](torch.cat([q, pts_code, view_code], -1))
            q, weights = self.view_selftrans[i](q)
        rgb = self.rgb_fc(self.norm(q).mean(dim=-2))
        out = {"rgb": rgb, "weights": weights}
        if self.ret_view_std:
            out["view_std"] = torch.stack([t[0] for t in stds], dim=-1)
            out["view_std_normalized"] = torch.stack([t[1] for t in stds], dim=-1)
        return out
