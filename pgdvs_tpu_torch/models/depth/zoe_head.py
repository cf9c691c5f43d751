"""ZoeDepth metric-bins heads in torch.

Counterpart of ``pgdvs_tpu.models.depth.zoe_head`` (Bhat et al., arXiv
2302.12288):

  * the structural heads (``SeedBinRegressor``, ``inverse_attractor``,
    ``AttractorLayer``, ``LogBinomial``, ``MetricBinsHead``,
    ``SmallDepthBackbone``, ``ZoeDepthModel``): channel-last [H, W, C]
    tensors without a batch, as in the JAX package, submodules named as
    its flax scopes (``params_from_jax.structural_state_dict`` carries its
    params over); the convolutions pad as flax's "SAME" does (stride 2 on
    an even size pads one row and column after, none before), and the
    resizes are ``jax.image.resize``'s bilinear (``core.interpolate
    .resize_axes``: across channels too where JAX resizes them);
  * the checkpoint-faithful heads of the released ``ZoeD_M12_{N,K,NK}.pt``
    (``ZoeSeedBinRegressor``, ``ZoeProjector``, ``ZoeAttractor``,
    ``ZoeConditionalLogBinomial``, ``ZoeMetricHeadSingle``,
    ``ZoeTransformerEncoderLayer``, ``ZoePatchTransformer``,
    ``ZoeMetricHeadMulti``): NCHW with a batch, submodules named as the
    checkpoint's keys (``seed_bin_regressor._net.0``, ``attractors.nyu.3``,
    ``patch_transformer.transformer_encoder.layers.0.self_attn`` ...).

The released checkpoints' quirks are kept as the JAX package keeps them:
the inverse attractor with its default alpha 300 / gamma 2 (the config's
1000 never reaches it); every resize bilinear with align_corners=True; the
log-binomial's Stirling log-choose with eps 1e-7 and p clamped to
[1e-4, 1]; the NK head's attractors with 16 points each; layer norms of
the patch transformer with flax's eps 1e-6. ``ZoeMetricHeadMulti``
computes both domains and keeps, per item, the one its classifier picks.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pgdvs_tpu_torch.core.interpolate import resize_axes


def _same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on NCHW with flax's "SAME" padding (the extra row and
    column, when the total is odd, after)."""
    pads = []
    for size, k, s in zip(x.shape[:1:-1], conv.kernel_size[::-1], conv.stride[::-1]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads))


class SeedBinRegressor(nn.Module):
    """Per-pixel seed bin centers (sorted ascending) from bottleneck
    features: n_bins positive widths (softplus + eps) spanning
    [min_depth, max_depth], centers at cumulative midpoints."""

    def __init__(self, in_features: int, n_bins: int = 64, min_depth: float = 1e-3,
                 max_depth: float = 10.0, hidden: int = 128):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, n_bins)

    def forward(self, feat):
        w = F.softplus(self.fc2(F.relu(self.fc1(feat)))) + 1e-3
        w = w / torch.sum(w, dim=-1, keepdim=True)
        w = w * (self.max_depth - self.min_depth)
        edges = self.min_depth + torch.cumsum(w, dim=-1)
        return edges - 0.5 * w


def inverse_attractor(delta, alpha: float = 300.0, gamma: int = 2):
    """dc = delta / (1 + alpha * |delta|^gamma) — the 'inv' attractor."""
    return delta / (1.0 + alpha * torch.abs(delta) ** gamma)


class AttractorLayer(nn.Module):
    """Bin centers pulled toward n_attractors predicted depth points,
    clipped to [min_depth, max_depth]."""

    def __init__(self, in_features: int, n_attractors: int = 16, min_depth: float = 1e-3,
                 max_depth: float = 10.0, alpha: float = 300.0, gamma: int = 2,
                 hidden: int = 128):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.alpha, self.gamma = alpha, gamma
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, n_attractors)

    def forward(self, feat, centers):
        a = F.softplus(self.fc2(F.relu(self.fc1(feat)))) + 1e-3
        a = self.min_depth + (self.max_depth - self.min_depth) * (a / (1.0 + a))
        delta = a[..., None, :] - centers[..., :, None]  # [..., bins, attractors]
        dc = torch.mean(inverse_attractor(delta, self.alpha, self.gamma), dim=-1)
        return torch.clamp(centers + dc, self.min_depth, self.max_depth)


class LogBinomial(nn.Module):
    """Conditional log-binomial probabilities over the n_bins indices: a
    mode q in (0, 1) and a temperature t > 0 per pixel, log p_k =
    (k log q + (N-1-k) log(1-q) + log C(N-1, k)) / t, softmax over k."""

    def __init__(self, in_features: int, n_bins: int = 64, hidden: int = 128):
        super().__init__()
        self.n_bins = n_bins
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, 2)

    def forward(self, feat):
        qt = self.fc2(F.relu(self.fc1(feat)))
        q = torch.sigmoid(qt[..., 0:1]) * 0.998 + 1e-3
        t = F.softplus(qt[..., 1:2]) + 0.1
        n = float(self.n_bins)
        k = torch.arange(self.n_bins, dtype=torch.float32, device=feat.device)
        log_comb = (torch.lgamma(torch.tensor(n, device=feat.device)) - torch.lgamma(k + 1.0)
                    - torch.lgamma(n - k))
        logits = (log_comb + k * torch.log(q) + (n - 1.0 - k) * torch.log1p(-q)) / t
        return torch.softmax(logits, dim=-1)


class MetricBinsHead(nn.Module):
    """Seed bins + per-scale attractors + log-binomial expectation.

    forward(bottleneck [H, W, C], scale_feats: [Hi, Wi, Ci] coarse -> fine)
    -> (metric depth [Hf, Wf, 1] at the finest scale, the final centers).
    """

    def __init__(self, bottleneck_features: int, scale_features: Sequence[int],
                 n_bins: int = 64, n_attractors: Sequence[int] = (16, 8, 4, 1),
                 min_depth: float = 1e-3, max_depth: float = 10.0):
        super().__init__()
        self.n_bins = n_bins
        self.seed = SeedBinRegressor(bottleneck_features, n_bins, min_depth, max_depth)
        for i, c in enumerate(scale_features):
            self.add_module(f"attractor_{i}", AttractorLayer(
                c, n_attractors[min(i, len(n_attractors) - 1)], min_depth, max_depth))
        self.logbinomial = LogBinomial(scale_features[-1], n_bins)

    def forward(self, bottleneck, scale_feats):
        centers = self.seed(bottleneck)
        for i, feat in enumerate(scale_feats):
            centers = resize_axes(centers, (feat.shape[0], feat.shape[1], self.n_bins))
            centers = getattr(self, f"attractor_{i}")(feat, centers)
        probs = self.logbinomial(scale_feats[-1])
        return torch.sum(probs * centers, dim=-1, keepdim=True), centers


class SmallDepthBackbone(nn.Module):
    """Self-contained conv encoder / decoder: img [H, W, 3] in [0, 1] (H, W
    divisible by 8) -> (rel_depth [H/2, W/2, 1], bottleneck [H/8, W/8, 4w],
    decoder features coarse -> fine)."""

    def __init__(self, width: int = 32):
        super().__init__()
        chans = [width * 2 ** i for i in range(3)]
        for i, (cin, cout) in enumerate(zip([3] + chans[:-1], chans)):
            self.add_module(f"enc{i}", nn.Conv2d(cin, cout, 3, stride=2))
        for i, c in enumerate(chans[::-1]):
            self.add_module(f"dec{i}", nn.Conv2d(c, c, 3))
        self.rel_out = nn.Conv2d(width, 1, 3)

    def forward(self, img):
        x = img.permute(2, 0, 1)[None]
        feats = []
        for i in range(3):
            x = F.relu(_same_conv(getattr(self, f"enc{i}"), x))
            feats.append(x)
        bottleneck = x[0].permute(1, 2, 0)
        dec = []
        for i, f in enumerate(reversed(feats)):
            # JAX resizes to f's whole shape: channels as well
            x = resize_axes(x, f.shape)
            x = F.relu(_same_conv(getattr(self, f"dec{i}"), x + f))
            dec.append(x[0].permute(1, 2, 0))
        rel = F.softplus(_same_conv(self.rel_out, x))[0].permute(1, 2, 0)
        return rel, bottleneck, dec


class ZoeDepthModel(nn.Module):
    """Backbone + metric-bins head -> metric depth [H, W] at input
    resolution."""

    def __init__(self, n_bins: int = 64, min_depth: float = 1e-3, max_depth: float = 10.0,
                 width: int = 32):
        super().__init__()
        self.backbone = SmallDepthBackbone(width)
        chans = [width * 4, width * 2, width]
        self.head = MetricBinsHead(width * 4, chans, n_bins, min_depth=min_depth,
                                   max_depth=max_depth)

    def forward(self, img):
        _rel, bottleneck, feats = self.backbone(img)
        depth, _centers = self.head(bottleneck, feats)
        return resize_axes(depth, (img.shape[0], img.shape[1], 1))[..., 0]


# ---------------------------------------------------------------------------
# Checkpoint-faithful heads (the isl-org ZoeD_M12_* layout), NCHW
# ---------------------------------------------------------------------------


def _interp_ac(x, h, w):
    """F.interpolate(mode='bilinear', align_corners=True) of NCHW to (h, w)."""
    if x.shape[-2] == h and x.shape[-1] == w:
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def _mlp(cin: int, mid: int, cout: int) -> nn.Sequential:
    """``_net = Sequential(Conv1x1, ReLU, Conv1x1)``."""
    return nn.Sequential(nn.Conv2d(cin, mid, 1), nn.ReLU(), nn.Conv2d(mid, cout, 1))


class ZoeSeedBinRegressor(nn.Module):
    """``SeedBinRegressor[Unnormed]``: conv1x1 -> ReLU -> conv1x1 (+ act).

    normed=False ("softplus" bin centers, every released ZoeD_M12): the
    centers are the softplus activations. normed=True: ReLU widths
    normalized to span [min_depth, max_depth]. Returns
    (bins_for_attractors, bin_centers), bins on dim 1.
    """

    def __init__(self, in_features: int, n_bins: int, mlp_dim: int = 256,
                 min_depth: float = 1e-3, max_depth: float = 10.0, normed: bool = False):
        super().__init__()
        self.min_depth, self.max_depth, self.normed = min_depth, max_depth, normed
        self._net = _mlp(in_features, mlp_dim, n_bins)

    def forward(self, x):
        y = self._net(x)
        if not self.normed:
            c = F.softplus(y)
            return c, c
        w = F.relu(y) + 1e-3
        w_normed = w / torch.sum(w, dim=1, keepdim=True)
        widths = (self.max_depth - self.min_depth) * w_normed
        first = torch.full_like(widths[:, :1], self.min_depth)
        edges = torch.cumsum(torch.cat([first, widths], dim=1), dim=1)
        return w_normed, 0.5 * (edges[:, :-1] + edges[:, 1:])


class ZoeProjector(nn.Module):
    """``Projector``: conv1x1 -> ReLU -> conv1x1."""

    def __init__(self, in_features: int, out_features: int, mlp_dim: int = 128):
        super().__init__()
        self._net = _mlp(in_features, mlp_dim, out_features)

    def forward(self, x):
        return self._net(x)


class ZoeAttractor(nn.Module):
    """``AttractorLayer[Unnormed]`` as the released checkpoints run it: the
    MLP reads the bin embedding plus the resized previous embedding; the
    inverse attractor runs with alpha 300 / gamma 2. normed=True predicts
    pairs and keeps channel 0 of each (the original's bug), then rescales
    to [min_depth, max_depth], sorts and clips."""

    def __init__(self, in_features: int, n_attractors: int, min_depth: float = 1e-3,
                 max_depth: float = 10.0, kind: str = "mean", mlp_dim: int = 128,
                 normed: bool = False):
        super().__init__()
        self.n_attractors = n_attractors
        self.min_depth, self.max_depth = min_depth, max_depth
        self.kind, self.normed = kind, normed
        self._net = _mlp(in_features, mlp_dim, n_attractors * (2 if normed else 1))

    def forward(self, x, prev_bin, prev_bin_embedding=None):
        b, _, h, w = x.shape
        if prev_bin_embedding is not None:
            x = x + _interp_ac(prev_bin_embedding, h, w)
        y = self._net(x)
        if self.normed:
            a = (F.relu(y) + 1e-3).view(b, self.n_attractors, 2, h, w)[:, :, 0]
        else:
            a = F.softplus(y)
        centers = _interp_ac(prev_bin, h, w)
        delta = inverse_attractor(a[:, None] - centers[:, :, None])  # [B, bins, attr, h, w]
        new_centers = centers + (torch.mean(delta, dim=2) if self.kind == "mean"
                                 else torch.sum(delta, dim=2))
        if self.normed:
            scaled = (self.max_depth - self.min_depth) * new_centers + self.min_depth
            scaled = torch.clamp(torch.sort(scaled, dim=1).values, self.min_depth, self.max_depth)
            return new_centers, scaled
        return new_centers, new_centers


class ZoeConditionalLogBinomial(nn.Module):
    """``ConditionalLogBinomial``: conv1x1 -> GELU -> conv1x1 -> softplus
    predicting two normalized pairs (probability, temperature), then the
    log-binomial softmax over the bins (dim 1)."""

    def __init__(self, in_features: int, n_classes: int, bottleneck: int,
                 min_temp: float = 0.0212, max_temp: float = 50.0):
        super().__init__()
        self.n_classes = n_classes
        self.min_temp, self.max_temp = min_temp, max_temp
        self.mlp = nn.Sequential(nn.Conv2d(in_features, bottleneck, 1), nn.GELU(),
                                 nn.Conv2d(bottleneck, 4, 1), nn.Softplus())

    def forward(self, main, cond):
        pt = self.mlp(torch.cat([main, cond], dim=1))
        eps = 1e-4
        p = pt[:, 0:2] + eps
        p = p[:, 0] / (p[:, 0] + p[:, 1])
        t = pt[:, 2:4] + eps
        t = t[:, 0] / (t[:, 0] + t[:, 1])
        t = (self.max_temp - self.min_temp) * t + self.min_temp

        # Stirling log-choose over the bin indices, in float32 throughout as
        # the JAX package evaluates it (n - 1 + 1e-7 rounds to n - 1)
        n = float(self.n_classes)
        f32 = dict(dtype=torch.float32, device=main.device)
        k = torch.arange(self.n_classes, **f32)[None, :, None, None]
        beps = 1e-7
        nn_ = torch.tensor((n - 1.0) + beps, **f32)
        kk = k + beps
        log_comb = (nn_ * torch.log(nn_) - kk * torch.log(kk)
                    - (nn_ - kk) * torch.log(nn_ - kk + beps))
        pc = torch.clamp(p, eps, 1.0)[:, None]
        omp = torch.clamp(1.0 - p, eps, 1.0)[:, None]
        y = log_comb + k * torch.log(pc) + ((n - 1.0) - k) * torch.log(omp)
        return torch.softmax(y / t[:, None], dim=1)


class ZoeMetricHeadSingle(nn.Module):
    """``zoedepth.py``'s single metric head (ZoeD_M12_N / _K).

    forward(outconv_activation [B, 32, H, W], bottleneck [B, C, h, w],
    features r4..r1 coarse -> fine, rel_depth [B, H', W']) -> metric depth
    [B, 1, H, W]. ``bottleneck_features`` is C, the channels of the
    bottleneck and of the features.
    """

    def __init__(self, n_bins: int = 64, min_depth: float = 1e-3, max_depth: float = 10.0,
                 bin_embedding_dim: int = 128, n_attractors: Sequence[int] = (16, 8, 4, 1),
                 seed_mlp_dim: int = 256, num_relative_features: int = 32,
                 min_temp: float = 0.0212, max_temp: float = 50.0, normed: bool = False,
                 attractor_kind: str = "mean", bottleneck_features: int = 256):
        super().__init__()
        self.min_depth, self.max_depth, self.normed = min_depth, max_depth, normed
        btl, emb = bottleneck_features, bin_embedding_dim
        self.conv2 = nn.Conv2d(btl, btl, 1)
        self.seed_bin_regressor = ZoeSeedBinRegressor(btl, n_bins, seed_mlp_dim, min_depth,
                                                      max_depth, normed)
        self.seed_projector = ZoeProjector(btl, emb)
        self.projectors = nn.ModuleList(ZoeProjector(btl, emb) for _ in n_attractors)
        self.attractors = nn.ModuleList(
            ZoeAttractor(emb, n, min_depth, max_depth, kind=attractor_kind, mlp_dim=emb,
                         normed=normed) for n in n_attractors)
        last_in = num_relative_features + 1
        self.conditional_log_binomial = ZoeConditionalLogBinomial(
            last_in + emb, n_bins, bottleneck=(last_in + emb) // 2, min_temp=min_temp,
            max_temp=max_temp)

    def forward(self, outconv_activation, bottleneck, features, rel_depth):
        x = self.conv2(bottleneck)
        _, seed_centers = self.seed_bin_regressor(x)
        prev_bin = ((seed_centers - self.min_depth) / (self.max_depth - self.min_depth)
                    if self.normed else seed_centers)
        prev_emb = self.seed_projector(x)
        for projector, attractor, feat in zip(self.projectors, self.attractors, features):
            emb = projector(feat)
            prev_bin, centers = attractor(emb, prev_bin, prev_emb)
            prev_emb = emb
        h, w = outconv_activation.shape[-2:]
        last = torch.cat([outconv_activation, _interp_ac(rel_depth[:, None], h, w)], dim=1)
        probs = self.conditional_log_binomial(last, _interp_ac(prev_emb, h, w))
        return torch.sum(probs * _interp_ac(centers, h, w), dim=1, keepdim=True)


class _PackedAttention(nn.Module):
    """``nn.MultiheadAttention``'s packed parameters (in_proj_weight
    [3E, E], in_proj_bias, out_proj)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)


class ZoeTransformerEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (post-norm, ReLU) over tokens
    [B, S, E], with the JAX package's layer norm eps (1e-6)."""

    def __init__(self, hidden: int = 128, heads: int = 4, intermediate: int = 1024):
        super().__init__()
        self.heads = heads
        self.self_attn = _PackedAttention(hidden)
        self.linear1 = nn.Linear(hidden, intermediate)
        self.linear2 = nn.Linear(intermediate, hidden)
        self.norm1 = nn.LayerNorm(hidden, eps=1e-6)
        self.norm2 = nn.LayerNorm(hidden, eps=1e-6)

    def forward(self, tokens):
        b, s, e = tokens.shape
        hd = e // self.heads
        qkv = F.linear(tokens, self.self_attn.in_proj_weight, self.self_attn.in_proj_bias)
        q, k, v = qkv.view(b, s, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        ctx = self.self_attn.out_proj((att @ v).transpose(1, 2).reshape(b, s, e))
        x = self.norm1(tokens + ctx)
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class ZoePatchTransformer(nn.Module):
    """``PatchTransformerEncoder(use_class_token=True)``: conv1x1 token
    embedding, a zero class token in front, the concatenated sin | cos 1-d
    positional encoding, 4 post-norm encoder layers. Returns [B, S, E]."""

    def __init__(self, in_features: int, hidden: int = 128, heads: int = 4,
                 intermediate: int = 1024, layers: int = 4):
        super().__init__()
        self.embedding_convPxP = nn.Conv2d(in_features, hidden, 1)
        self.transformer_encoder = nn.Module()
        self.transformer_encoder.layers = nn.ModuleList(
            ZoeTransformerEncoderLayer(hidden, heads, intermediate) for _ in range(layers))

    def forward(self, x):
        tokens = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        tokens = torch.cat([torch.zeros_like(tokens[:, :1]), tokens], dim=1)
        s, e = tokens.shape[1:]
        f32 = dict(dtype=torch.float32, device=x.device)
        pos = torch.arange(s, **f32)[:, None]
        idx = torch.arange(0, e, 2, **f32)[None, :]
        div = torch.exp(idx * (-torch.log(torch.tensor(10000.0, **f32)) / e))
        pe = pos * div
        tokens = tokens + torch.cat([torch.sin(pe), torch.cos(pe)], dim=1)
        for layer in self.transformer_encoder.layers:
            tokens = layer(tokens)
        return tokens


class ZoeMetricHeadMulti(nn.Module):
    """``zoedepth_nk.py``'s two-domain metric head (ZoeD_M12_NK).

    A patch transformer's class token picks the domain; each domain has
    its seed regressor, attractors and conditional log-binomial, the seed
    and scale projectors are shared. Both domains are computed and each
    item keeps the one its logits pick (argmax, the first on a tie), as the
    JAX package's static-shape select does. The NK head reads no relative
    depth, uses mlp_dim = bin_embedding_dim // 2 for the projectors and the
    seed regressors and a bottleneck factor 4 in the log-binomial; every
    attractor has 16 points (the original passes n_attractors[i] into the
    attractor's n_bins slot, so ``n_attractors`` goes unused).

    Returns (depth [B, 1, H, W], domain_logits [B, 2]).
    """

    def __init__(self, bin_confs: Sequence[dict] = (
            {"name": "nyu", "n_bins": 64, "min_depth": 1e-3, "max_depth": 10.0},
            {"name": "kitti", "n_bins": 64, "min_depth": 1e-3, "max_depth": 80.0}),
            bin_embedding_dim: int = 128, n_attractors: Sequence[int] = (16, 8, 4, 1),
            num_relative_features: int = 32, min_temp: float = 0.0212,
            max_temp: float = 50.0, normed: bool = False, attractor_kind: str = "mean",
            patch_transformer_hidden: int = 128, patch_transformer_intermediate: int = 1024,
            bottleneck_features: int = 256):
        super().__init__()
        self.bin_confs = [dict(c) for c in bin_confs]
        self.normed = normed
        btl, emb, hid = bottleneck_features, bin_embedding_dim, patch_transformer_hidden
        self.conv2 = nn.Conv2d(btl, btl, 1)
        self.patch_transformer = ZoePatchTransformer(
            btl, hid, intermediate=patch_transformer_intermediate)
        self.mlp_classifier = nn.Sequential(nn.Linear(hid, hid), nn.ReLU(), nn.Linear(hid, 2))
        self.seed_projector = ZoeProjector(btl, emb, mlp_dim=emb // 2)
        self.projectors = nn.ModuleList(ZoeProjector(btl, emb, mlp_dim=emb // 2)
                                        for _ in range(4))
        self.seed_bin_regressors = nn.ModuleDict()
        self.attractors = nn.ModuleDict()
        self.conditional_log_binomial = nn.ModuleDict()
        for c in self.bin_confs:
            name, nb, mind, maxd = c["name"], c["n_bins"], c["min_depth"], c["max_depth"]
            self.seed_bin_regressors[name] = ZoeSeedBinRegressor(
                btl, nb, mlp_dim=emb // 2, min_depth=mind, max_depth=maxd, normed=normed)
            self.attractors[name] = nn.ModuleList(
                ZoeAttractor(emb, 16, mind, maxd, kind=attractor_kind, mlp_dim=emb,
                             normed=normed) for _ in range(4))
            self.conditional_log_binomial[name] = ZoeConditionalLogBinomial(
                num_relative_features + emb, nb,
                bottleneck=(num_relative_features + emb) // 4, min_temp=min_temp,
                max_temp=max_temp)

    def forward(self, outconv_activation, bottleneck, features, rel_depth):
        x = self.conv2(bottleneck)
        cls = self.patch_transformer(x)[:, 0]
        domain_logits = self.mlp_classifier(cls)
        prev_emb0 = self.seed_projector(x)
        embs = [p(f) for p, f in zip(self.projectors, features)]
        h, w = outconv_activation.shape[-2:]
        depths = []
        for c in self.bin_confs:
            name, mind, maxd = c["name"], c["min_depth"], c["max_depth"]
            _, seed_centers = self.seed_bin_regressors[name](x)
            prev_bin = (seed_centers - mind) / (maxd - mind) if self.normed else seed_centers
            prev_emb = prev_emb0
            for attractor, emb in zip(self.attractors[name], embs):
                prev_bin, centers = attractor(emb, prev_bin, prev_emb)
                prev_emb = emb
            probs = self.conditional_log_binomial[name](outconv_activation,
                                                        _interp_ac(prev_emb, h, w))
            depths.append(torch.sum(probs * _interp_ac(centers, h, w), dim=1, keepdim=True))
        pick = torch.argmax(domain_logits, dim=-1)[:, None, None, None]
        return torch.where(pick == 0, depths[0], depths[1]), domain_logits
