"""The GNT prologue alone, the first kernel of every whole forward (K1 on
both contracts, K2 in every mode), on the card for tests and timing.

Replaces the head of the TPU kernels ``pgdvs_tpu/kernels/gnt_fused_mono4.py:
gnt_fused_apply_mono4`` and ``gnt_fused_mono3.py: gnt_fused_apply_mono3``
(rgbfeat_fc_0/1 and the max-pool over views, ``pgdvs_tpu/models/gnt/
network.py:308-310``), with the feature source of each contract:

    gnt_prologue(params, rgb_feat=None, *, rows=None, coef=None, frac=None)
      rgb_feat [V, R, S, C or C+1] bf16 (sampled features; a trailing
               validity channel is not read), or
      rows [V, R/B, S, n_pos*C] + coef [V, R/4, 4, S, n_pos] bf16 (K1's
               patch rows, ``gnt_fused_patch.PATCH_GEOMETRIES``), or
      rows [V, R, S, 4C] bf16 + frac [V, R, S, 2] (K2 fold_lerp's raw quad
               rows)
      -> (h [V, N, 64] bf16, q [N, 64] f32), N = R * S

Per view token h = bf16(rgbfeat_fc_1(bf16(relu(rgbfeat_fc_0(x))))) with x
the features in bf16 (the patch or quad combine accumulated in float32 and
rounded once), the weight matrices in bf16 and the biases in float32; q is
the max of h over the views. The kernel is ``k_prologue`` in
``csrc/gnt_fused.cu``: bound by bytes (the features read once, h and q
written once), it stages w0 / w1 once per block of a persistent grid, runs
both layers in mma.sync registers, and on patch rows reads each row once per
view for all the rays that share it.

The render path does not call this wrapper: the whole forwards launch the
same kernel. ``gnt_prologue.launches[source]`` counts launches per source
(``PROLOGUE_SOURCES``). ``gnt_prologue`` runs the plain version (``prologue_plain`` on
``prologue_features``) only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch

from pgdvs_tpu_torch.kernels.gnt_fused import (
    NW, Mono4Weights, aligned16, prepare_forward,
)
from pgdvs_tpu_torch.kernels.gnt_fused_mono3 import quad_lerp
from pgdvs_tpu_torch.kernels.gnt_fused_patch import patch_combine, patch_dims

# the kernel's feature sources (PSRC_* in the .cu)
PROLOGUE_SOURCES = {"rgb_feat": 0, "patch": 1, "quad_rows": 2}


def prologue_source(c, rgb_feat=None, rows=None, coef=None, frac=None):
    """(source name, (V, R, S), extra ints (row stride, n_pos, rays per row
    block)) of one call at C channels; raises on operands no source takes."""
    with_rows = rows is not None and (coef is None) != (frac is None)
    with_feats = rgb_feat is not None and rows is None and coef is None and frac is None
    if not (with_rows or with_feats):
        raise ValueError("give rgb_feat, or rows with coef (patch) or with frac (quad rows)")
    if rgb_feat is not None:
        v, r, s, ld = rgb_feat.shape
        if ld not in (c, c + 1):
            raise ValueError(f"rgb_feat has {ld} channels, the GNT takes {c} (+1 validity)")
        return "rgb_feat", (v, r, s), (ld, 0, 1)
    if coef is not None:
        v, r, s, cc, n_pos, nb = patch_dims(rows, coef)
        if cc != c:
            raise ValueError(f"patch rows have {cc} channels, the GNT takes {c}")
        return "patch", (v, r, s), (c, n_pos, nb)
    v, r, s, ch = rows.shape
    if ch != 4 * c or frac.shape != (v, r, s, 2):
        raise ValueError(f"quad rows must be [V, R, S, {4 * c}] beside frac [V, R, S, 2]")
    return "quad_rows", (v, r, s), (c, 0, 1)


def prologue_features(c, rgb_feat=None, rows=None, coef=None, frac=None) -> torch.Tensor:
    """The features [V, N, C] in float32 that a call's source gives: the
    sampled features' first C channels, the patch combine or the quad
    combine (float32, p order)."""
    name, (v, r, s), _ = prologue_source(c, rgb_feat, rows, coef, frac)
    if name == "rgb_feat":
        x = rgb_feat[..., :c].float()
    elif name == "patch":
        x = patch_combine(rows, coef)
    else:
        x = quad_lerp(rows, frac)
    return x.reshape(v, r * s, c)


@torch.no_grad()
def prologue_plain(gnt, feats) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prologue in plain torch: feats [V, N, C] -> (h [V, N, 64] bf16,
    q [N, 64] f32), with the kernel's roundings (features, weights and the
    hidden layer in bf16, biases and sums in float32)."""
    fc0, fc1 = gnt.rgbfeat_fc[0], gnt.rgbfeat_fc[2]

    def bf(x):
        return x.detach().to(device=feats.device).to(torch.bfloat16).float()

    x = bf(feats)
    t = bf(torch.relu(x @ bf(fc0.weight.T) + fc0.bias.detach().float().to(x.device)))
    h = (t @ bf(fc1.weight.T) + fc1.bias.detach().float().to(x.device)).to(torch.bfloat16)
    return h, h.float().amax(0)


def gnt_prologue(params, rgb_feat=None, *, rows=None, coef=None, frac=None):
    """The prologue on the card for CUDA tensors; the plain version for CPU
    tensors. params: the ``GNT`` module, or ``Mono4Weights`` packed for the
    device (its first four tensors: w0 [Cp, 64] bf16, b0, w1, b1)."""
    gnt = params.gnt if isinstance(params, Mono4Weights) else params
    c = 3 + gnt.in_feat_ch
    name, (v, r, s), (ld, n_pos, nb) = prologue_source(c, rgb_feat, rows, coef, frac)
    data = rgb_feat if rgb_feat is not None else rows
    dev = data.device
    if dev.type == "cpu":
        return prologue_plain(gnt, prologue_features(c, rgb_feat, rows, coef, frac))
    if dev.type != "cuda":
        raise ValueError(f"gnt_prologue: unsupported device {dev}")
    if data.dtype != torch.bfloat16 or (coef is not None and coef.dtype != torch.bfloat16):
        raise ValueError("the kernel's feature operands must be bfloat16")
    second = coef if coef is not None else (None if frac is None else frac.float())
    if second is not None and second.device != dev:
        raise ValueError("all operands must be on the same device")
    lib, packed = prepare_forward(params, dev, v)
    # the patch loader streams rows and coefficients in 16-byte chunks; the
    # other loaders take any alignment
    fit = aligned16 if name == "patch" else torch.Tensor.contiguous
    a = fit(data)
    b = None if second is None else fit(second)
    h = torch.empty((v, r * s, NW), dtype=torch.bfloat16, device=dev)
    q = torch.empty((r * s, NW), dtype=torch.float32, device=dev)
    err = lib.gnt_prologue_forward(
        PROLOGUE_SOURCES[name], a.data_ptr(), 0 if b is None else b.data_ptr(), ld, v, r, s,
        c, packed.cp, n_pos, nb, *[t.data_ptr() for t in packed.tensors[:4]],
        h.data_ptr(), q.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gnt_prologue_forward launch failed: cudaError {err}")
    gnt_prologue.launches[name] += 1
    return h, q


gnt_prologue.launches = collections.Counter()

