"""K1 in its ``patch_rows`` mode — the fused GNT transformer fed raw patch
rows and stencil coefficients, as a hand-written Hopper kernel.

Replaces the TPU kernel ``pgdvs_tpu/kernels/gnt_fused_mono4.py:
gnt_fused_apply_mono4`` called with ``patch_rows`` / ``patch_coef`` (the
in-kernel stencil combine, ``gnt_fused_mono4.py:427-490``):

    gnt_fused_mono4_patch(params, rows [V, R/B, S, n_pos*C] bf16,
                          coef [V, R/4, 4, S, n_pos] bf16, pts [R, S, 3] f32,
                          view_code [R, 63], centers [V+1, 3] f32 (target
                          first), proj [V, 3|4, 4] f32 (K @ w2c), hw=(H, W))
      -> {"rgb": [R, 3], "weights": [R, S] (true sample order),
          "inbound_cnt_raw": [R]}        all float32

B = R / rows.shape[1] rays share a row block: 8 with 24 stencil positions
(4x2 ray blocks, 6x4-pixel rows), 4 with 16 (2x2 blocks, 4x4-pixel rows),
as ``projector.epipolar_sample_patch_raw`` makes them.
Ray r's features at sample s are sum_p rows[v, r // B, s, p*C:(p+1)*C] *
coef[v, r // 4, r % 4, s, p]; from there on it is K1 (``gnt_fused.py``):
validity, ray-diff and point code recomputed, the same network, the same
outputs. Any S, no padding asked of the caller.

What bounds it on the H100: K1's dense products (compute-bound, 1.63 ms per
2048-ray tile at the bf16 peak) plus the combine, 2 * n_pos * C FLOP per
(view, token) on CUDA cores, and its operands: the rows (1.10 GB at the
main tile, 4x2) and coefficients (0.25 GB), against K1's 0.37 GB of sampled
features. The design (``csrc/gnt_fused.cu``, ``k_prologue``'s patch
loader) changes only K1's prologue: a block's item is one row block and
8 / B sample tiles of 16, so it holds the B rays that share the item's rows.
Per view it stages the rows (one contiguous span) and the B rays'
coefficient spans through a 2-stage cp.async ring; each staged row value is
loaded once into float32 and accumulated into the B rays' combined features
(p order), which are rounded to bf16 into the warps' A tiles, and each warp
runs rgbfeat_fc_0/1 and the max-pool over views for one ray's 16 tokens in
mma.sync registers. So a row is read once per view, for all the rays that
share it. The view and ray kernels and their host loop are K1's.
The JAX package composes the combine into rgbfeat_fc_0 with a
tiled weight and an expansion matmul, a TPU layout device; the port packs
K1's weights unchanged (``pack_mono4_weights``).

``gnt_fused_mono4_patch`` runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pgdvs_tpu_torch.kernels.gnt_fused import (
    Mono4Weights,
    check_proj,
    gnt_fused_mono4_plain,
    launch,
)

# (rays per row block, stencil positions) of the two ray-block geometries
PATCH_GEOMETRIES = ((4, 16), (8, 24))


def patch_dims(rows, coef):
    """(V, R, S, C, n_pos, rays per row block) of a rows / coef pair;
    raises unless the pair is one of ``PATCH_GEOMETRIES``."""
    v, nrb, s, cp = rows.shape
    if coef.dim() != 5 or coef.shape[0] != v or coef.shape[2] != 4 or coef.shape[3] != s:
        raise ValueError("coef must be [V, R/4, 4, S, n_pos] beside rows [V, R/B, S, n_pos*C]")
    n_pos = coef.shape[-1]
    r = coef.shape[1] * 4
    if cp % n_pos or r % nrb or (r // nrb, n_pos) not in PATCH_GEOMETRIES:
        raise ValueError(f"unsupported patch geometry: rows {tuple(rows.shape)}, "
                         f"coef {tuple(coef.shape)}")
    return v, r, s, cp // n_pos, n_pos, r // nrb


def patch_combine(rows, coef) -> torch.Tensor:
    """The stencil combine in float32: [V, R, S, C] features, ray r's
    sum_p rows[v, r // B, s, p*C:(p+1)*C] * coef[v, r // 4, r % 4, s, p],
    accumulated in p order."""
    v, r, s, c, n_pos, nb = patch_dims(rows, coef)
    rows = rows.reshape(v, r // nb, 1, s, n_pos, c)
    coef = coef.float().reshape(v, r // nb, nb, s, n_pos)
    out = torch.zeros((v, r // nb, nb, s, c), dtype=torch.float32, device=rows.device)
    for p in range(n_pos):
        out += rows[..., p, :].float() * coef[..., p:p + 1]
    return out.reshape(v, r, s, c)


@torch.no_grad()
def gnt_fused_mono4_patch_plain(gnt, rows, coef, pts, view_code, centers, proj,
                                hw: Tuple[float, float]):
    """The same function in plain torch: the float32 combine, then K1's
    plain version."""
    return gnt_fused_mono4_plain(gnt, patch_combine(rows, coef), pts, view_code,
                                 centers, proj, hw)


def gnt_fused_mono4_patch(params, rows, coef, pts, view_code, centers, proj,
                          hw: Tuple[float, float]):
    """K1's patch_rows mode on the card for CUDA tensors; the plain version
    for CPU tensors.

    params: the ``GNT`` module, or ``Mono4Weights`` packed for the device.
    """
    gnt = params.gnt if isinstance(params, Mono4Weights) else params
    dev = rows.device
    if dev.type == "cpu":
        return gnt_fused_mono4_patch_plain(gnt, rows, coef, pts, view_code, centers,
                                           proj, hw)
    if dev.type != "cuda":
        raise ValueError(f"gnt_fused_mono4_patch: unsupported device {dev}")
    v, r, s, c, n_pos, nb = patch_dims(rows, coef)
    outs = launch("gnt_mono4_patch_forward", params, (rows, coef), (v, r, s, c), pts,
                  view_code, centers, check_proj(proj, v, dev), hw, extra=(n_pos, nb))
    gnt_fused_mono4_patch.launches += 1
    return outs


gnt_fused_mono4_patch.launches = 0
