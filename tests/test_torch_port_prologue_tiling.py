"""The prologue kernel's algorithm (``k_prologue`` in
``pgdvs_tpu_torch/csrc/gnt_fused.cu``) on the CPU.

The kernel cannot run here, so ``_tiled_prologue`` repeats its arithmetic in
float32 torch on the weights as ``pack_mono4_weights`` lays them out for it
(w0 [48, 64] bf16 with zero rows past C = 35, the biases in float32):

- sampled features and quad rows: tiles of 16 tokens over N = R * S (one
  mma m-tile per warp), the ragged last tile's rows past N read as 0 and
  not written; the quad taps combined per element in tap order with the
  zero-pad bilinear weights of frac, in float32, rounded once to bf16;
- patch rows: items of one row block and 8 / B sample tiles of 16 (the B
  rays that share the block's rows), each staged row value accumulated into
  the B rays' features in stencil order, rounded once to bf16; warp w takes
  ray w % B and sample tile w / B; a tile past S does nothing and a ragged
  one writes its rows below S only;
- per view, fc_0 with the bias as the accumulators' start, relu rounded to
  bf16, fc_1 likewise, h rounded to bf16; q the max over views of h.

It is held to ``prologue_plain`` (h and q within one bf16 ulp of relative
error plus 0.01, ``chip_smoke.PRO_TOL``) and to the JAX package's
``rgbfeat_fc_0/1`` and max over views (``pgdvs_tpu/models/gnt/network.py:
308-310``: flax ``nn.Dense`` at the JAX GNT's bf16 dtype on its own
parameters) on the same numpy-seeded features, within K1's bound for its
bf16 paths (atol / rtol 0.02, ``tests/test_torch_port_kernel.py``). Cases:
both patch geometries, S = 23, V = 1 and 10, N not a multiple of 8, row
stride C and C + 1, the quad-rows loader.
"""

import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu_torch.kernels.gnt_fused import pack_mono4_weights
from pgdvs_tpu_torch.kernels.gnt_prologue import (
    gnt_prologue, prologue_features, prologue_plain,
)
from pgdvs_tpu_torch.models.gnt.network import GNT
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict

TILE = 16       # PT in the .cu
WARPS = 8       # PRO_WARPS
C = 35
PRO_TOL = {"atol": 0.01, "rtol": 2.0 ** -7}  # chip_smoke.PRO_TOL
JAX_TOL = 0.02  # K1's bf16 bound

# (source, row stride or (rays per row block, n_pos), V, R, S); N = R * S
CASES = [
    ("rgb_feat", 35, 1, 5, 23),
    ("rgb_feat", 36, 10, 5, 23),
    ("patch", (4, 16), 1, 12, 23),
    ("patch", (4, 16), 10, 12, 23),
    ("patch", (8, 24), 1, 16, 23),
    ("patch", (8, 24), 10, 8, 23),
    ("quad_rows", None, 1, 5, 23),
    ("quad_rows", None, 10, 3, 23),
]


def _bf(x):
    return x.to(torch.bfloat16).float()


def _operands(source, geom, v, r, s, seed):
    """numpy-seeded operands of ``gnt_prologue`` (bf16 tensors, f32 frac),
    features of std 4 so that h reaches past 1 with the JAX GNT's initial
    weights."""
    rng = np.random.default_rng(seed)

    def b16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    if source == "rgb_feat":
        return {"rgb_feat": b16(rng.normal(0, 4, (v, r, s, geom)))}
    if source == "patch":
        nb, n_pos = geom
        coef = rng.uniform(size=(v, r // 4, 4, s, n_pos))
        return {"rows": b16(rng.normal(0, 4, (v, r // nb, s, n_pos * C))),
                "coef": b16(coef / coef.sum(-1, keepdims=True))}
    return {"rows": b16(rng.normal(0, 4, (v, r, s, 4 * C))),
            "frac": torch.from_numpy(rng.uniform(-0.6, 1.6, (v, r, s, 2)).astype(np.float32))}


@torch.no_grad()
def _tiled_prologue(w, source, v, r, s, rgb_feat=None, rows=None, coef=None, frac=None):
    """h [V, N, 64] (bf16 values) and q [N, 64] as ``k_prologue`` computes
    them from ``w`` = (w0 [Cp, 64], b0, w1 [64, 64], b1) as packed."""
    w0, b0, w1, b1 = (t.float() for t in w)
    cp, n = w0.shape[0], r * s
    h = torch.full((v, n, 64), math.nan)
    q = torch.full((n, 64), math.nan)

    def products(x):  # the A tile [16, Cp] (bf16 values) -> h rows
        t = _bf(torch.relu(b0 + x @ w0))
        return _bf(b1 + t @ w1)

    if source == "patch":
        nb, n_pos = r // rows.shape[1], coef.shape[-1]
        tpi = WARPS // nb
        groups = -(-(-(-s // TILE)) // tpi)
        rf, cf = rows.float(), coef.float().reshape(v, r, s, n_pos)
        for rb in range(r // nb):
            for grp in range(groups):
                sb = grp * TILE * tpi
                ns = min(TILE * tpi, s - sb)
                qm = torch.full((WARPS, TILE, 64), -math.inf)
                for vv in range(v):
                    acc = torch.zeros(nb, TILE * tpi, cp)  # the block's combine
                    for p in range(n_pos):
                        x = rf[vv, rb, sb:sb + ns, p * C:(p + 1) * C]
                        k = cf[vv, rb * nb:(rb + 1) * nb, sb:sb + ns, p]
                        acc[:, :ns, :C] += x[None] * k[..., None]
                    tiles = _bf(acc)
                    for warp in range(WARPS):
                        ri, jt = warp % nb, warp // nb
                        s0 = sb + jt * TILE
                        nrows = max(0, min(TILE, s - s0))
                        if nrows == 0:
                            continue
                        hv = products(tiles[ri, jt * TILE:(jt + 1) * TILE])
                        qm[warp] = torch.maximum(qm[warp], hv)
                        n0 = (rb * nb + ri) * s + s0
                        h[vv, n0:n0 + nrows] = hv[:nrows]
                for warp in range(WARPS):
                    ri, jt = warp % nb, warp // nb
                    s0 = sb + jt * TILE
                    nrows = max(0, min(TILE, s - s0))
                    n0 = (rb * nb + ri) * s + s0
                    q[n0:n0 + nrows] = qm[warp, :nrows]
        return h, q

    feats = None if rgb_feat is None else rgb_feat.float().reshape(v, n, -1)
    taps = None if rows is None else rows.float().reshape(v, n, 4, C)
    fr = None if frac is None else frac.float().reshape(v, n, 2)
    for n0 in range(0, n, TILE):
        nrows = min(TILE, n - n0)
        qm = torch.full((TILE, 64), -math.inf)
        for vv in range(v):
            x = torch.zeros(TILE, cp)
            if feats is not None:
                x[:nrows, :C] = feats[vv, n0:n0 + nrows, :C]
            else:
                f = fr[vv, n0:n0 + nrows]
                wx = [torch.clamp(1.0 - torch.abs(f[:, 0] - d), min=0.0) for d in (0.0, 1.0)]
                wy = [torch.clamp(1.0 - torch.abs(f[:, 1] - d), min=0.0) for d in (0.0, 1.0)]
                wts = (wx[0] * wy[0], wx[1] * wy[0], wx[0] * wy[1], wx[1] * wy[1])
                acc = torch.zeros(nrows, C)
                for k in range(4):
                    acc += taps[vv, n0:n0 + nrows, k] * wts[k][:, None]
                x[:nrows, :C] = _bf(acc)
            hv = products(x)
            qm = torch.maximum(qm, hv)
            h[vv, n0:n0 + nrows] = hv[:nrows]
        q[n0:n0 + nrows] = qm[:nrows]
    return h, q


@pytest.fixture(scope="module")
def gnts():
    """The JAX package's GNT (random init, bf16) and the port's with its
    weights."""
    rng = np.random.default_rng(0)
    gnt_j = JGNT(netwidth=64, depth=8, in_feat_ch=32, dtype="bfloat16", ret_view_std=False)
    params = gnt_j.init(
        jax.random.PRNGKey(2),
        rng.normal(size=(2, 4, 3, 35)).astype(np.float32),
        rng.normal(size=(2, 4, 3, 4)).astype(np.float32),
        np.ones((2, 4, 3, 1), np.float32),
        rng.normal(size=(2, 4, 3)).astype(np.float32),
        rng.normal(size=(2, 3)).astype(np.float32),
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    gnt = GNT().eval()
    gnt.load_state_dict(gnt_state_dict(params))
    return params, gnt


def _assert_close(got, ref, atol, rtol):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    err = (got - ref).abs()
    assert bool((err <= atol + rtol * ref.abs()).all()), float(err.max())


def _case_id(case):
    source, geom, v, r, s = case
    g = "" if geom is None else (f"_ld{geom}" if source == "rgb_feat" else f"_nb{geom[0]}")
    return f"{source}{g}_v{v}_n{r * s}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tiled_prologue_matches_plain(gnts, case):
    _params, gnt = gnts
    source, geom, v, r, s = case
    ops = _operands(source, geom, v, r, s, seed=v * 100 + r)
    w = pack_mono4_weights(gnt, "cpu").tensors[:4]
    h, q = _tiled_prologue(w, source, v, r, s, **ops)
    ref_h, ref_q = prologue_plain(gnt, prologue_features(C, **ops))
    assert float(ref_h.float().abs().max()) > 1.0
    _assert_close(h, ref_h, **PRO_TOL)
    _assert_close(q, ref_q, **PRO_TOL)
    # the wrapper on CPU tensors is the plain version
    got_h, got_q = gnt_prologue(gnt, **ops)
    assert torch.equal(got_h, ref_h) and torch.equal(got_q, ref_q)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tiled_prologue_matches_jax(gnts, case):
    """Against flax's ``rgbfeat_fc_0`` / ``rgbfeat_fc_1`` at the JAX GNT's
    bf16 dtype and the max over views, on the same features (the patch and
    quad combines in float32)."""
    params, gnt = gnts
    source, geom, v, r, s = case
    ops = _operands(source, geom, v, r, s, seed=v * 100 + r + 1)
    feats = prologue_features(C, **ops).numpy()         # [V, N, C]
    p = params["params"]
    dense = nn.Dense(64, dtype=jnp.bfloat16)
    hj = dense.apply({"params": p["rgbfeat_fc_0"]}, jnp.asarray(feats))
    hj = dense.apply({"params": p["rgbfeat_fc_1"]}, nn.relu(hj))
    qj = jnp.max(hj, axis=0)
    ref_h = torch.from_numpy(np.array(hj.astype(jnp.float32)))
    ref_q = torch.from_numpy(np.array(qj.astype(jnp.float32)))
    w = pack_mono4_weights(gnt, "cpu").tensors[:4]
    h, q = _tiled_prologue(w, source, v, r, s, **ops)
    _assert_close(h, ref_h, JAX_TOL, JAX_TOL)
    _assert_close(q, ref_q, JAX_TOL, JAX_TOL)


def test_patch_items_cover_every_token_once():
    """Both geometries at S = 23 and 40: the items' warp tiles write every
    token of every view exactly once (h and q start as NaN)."""
    gnt = GNT().eval()
    w = pack_mono4_weights(gnt, "cpu").tensors[:4]
    for nb, n_pos in ((4, 16), (8, 24)):
        for s in (23, 40):
            ops = _operands("patch", (nb, n_pos), 2, 8, s, seed=s)
            h, q = _tiled_prologue(w, "patch", 2, 8, s, **ops)
            assert bool(torch.isfinite(h).all()) and bool(torch.isfinite(q).all())
