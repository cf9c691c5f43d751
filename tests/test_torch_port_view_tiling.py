"""The view kernel's algorithm (``k_view`` in ``pgdvs_tpu_torch/csrc/gnt_fused.cu``)
on the CPU.

The kernel cannot run here, so ``_tiled_view_block`` repeats its arithmetic
in float32 torch on the weights as ``pack_view_block`` lays them out for
it: tokens in tiles of 16 (one mma m-tile per warp), the ragged last tile
reading token N-1's h, ray-diff code and validity and zero q; LN(q) rounded
to bf16 and the q side of attn_fc[0] through the composed ``wq @ wa0``;
per view, in order, ``[h_v | bf16(relu(pos_fc_0(rd_v)))]`` through the
composed [72 x 72] product with the biases as the accumulators' start,
``t = bf16(relu(a0))`` into the bf16 attn_fc[2], and the online softmax per
(token, channel) with one exponential per element (of the old max and the
new logit only the smaller one's exponential is not 1); a token with no
valid view attends to all of them; then ``bf16(agg / den)``, out_fc, the
residual, LN in bf16, the feed-forward with its hidden layer in bf16, and
with ``qf`` q_fc on ``bf16([q | point code | view code])``, the point code
made as the kernel makes it (the double-angle ladder from one sin / cos
pair) or read.

It is held to the plain half-block (``split_view_plain``, with the q_fc
module after it where the kernel runs q_fc) within K3a's bound on the card
(``chip_smoke.Q_TOL``: q atol 0.02 + 2 %), and to the JAX package's
``_run_view`` (Pallas, interpret mode) on the same numpy-seeded bf16
inputs within the split test's bound for one view half-block (atol / rtol
0.03: JAX rounds every dense output and q to bf16). Cases: V = 1, 10 and
32, N = 21 (not a multiple of the tile), two tokens with every view
invalid, q_fc off and on with its code made and read.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.kernels import gnt_fused as jsplit
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu_torch.kernels.gnt_fused import pack_view_block
from pgdvs_tpu_torch.kernels.gnt_fused_split import split_view_plain
from pgdvs_tpu_torch.models.gnt.network import GNT, sinusoidal_embed
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict

TILE = 16       # VT in the .cu
Q_TOL = 0.02    # chip_smoke.Q_TOL
JAX_TOL = 0.03  # tests/test_torch_port_split.py, one view half-block
R, S = 3, 7     # N = 21 tokens: one full tile and a ragged one


def _bf(x):
    return x.to(torch.bfloat16).float()


def _ln(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale + bias


def _point_code(p):
    """[p (3) | sin, cos of 2^f p for f = 0..9 (6 each)] [N, 63], as the
    kernel makes it: bf16 of the double-angle ladder from one sin / cos pair."""
    cols = [p]
    s, c = torch.sin(p), torch.cos(p)
    for _ in range(10):
        cols += [s, c]
        s, c = 2.0 * s * c, c * c - s * s
    return torch.cat(cols, dim=-1)


@torch.no_grad()
def _tiled_view_block(q, h, rd, mask, packed, code=None, tile=TILE):
    """One view block (+ q_fc when ``code`` is given) as ``k_view`` computes
    it: q [N, 64] f32, h [V, N, 64] (bf16 values), rd [V, N, 4] f32, mask
    [V, N] bool, ``packed`` the 21 tensors of ``pack_view_block``, code [N,
    126] (point code | view code) or None -> q [N, 64]."""
    (ln_s, ln_b, wqa0, wbig, bbig, p0, p0b, wa1, ba1, wout, bout, fln_s, fln_b,
     wf1, bf1, wf2, bf2, wq0, bq0, wq1, bq1) = [
        None if t is None else t.float() for t in packed]
    v_n, n = h.shape[:2]
    out = torch.empty_like(q)
    for n0 in range(0, n, tile):
        rows = torch.arange(n0, n0 + tile)
        idx = rows.clamp(max=n - 1)              # h, rd, validity of token N-1
        qt = torch.where((rows < n)[:, None], q[idx], 0.0)  # q rows past N read 0
        x = _bf(_ln(qt, ln_s, ln_b))
        qb = bbig[64:72] - x @ wqa0[:, :8]
        valid = mask[:, idx]
        valid = torch.where(valid.any(0, keepdim=True), valid, torch.ones_like(valid))
        mx = torch.full((tile, 64), -math.inf)
        den = torch.zeros(tile, 64)
        agg = torch.zeros(tile, 64)
        for v in range(v_n):
            pos = _bf(torch.relu(rd[v, idx] @ p0 + p0b))
            acc = torch.cat([h[v, idx], pos], -1) @ wbig[:72, :72] + torch.cat(
                [bbig[:64].expand(tile, 64), qb], -1)
            lg = _bf(torch.relu(acc[:, 64:])) @ wa1 + ba1
            d = torch.where(valid[v][:, None], lg - mx, -math.inf)
            ed = torch.exp2(-d.abs() * math.log2(math.e))
            up = d > 0
            sc, p = torch.where(up, ed, 1.0), torch.where(up, 1.0, ed)
            mx = torch.where(up, lg, mx)
            den = den * sc + p
            agg = agg * sc + p * acc[:, :64]
        x = qt + _bf(agg / den) @ wout + bout
        hid = _bf(torch.relu(_bf(_ln(x, fln_s, fln_b)) @ wf1 + bf1))
        x = x + hid @ wf2 + bf2
        if code is not None:
            a = torch.cat([_bf(x), _bf(code[idx]), torch.zeros(tile, 2)], -1)
            x = _bf(torch.relu(a @ wq0 + bq0)) @ wq1 + bq1
        keep = min(tile, n - n0)
        out[n0:n0 + keep] = x[:keep]
    return out


@pytest.fixture(scope="module")
def gnts():
    """The JAX package's GNT (random init) and the port's with its weights."""
    rng = np.random.default_rng(0)
    gnt_j = JGNT(netwidth=64, depth=8, in_feat_ch=32, dtype="bfloat16", ret_view_std=False)
    params = gnt_j.init(
        jax.random.PRNGKey(1),
        rng.normal(size=(2, 4, 3, 35)).astype(np.float32),
        rng.normal(size=(2, 4, 3, 4)).astype(np.float32),
        np.ones((2, 4, 3, 1), np.float32),
        rng.normal(size=(2, 4, 3)).astype(np.float32),
        rng.normal(size=(2, 3)).astype(np.float32),
    )
    gnt = GNT().eval()
    gnt.load_state_dict(gnt_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return params, gnt


def _operands(v, seed):
    """q [R, S, 64], h [V, R, S, 64], rd [V, R, S, 4] (bf16 values, numpy
    and torch) and the mask [V, R, S]: 40 % invalid at random, every view
    of tokens 0 and 9 invalid."""
    rng = np.random.default_rng(seed)

    def bf16(x):
        return np.asarray(jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    q = bf16(rng.normal(size=(R, S, 64)))
    h = bf16(rng.normal(size=(v, R, S, 64)))
    rd = rng.normal(size=(v, R, S, 4))
    rd[..., :3] /= np.linalg.norm(rd[..., :3], axis=-1, keepdims=True)
    rd = bf16(rd)
    mask = rng.uniform(size=(v, R, S)) > 0.4
    flat = mask.reshape(v, -1)
    flat[:, [0, 9]] = False
    return q, h, rd, mask


def _flat(q, h, rd, mask):
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    v = h.shape[0]
    return (t(q).reshape(-1, 64), t(h).reshape(v, -1, 64), t(rd).reshape(v, -1, 4),
            torch.from_numpy(mask).reshape(v, -1))


def _assert_q_close(got, ref, atol, rtol):
    err = (got - ref).abs()
    assert bool((err <= atol + rtol * ref.abs()).all()), float(err.max())


@pytest.mark.parametrize("v", [1, 10, 32])
def test_tiled_view_block_matches_plain(gnts, v):
    _params, gnt = gnts
    vt = gnt.view_crosstrans[3]
    q, h, rd, mask = _operands(v, seed=v)
    got = _tiled_view_block(*_flat(q, h, rd, mask), pack_view_block(vt, None, "cpu"))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    ref = split_view_plain(t(q), t(h), t(rd), torch.from_numpy(mask), vt).reshape(-1, 64)
    assert got.shape == (R * S, 64) and float(ref.abs().max()) > 1.0
    _assert_q_close(got, ref, Q_TOL, 0.02)


@pytest.mark.parametrize("code_from", ["made", "read"])
def test_tiled_view_block_with_q_fc_matches_plain(gnts, code_from):
    """An even block: the view block, then q_fc on [q | point code | view
    code], the code made in the kernel from pts and the ray's view code, or
    read as bf16 [N, 126]."""
    _params, gnt = gnts
    vt, qf = gnt.view_crosstrans[2], gnt.q_fcs[1]
    q, h, rd, mask = _operands(10, seed=42)
    rng = np.random.default_rng(43)
    pts = torch.from_numpy(rng.normal(0, 1.5, (R * S, 3)).astype(np.float32))
    vcode = sinusoidal_embed(torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32)))
    vc_tok = vcode[torch.arange(R * S) // S]   # token n takes ray n // S's code
    if code_from == "made":
        code = torch.cat([_point_code(pts), vc_tok], -1)
    else:
        code = torch.cat([sinusoidal_embed(pts), vc_tok], -1).to(torch.bfloat16).float()
    got = _tiled_view_block(*_flat(q, h, rd, mask), pack_view_block(vt, qf, "cpu"), code)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    ref = split_view_plain(t(q), t(h), t(rd), torch.from_numpy(mask), vt).reshape(-1, 64)
    ref = qf(torch.cat([ref, sinusoidal_embed(pts), vc_tok], -1))
    _assert_q_close(got, ref, Q_TOL, 0.02)


@pytest.mark.parametrize("v", [1, 10, 32])
def test_tiled_view_block_matches_jax(gnts, v):
    """Against the JAX package's view kernel (``_run_view``, interpret mode,
    one ray block of R rays) on the same bf16 inputs; its bias is 0 / -1e30,
    0 for every view of a token with none valid."""
    params, gnt = gnts
    blk = 3
    q, h, rd, mask = _operands(v, seed=100 + v)
    all_invalid = mask.sum(0, keepdims=True) == 0
    bias = np.where(~mask & ~all_invalid, jsplit.NEG, 0.0)[..., None]
    _head, pair = jsplit.flatten_gnt_params(params)
    p, slot = divmod(blk, 2)
    base = 0 if slot == 0 else jsplit.N_A
    view_w = [w[p] for w in pair[base:base + jsplit.N_VIEW_W]]
    b16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    ref = jsplit._run_view(b16(q), b16(h), b16(rd), b16(bias), view_w, R, True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).reshape(-1, 64)
    got = _tiled_view_block(*_flat(q, h, rd, mask),
                            pack_view_block(gnt.view_crosstrans[blk], None, "cpu"))
    _assert_q_close(got, ref, JAX_TOL, JAX_TOL)


def test_view_order_changes_only_rounding(gnts):
    """The one-exponential online update is a softmax over the valid views
    whatever their order: the views reversed agree within f32 rounding."""
    _params, gnt = gnts
    q, h, rd, mask = _operands(10, seed=7)
    packed = pack_view_block(gnt.view_crosstrans[5], None, "cpu")
    qt, ht, rdt, mt = _flat(q, h, rd, mask)
    fwd = _tiled_view_block(qt, ht, rdt, mt, packed)
    rev = _tiled_view_block(qt, ht.flip(0), rdt.flip(0), mt.flip(0), packed)
    torch.testing.assert_close(rev, fwd, atol=1e-4, rtol=1e-4)


def test_pack_view_block_layout(gnts):
    """What k_view stages from the packed weights: wbig [80, 80] with its
    rows and columns past 72 zero (the kernel copies rows 0..71 and reads
    columns 0..71), wqa0 [64, 16] zero past column 8, attn_fc[2] [8, 64] in
    bf16, q_fc_0 [192, 64] zero in its last two rows."""
    _params, gnt = gnts
    packed = pack_view_block(gnt.view_crosstrans[0], gnt.q_fcs[0], "cpu")
    assert len(packed) == 21
    wqa0, wbig, wa1, wq0 = packed[2], packed[3], packed[7], packed[17]
    assert wbig.shape == (80, 80) and not wbig[72:].any() and not wbig[:, 72:].any()
    assert wqa0.shape == (64, 16) and not wqa0[:, 8:].any()
    assert wa1.shape == (8, 64) and wa1.dtype == torch.bfloat16
    assert wq0.shape == (192, 64) and not wq0[190:].any()
    assert all(t.dtype == torch.bfloat16 for t in (wqa0, wbig, wa1, wq0, packed[9],
                                                   packed[13], packed[15], packed[19]))
    assert pack_view_block(gnt.view_crosstrans[1], None, "cpu")[17:] == [None] * 4
