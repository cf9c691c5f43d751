"""K3a / K3b, the split GNT transformer: the port's plain half-blocks and
its whole split forward against the JAX package's ``_run_view``,
``_run_ray`` and ``gnt_fused_apply`` (Pallas, interpret mode on the CPU,
views outer), with weights carried by ``params_from_jax``; and the
wrappers' device discipline. The hand kernels against their plain versions
on a card are in test_torch_port_cuda.py.

Tolerances are K1 / K2's: rgb atol/rtol 0.02 and weights 0.01 for the
whole forward. The JAX kernels compute in bf16 with f32 statistics and
round q to bf16 between every half-block; the port's plain version is
float32 (h in bf16, the kernels' operand, on both sides). Measured here:
rgb <= 1.42e-2, weights <= 9.2e-4 over S in {16, 23}. One half-block's q
is held to atol/rtol 0.03 (measured: view blocks 4.0e-2 on values up to
8.3, a few bf16 ulps of JAX's bf16 output; ray blocks 2.6e-2) and its
weights row to 5e-3 (measured 1.6e-3: JAX takes the exponentials in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.kernels import gnt_fused as jsplit
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu.models.gnt.network import sinusoidal_embed as j_embed
from pgdvs_tpu_torch.kernels import gnt_fused_split as k3
from pgdvs_tpu_torch.models.gnt.network import GNT, sinusoidal_embed
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict

R, V, F = 16, 4, 32


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    gnt_j = JGNT(netwidth=64, depth=8, in_feat_ch=F, dtype="bfloat16",
                 ret_view_std=False)
    s = 4
    params = gnt_j.init(
        jax.random.PRNGKey(0),
        rng.normal(size=(R, s, V, 3 + F)).astype(np.float32),
        rng.normal(size=(R, s, V, 4)).astype(np.float32),
        np.ones((R, s, V, 1), np.float32),
        rng.normal(size=(R, s, 3)).astype(np.float32),
        rng.normal(size=(R, 3)).astype(np.float32),
    )
    gnt = GNT().eval()
    gnt.load_state_dict(gnt_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    ray_d = rng.normal(size=(R, 3)).astype(np.float32)
    vc = np.asarray(j_embed(ray_d / np.linalg.norm(ray_d, axis=-1, keepdims=True)))
    return {"params": params, "gnt": gnt, "vc": vc}


def _mask(rng, s):
    """[V, R, S] validity, 40 % invalid at random and every view of rays
    0-1 invalid (those tokens fall back to un-masked attention)."""
    mask = rng.uniform(size=(V, R, s)) > 0.4
    mask[:, :2] = False
    return mask


def _bf16(x):
    """numpy float32 rounded to bf16 values, and the same as a jnp bf16."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return np.asarray(j.astype(jnp.float32)), j


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _block_weights(params, blk):
    """The flat JAX weights of block ``blk``'s view and ray kernels."""
    _head, pair = jsplit.flatten_gnt_params(params)
    p, slot = divmod(blk, 2)
    base = 0 if slot == 0 else jsplit.N_A
    view = [w[p] for w in pair[base:base + jsplit.N_VIEW_W]]
    ray_start = base + jsplit.N_VIEW_W + (jsplit.N_QFC_W if slot == 0 else 0)
    ray = [w[p] for w in pair[ray_start:ray_start + jsplit.N_RAY_W]]
    return view, ray


@pytest.mark.parametrize("blk", [0, 3])
def test_view_half_block_matches_jax(setup, blk):
    rng = np.random.default_rng(10 + blk)
    s = 16
    q, q_j = _bf16(rng.normal(size=(R, s, 64)))
    h, h_j = _bf16(rng.normal(size=(V, R, s, 64)))
    rd, rd_j = _bf16(rng.normal(size=(V, R, s, 4)))
    mask = _mask(rng, s)
    all_invalid = mask.sum(0, keepdims=True) == 0
    bias = np.where(~mask & ~all_invalid, jsplit.NEG, 0.0)[..., None]
    view_w, _ = _block_weights(setup["params"], blk)
    ref = jsplit._run_view(q_j, h_j, rd_j, jnp.asarray(bias).astype(jnp.bfloat16),
                           view_w, 8, True)
    got = k3.split_view_plain(_t(q), _t(h), _t(rd), torch.from_numpy(mask),
                              setup["gnt"].view_crosstrans[blk])
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.shape == ref.shape and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got.numpy(), ref, atol=0.03, rtol=0.03)


@pytest.mark.parametrize("blk", [0, 3])
def test_ray_half_block_matches_jax(setup, blk):
    rng = np.random.default_rng(20 + blk)
    s = 16
    q, q_j = _bf16(rng.normal(size=(R, s, 64)))
    _, ray_w = _block_weights(setup["params"], blk)
    ref_q, ref_w = jsplit._run_ray(q_j, ray_w, 16, True)
    got_q, got_w = k3.split_ray_plain(_t(q), setup["gnt"].view_selftrans[blk])
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q.astype(jnp.float32)),
                               atol=0.03, rtol=0.03)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w).reshape(R, s), atol=5e-3)


def _operands(setup, s, seed):
    rng = np.random.default_rng(seed)
    rgb_feat, _ = _bf16(rng.normal(size=(V, R, s, 3 + F)))
    ray_diff = rng.normal(size=(V, R, s, 4)).astype(np.float32)
    ray_diff[..., :3] /= np.linalg.norm(ray_diff[..., :3], axis=-1, keepdims=True)
    pts = rng.normal(0, 1.5, (R, s, 3)).astype(np.float32)
    return rgb_feat, ray_diff, _mask(rng, s), pts


@pytest.mark.parametrize("s", [16, 23])
def test_split_forward_matches_jax(setup, s):
    """The whole forward, an odd sample count too; tokens of rays 0-1 have
    every view invalid."""
    rgb_feat, ray_diff, mask, pts = _operands(setup, s, seed=30 + s)
    assert (mask.sum(0) == 0)[:2].all() and 0.4 < mask.mean() < 0.6
    pts_code = np.asarray(j_embed(jnp.asarray(pts)))
    ref = jsplit.gnt_fused_apply(
        setup["params"], jnp.asarray(rgb_feat).astype(jnp.bfloat16),
        jnp.asarray(ray_diff), jnp.asarray(mask, jnp.float32)[..., None],
        jnp.asarray(pts_code), jnp.asarray(setup["vc"]), ray_block=8,
        interpret=True, views_outer=True)
    before = (k3.gnt_split_view.launches, k3.gnt_split_ray.launches)
    got = k3.gnt_fused_split(setup["gnt"], _t(rgb_feat).to(torch.bfloat16),
                             _t(ray_diff), torch.from_numpy(mask),
                             sinusoidal_embed(_t(pts)), _t(setup["vc"]))
    assert (k3.gnt_split_view.launches, k3.gnt_split_ray.launches) == before
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert tuple(got["weights"].shape) == (R, s) and tuple(got["rgb"].shape) == (R, 3)
    np.testing.assert_allclose(got["rgb"].numpy(), ref["rgb"], atol=0.02, rtol=0.02)
    np.testing.assert_allclose(got["weights"].numpy(), ref["weights"], atol=0.01)
    # the weights bound rejects uniform or reordered weights
    w = ref["weights"]
    eo = np.concatenate([np.arange(0, s, 2), np.arange(1, s, 2)])
    for wrong in (np.full_like(w, 1.0 / s), w[:, ::-1], w[:, eo]):
        assert np.abs(wrong - w).max() > 0.01


def _cpu_operands(setup, device="cpu"):
    rgb_feat, ray_diff, mask, pts = _operands(setup, 16, seed=5)
    return (_t(rgb_feat).to(device).to(torch.bfloat16), _t(ray_diff).to(device),
            torch.from_numpy(mask).to(device), sinusoidal_embed(_t(pts)).to(device),
            _t(setup["vc"]).to(device))


def test_wrappers_cpu_run_plain_without_counting(setup):
    gnt = setup["gnt"]
    ops = _cpu_operands(setup)
    before = (k3.gnt_split_view.launches, k3.gnt_split_ray.launches)
    got = k3.gnt_fused_split(gnt, *ops)
    ref = k3.gnt_fused_split_plain(gnt, *ops)
    for key in ref:
        assert torch.equal(got[key], ref[key])
    rng = np.random.default_rng(6)
    q = _t(rng.normal(size=(R, 16, 64)))
    h = _t(rng.normal(size=(V, R, 16, 64))).to(torch.bfloat16)
    args = (q, h, ops[1], ops[2])
    assert torch.equal(k3.gnt_split_view(*args, gnt.view_crosstrans[1]),
                       k3.split_view_plain(*args, gnt.view_crosstrans[1]))
    # packed weights carry their module: the CPU path runs it
    packed = k3.pack_split_weights(gnt, "cpu")
    assert torch.equal(k3.gnt_split_view(*args, packed.view[1]),
                       k3.split_view_plain(*args, gnt.view_crosstrans[1]))
    for a, b in zip(k3.gnt_split_ray(q, packed.ray[2]),
                    k3.split_ray_plain(q, gnt.view_selftrans[2])):
        assert torch.equal(a, b)
    assert (k3.gnt_split_view.launches, k3.gnt_split_ray.launches) == before


def test_wrappers_cuda_without_card_raise(setup, monkeypatch):
    """Asking for CUDA without a card raises; nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    calls = []
    monkeypatch.setattr(k3, "split_view_plain", lambda *a, **kw: calls.append(1))
    monkeypatch.setattr(k3, "split_ray_plain", lambda *a, **kw: calls.append(1))
    monkeypatch.setattr(k3, "gnt_fused_split_plain", lambda *a, **kw: calls.append(1))
    gnt = setup["gnt"]
    with pytest.raises((RuntimeError, AssertionError)):
        k3.gnt_fused_split(gnt, *_cpu_operands(setup, device="cuda"))
    q = torch.empty(R, 16, 64, device="meta")
    with pytest.raises((RuntimeError, AssertionError)):
        k3.gnt_split_ray(torch.zeros(R, 16, 64, device="cuda"), gnt.view_selftrans[0])
    with pytest.raises(ValueError):
        k3.gnt_split_view(q, q, q, q, gnt.view_crosstrans[0])
    with pytest.raises(ValueError):
        k3.gnt_split_ray(q, gnt.view_selftrans[0])
    assert not calls
