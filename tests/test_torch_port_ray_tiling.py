"""The ray kernel's algorithm (``k_ray`` in ``pgdvs_tpu_torch/csrc/gnt_fused.cu``)
on the CPU, and the plain GNT forward above the sample count the port's
first ray kernel could hold.

The kernel cannot run here, so ``_tiled_ray_block`` repeats its arithmetic
in float32 torch: bf16 operands (LayerNorm output, Q / K / V, the weights,
the normalized attention output and the hidden layer rounded as the kernel
rounds them), keys in tiles of the kernel's width with pad keys masked, a
running max and sum per (query, head) with exp2 and log2(e) / 4 folded
into the scale, P rounded to bf16 before P.V, and query 0's weights row
from a second pass over the keys with its final max and sum. It is held to
the plain half-block (``split_ray_plain``) within the kernel's own bounds
(``chip_smoke.py``: q atol 0.02 + 2 %, weights 0.05 / S), at S = 23, 256
and 384; 384 lies above the old one-ray-per-block cap of 368.

The plain GNT forward at S = 384 is held to the JAX package's flax GNT
with K1's tolerances (rgb atol / rtol 0.02, weights 0.01, count 0.01), as
tests/test_torch_port_kernel.py holds it to mono4 at 23 and 32 samples.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.core import cameras as jcam
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu.models.gnt.network import sinusoidal_embed as j_embed
from pgdvs_tpu_torch.kernels import gnt_fused as k1
from pgdvs_tpu_torch.kernels.gnt_fused_split import split_ray_plain
from pgdvs_tpu_torch.models.gnt.network import GNT
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict

KEY_TILE = 64                      # KT in the .cu
SCORE_C = 0.25 * math.log2(math.e)  # SCORE_C in the .cu
Q_TOL = 0.02                       # chip_smoke.Q_TOL


def _bf(x):
    return x.to(torch.bfloat16).float()


def _w(linear):
    """nn.Linear -> its [in, out] kernel, in bf16 values."""
    return _bf(linear.weight.detach().T)


@torch.no_grad()
def _tiled_ray_block(q, rt, key_tile=KEY_TILE):
    """One ray-transformer block as ``k_ray`` computes it: q [R, S, 64] f32
    -> (q, weights [R, S])."""
    r, s, nw = q.shape
    ra = rt.attn
    sk = -(-s // key_tile) * key_tile
    # pad samples read as 0: LN(0) projected, finite, masked out below
    qpad = torch.cat([q, q.new_zeros(r, sk - s, nw)], dim=1)
    x = _bf(rt.attn_norm(qpad))

    def heads(t):                   # [R, Sk, 64] -> [R, 4, Sk, 16], bf16 values
        return _bf(t).reshape(r, sk, 4, 16).transpose(1, 2)

    qh, kh, vh = heads(x @ _w(ra.q_fc)), heads(x @ _w(ra.k_fc)), heads(x @ _w(ra.v_fc))
    qh = qh[:, :, :s]
    m = q.new_full((r, 4, s), -math.inf)
    l = q.new_zeros((r, 4, s))
    o = q.new_zeros((r, 4, s, 16))
    for k0 in range(0, sk, key_tile):
        sc = qh @ kh[:, :, k0:k0 + key_tile].transpose(-1, -2)
        sc[..., torch.arange(k0, k0 + key_tile) >= s] = -math.inf
        mn = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2((m - mn) * SCORE_C)
        p = torch.exp2(sc * SCORE_C - (mn * SCORE_C)[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _bf(p) @ vh[:, :, k0:k0 + key_tile]
        m = mn
    att = _bf(o / l[..., None]).transpose(1, 2).reshape(r, s, nw)
    x1 = q + att @ _w(ra.out_fc) + ra.out_fc.bias
    ff = rt.ff
    hid = _bf(torch.relu(_bf(rt.ff_norm(x1)) @ _w(ff.fc1) + ff.fc1.bias))
    q_out = x1 + hid @ _w(ff.fc2) + ff.fc2.bias
    # query 0: its row again, over every key, with its final max and sum
    s0 = (qh[:, :, :1] @ kh[:, :, :s].transpose(-1, -2))[:, :, 0]
    w = (torch.exp2(s0 * SCORE_C - (m[:, :, :1] * SCORE_C)) / l[:, :, :1]).mean(dim=1)
    return q_out, w


@pytest.fixture(scope="module")
def ray_block():
    torch.manual_seed(0)
    return GNT().eval().view_selftrans[3]


def _q(r, s, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(r, s, 64)).astype(np.float32))


@pytest.mark.parametrize("s", [23, 256, 384])
def test_tiled_ray_block_matches_plain(ray_block, s):
    """The kernel's tiling against the plain half-block within the kernel's
    bounds; weights written uniform or in a wrong sample order would not
    be."""
    q = _q(4, s, seed=s)
    got_q, got_w = _tiled_ray_block(q, ray_block)
    ref_q, ref_w = split_ray_plain(q, ray_block)
    assert got_q.shape == ref_q.shape and got_w.shape == ref_w.shape == (4, s)
    err = (got_q - ref_q).abs()
    assert bool((err <= Q_TOL + 0.02 * ref_q.abs()).all()), float(err.max())
    tol = 0.05 / s
    assert float((got_w - ref_w).abs().max()) <= tol
    eo = torch.cat([torch.arange(0, s, 2), torch.arange(1, s, 2)])
    for wrong in (torch.full_like(ref_w, 1.0 / s), ref_w.flip(-1), ref_w[:, eo]):
        assert float((wrong - ref_w).abs().max()) > tol


@pytest.mark.parametrize("key_tile", [16, 32])
def test_online_softmax_is_independent_of_the_key_tile(ray_block, key_tile):
    """Streaming the keys changes nothing but rounding: narrower tiles (more
    rescales, more pad keys at S = 100) agree with one tile over all keys."""
    q = _q(3, 100, seed=5)
    one_q, one_w = _tiled_ray_block(q, ray_block, key_tile=128)
    got_q, got_w = _tiled_ray_block(q, ray_block, key_tile=key_tile)
    torch.testing.assert_close(got_q, one_q, atol=2e-2, rtol=0)
    torch.testing.assert_close(got_w, one_w, atol=1e-6, rtol=1e-4)
    assert abs(float(got_w.sum()) - 3.0) < 1e-4  # each row of weights sums to 1


H, W = 20, 28


def test_plain_forward_above_the_old_cap_matches_jax():
    """K1's plain version at S = 384 against the JAX package's flax GNT in
    float32 on the same bf16 features, with validity and the ray-diff code
    made by the JAX camera helpers. The JAX side is one compiled program
    (mono4 in interpret mode, or op by op, takes 20-30 s at this S); depth 2
    (one view / ray pair and one q_fc) keeps its compile short, and the
    sample count is what this test is about."""
    rng = np.random.default_rng(384)
    r, s, v, f, depth = 8, 384, 3, 32, 2
    gnt_j = JGNT(netwidth=64, depth=depth, in_feat_ch=f, dtype="float32", ret_view_std=False)
    ray_d = rng.normal(size=(r, 3)).astype(np.float32)
    rf = rng.normal(size=(v, r, s, 3 + f)).astype(np.float32)
    rf = np.asarray(jnp.asarray(rf).astype(jnp.bfloat16).astype(jnp.float32))
    pts = (rng.normal(0, 1.2, (r, s, 3)) + [0, 0, 2.5]).astype(np.float32)
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 25.0
    k[0, 2], k[1, 2] = W / 2, H / 2
    c2w = np.tile(np.eye(4), (v, 1, 1))
    c2w[:, :3, 3] = [[0.2 * i - 0.3, 0.1 * i, -0.2 * i] for i in range(v)]

    @jax.jit
    def jax_side(rf, pts, ray_d):
        cams = jnp.stack([jcam.make_flat_cam(H, W, k, c) for c in c2w])
        uv, _z, front = jax.vmap(lambda c: jcam.project_points(pts, c))(cams)
        valid = (jcam.pixel_inbound(uv, H, W) & front).astype(jnp.float32)  # [V, R, S]
        c2ws = jax.vmap(jcam.flat_cam_c2w)(cams)
        ray_diff = jcam.ray_diff_features(pts[:, :, None, :], c2ws[0], c2ws[None, None])
        out, params = gnt_j.init_with_output(
            jax.random.PRNGKey(0), jnp.transpose(rf, (1, 2, 0, 3)), ray_diff,
            jnp.transpose(valid, (1, 2, 0))[..., None], pts, ray_d)
        cnt = jnp.sum(out["weights"] * valid.sum(0) / v, axis=-1)
        vc = j_embed(ray_d / jnp.linalg.norm(ray_d, axis=-1, keepdims=True))
        centers = jnp.concatenate([c2ws[:1, :3, 3], c2ws[:, :3, 3]], axis=0)
        projs = jax.vmap(jcam.flat_cam_projection)(cams)
        return out["rgb"], out["weights"], cnt, params, vc, centers, projs

    rgb, weights, cnt, params, vc, centers, projs = jax_side(rf, pts, ray_d)
    assert 0.05 < float(cnt.mean()) < 0.95  # a mix of valid and invalid views

    gnt = GNT(depth=depth).eval()
    gnt.load_state_dict(gnt_state_dict(jax.tree_util.tree_map(np.asarray, params), depth))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    got = k1.gnt_fused_mono4(gnt, t(rf).to(torch.bfloat16), t(pts), t(vc), t(centers),
                             t(projs), (H, W))
    assert tuple(got["weights"].shape) == (r, s)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(rgb), atol=0.02, rtol=0.02)
    np.testing.assert_allclose(got["weights"].numpy(), np.asarray(weights), atol=0.01)
    np.testing.assert_allclose(got["inbound_cnt_raw"].numpy(), np.asarray(cnt), atol=0.01)


def test_no_sample_cap_is_left():
    """The shared-memory check that refused S above 368 and its C entry are
    gone: the ray kernel streams the sample axis."""
    from pgdvs_tpu_torch.kernels import _build, gnt_fused_split

    assert not hasattr(k1, "check_ray_smem")
    assert not hasattr(gnt_fused_split, "check_ray_smem")
    assert "gnt_mono4_ray_smem" not in _build.SIGNATURES
    src = (_build.CSRC_DIR / "gnt_fused.cu").read_text()
    assert "gnt_mono4_ray_smem" not in src and "ray_layout" not in src
