"""K2, the fused GNT transformer with an explicit validity mask: the port's
plain version against the JAX package's ``gnt_fused_apply_mono3`` (Pallas,
interpret mode on the CPU) in the masked renderer's mode (separate_mask,
fold_ray_diff, fold_pos_code, views outer), and the wrapper's device
discipline. The hand kernel against its plain version on a card is in
test_torch_port_cuda.py.

Tolerances are K1's (rgb atol/rtol 0.02, weights 0.01, count 0.01): the
Pallas kernel runs in bf16 with f32 statistics, the port's plain version in
float32. At these sample counts the weights of a ray spread over more than
0.01, so the weights bound rejects weights written uniform or reordered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.core import cameras as jcam
from pgdvs_tpu.kernels.gnt_fused_mono3 import gnt_fused_apply_mono3
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu.models.gnt.network import sinusoidal_embed as j_embed
from pgdvs_tpu_torch.kernels import gnt_fused_mono3 as k2
from pgdvs_tpu_torch.models.gnt.network import GNT
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict

H, W = 20, 28
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
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 25.0
    k[0, 2], k[1, 2] = W / 2, H / 2
    cams = []
    for i in range(V):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * i - 0.3, 0.1 * i, -0.2 * i]
        cams.append(np.asarray(jcam.make_flat_cam(H, W, k, c2w), np.float32))
    cams = jnp.asarray(np.stack(cams))
    centers = jnp.concatenate([
        jcam.flat_cam_c2w(cams[0])[None, :3, 3],
        jax.vmap(jcam.flat_cam_c2w)(cams)[:, :3, 3],
    ], axis=0)
    ray_d = rng.normal(size=(R, 3)).astype(np.float32)
    vc = j_embed(ray_d / np.linalg.norm(ray_d, axis=-1, keepdims=True))
    return {"params": params, "gnt": gnt, "cams": cams,
            "centers": np.asarray(centers), "vc": np.asarray(vc)}


def _operands(setup, s, seed, behind=False):
    """rgb_feat [V, R, S, C], pts [R, S, 3] and a mask [V, R, S] = in bounds &
    in front & not dynamic, with rays 0-1 dynamic in every view (their
    tokens fall back to un-masked attention) and 30 % random dynamic taps."""
    rng = np.random.default_rng(seed)
    rgb_feat = rng.normal(size=(V, R, s, 3 + F)).astype(np.float32)
    if behind:
        pts = np.full((R, s, 3), -50.0, np.float32)
    else:
        pts = (rng.normal(0, 1.2, (R, s, 3)) + [0, 0, 2.5]).astype(np.float32)
    uv, _z, front = jax.vmap(lambda c: jcam.project_points(jnp.asarray(pts), c))(
        setup["cams"])
    inbound = np.asarray(jcam.pixel_inbound(uv, float(H), float(W)) & front)
    dyn = rng.uniform(size=(V, R, s)) < 0.3
    dyn[:, :2] = True
    mask = (inbound & ~dyn).astype(np.float32)
    return rgb_feat, pts, mask


def _both(setup, rgb_feat, pts, mask):
    rf_bf16 = jnp.asarray(rgb_feat).astype(jnp.bfloat16)
    ref = gnt_fused_apply_mono3(
        setup["params"], rf_bf16, None, jnp.asarray(mask)[..., None], None,
        jnp.asarray(setup["vc"]), ray_block=8, interpret=True, views_outer=True,
        pts=jnp.asarray(pts), cam_centers=jnp.asarray(setup["centers"]),
        separate_mask=True, fold_pos_code=True,
    )
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    got = k2.gnt_fused_mono3(
        setup["gnt"], t(rf_bf16.astype(jnp.float32)).to(torch.bfloat16),
        t(mask).bool(), t(pts), t(setup["vc"]), t(setup["centers"]),
    )
    return got, {k: np.asarray(v) for k, v in ref.items()}


def _check(got, ref, spread=True):
    np.testing.assert_allclose(got["rgb"].numpy(), ref["rgb"], atol=0.02, rtol=0.02)
    np.testing.assert_allclose(got["weights"].numpy(), ref["weights"], atol=0.01)
    np.testing.assert_allclose(got["inbound_cnt_raw"].numpy(),
                               ref["inbound_cnt_raw"], atol=0.01)
    if spread:  # the weights bound rejects uniform or reordered weights
        w, s = ref["weights"], ref["weights"].shape[-1]
        eo = np.concatenate([np.arange(0, s, 2), np.arange(1, s, 2)])
        for wrong in (np.full_like(w, 1.0 / s), w[:, ::-1], w[:, eo]):
            assert np.abs(wrong - w).max() > 0.01


@pytest.mark.parametrize("s", [16, 23])
def test_plain_matches_jax_mono3(setup, s):
    """A mix of valid, out-of-bounds and dynamic views, with tokens whose
    views are all dynamic; an odd sample count too."""
    rgb_feat, pts, mask = _operands(setup, s, seed=40 + s)
    all_off = mask.sum(0) == 0
    assert all_off[:2].all() and not all_off.all()
    assert 0.1 < mask.mean() < 0.7
    got, ref = _both(setup, rgb_feat, pts, mask)
    assert tuple(got["weights"].shape) == (R, s)
    _check(got, ref)


def test_plain_matches_jax_mono3_all_invalid(setup):
    """Points behind every camera: no view valid anywhere, un-masked
    fallback everywhere, zero count."""
    rgb_feat, pts, mask = _operands(setup, 16, seed=7, behind=True)
    assert mask.sum() == 0
    got, ref = _both(setup, rgb_feat, pts, mask)
    for key in ("rgb", "weights", "inbound_cnt_raw"):
        assert torch.isfinite(got[key]).all()
    assert float(got["inbound_cnt_raw"].abs().max()) == 0.0
    _check(got, ref, spread=False)  # samples all at one place: near uniform


def _cpu_operands(setup, device="cpu"):
    rgb_feat, pts, mask = _operands(setup, 16, seed=5)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return (t(rgb_feat).to(torch.bfloat16), t(mask), t(pts), t(setup["vc"]),
            t(setup["centers"]))


def test_wrapper_cpu_runs_plain_without_counting(setup):
    ops = _cpu_operands(setup)
    before = k2.gnt_fused_mono3.launches
    got = k2.gnt_fused_mono3(setup["gnt"], *ops)
    ref = k2.gnt_fused_mono3_plain(setup["gnt"], *ops)
    assert k2.gnt_fused_mono3.launches == before
    for key in ref:
        assert torch.equal(got[key], ref[key])
    # the mask's dtype does not matter: nonzero is valid
    as_u8 = k2.gnt_fused_mono3(setup["gnt"], ops[0], ops[1].to(torch.uint8), *ops[2:])
    assert torch.equal(as_u8["rgb"], ref["rgb"])


def test_wrapper_cuda_without_card_raises(setup, monkeypatch):
    """Asking for CUDA without a card raises; nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    calls = []
    monkeypatch.setattr(k2, "gnt_fused_mono3_plain", lambda *a, **kw: calls.append(1))
    with pytest.raises((RuntimeError, AssertionError)):
        k2.gnt_fused_mono3(setup["gnt"], *_cpu_operands(setup, device="cuda"))
    assert not calls
    meta = torch.empty(2, 3, 4, 35, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        k2.gnt_fused_mono3(setup["gnt"], meta, None, None, None, None)
    assert not calls
