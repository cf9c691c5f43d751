"""K1, the fused GNT transformer: the port's plain version against the JAX
package's ``gnt_fused_apply_mono4`` (Pallas, interpret mode on the CPU), the
wrapper's device discipline. The hand kernel against its plain version on
a card is in test_torch_port_cuda.py (no JAX there, so it runs on the GPU
machine).

Tolerances (rgb atol/rtol 0.02, weights 0.01, count 0.01) are the ones the
JAX package holds mono4 to against mono3: the Pallas kernel runs in bf16
with f32 statistics, the port's plain version in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.core import cameras as jcam
from pgdvs_tpu.kernels.gnt_fused_mono4 import gnt_fused_apply_mono4
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu.models.gnt.network import sinusoidal_embed as j_embed
from pgdvs_tpu_torch.kernels import gnt_fused as k1
from pgdvs_tpu_torch.models.gnt.network import GNT
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict

H, W = 20, 28


@pytest.fixture(scope="module")
def setup():
    """The inputs of tests/test_gnt_fused.py's mono4 checks."""
    rng = np.random.default_rng(0)
    r, s, v, f = 16, 32, 5, 32
    gnt_j = JGNT(netwidth=64, depth=8, in_feat_ch=f, dtype="bfloat16",
                 ret_view_std=False)
    rgb_feat = rng.normal(size=(r, s, v, 3 + f)).astype(np.float32)
    ray_diff = rng.normal(size=(r, s, v, 4)).astype(np.float32)
    mask = (rng.uniform(size=(r, s, v, 1)) > 0.2).astype(np.float32)
    pts = rng.normal(size=(r, s, 3)).astype(np.float32)
    ray_d = rng.normal(size=(r, 3)).astype(np.float32)
    params = gnt_j.init(jax.random.PRNGKey(0), rgb_feat, ray_diff, mask, pts, ray_d)
    gnt = GNT().eval()
    gnt.load_state_dict(gnt_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 25.0
    k[0, 2], k[1, 2] = W / 2, H / 2
    cams = []
    for i in range(v):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * i - 0.3, 0.1 * i, -0.2 * i]
        cams.append(np.asarray(jcam.make_flat_cam(H, W, k, c2w), np.float32))
    cams = jnp.asarray(np.stack(cams))
    projs = jax.vmap(jcam.flat_cam_projection)(cams)
    centers = jnp.concatenate([
        jcam.flat_cam_c2w(cams[0])[None, :3, 3],
        jax.vmap(jcam.flat_cam_c2w)(cams)[:, :3, 3],
    ], axis=0)
    vc = j_embed(ray_d / np.linalg.norm(ray_d, axis=-1, keepdims=True))
    return {"params": params, "gnt": gnt, "projs": np.asarray(projs),
            "centers": np.asarray(centers), "vc": np.asarray(vc), "v": v,
            "r": r, "fc": 3 + f}


def _both(setup, rgb_feat_vrsc, pts):
    """Run JAX mono4 (interpret) and the port's plain version on the same
    views-outer rgb_feat [V, R, S, C] and pts [R, S, 3]."""
    rf_bf16 = jnp.asarray(rgb_feat_vrsc).astype(jnp.bfloat16)
    ref = gnt_fused_apply_mono4(
        setup["params"], rf_bf16, jnp.asarray(pts), jnp.asarray(setup["vc"]),
        jnp.asarray(setup["centers"]), jnp.asarray(setup["projs"]), (H, W),
        ray_block=8, interpret=True,
    )
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    got = k1.gnt_fused_mono4(
        setup["gnt"], t(rf_bf16.astype(jnp.float32)).to(torch.bfloat16), t(pts),
        t(setup["vc"]), t(setup["centers"]), t(setup["projs"]), (H, W),
    )
    return got, ref


def _check(got, ref):
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]),
                               atol=0.02, rtol=0.02)
    np.testing.assert_allclose(got["weights"].numpy(), np.asarray(ref["weights"]),
                               atol=0.01)
    np.testing.assert_allclose(got["inbound_cnt_raw"].numpy(),
                               np.asarray(ref["inbound_cnt_raw"]), atol=0.01)


@pytest.mark.parametrize("s", [32, 23])
def test_plain_matches_jax_mono4(setup, s):
    """Includes an odd sample count, which mono4 pads and the port does not."""
    rng = np.random.default_rng(31 + s)
    r, v, fc = setup["r"], setup["v"], setup["fc"]
    rgb_feat = rng.normal(size=(v, r, s, fc)).astype(np.float32)
    pts = (rng.normal(0, 1.2, (r, s, 3)) + [0, 0, 2.5]).astype(np.float32)
    got, ref = _both(setup, rgb_feat, pts)
    assert tuple(got["weights"].shape) == (r, s)
    valid_frac = float(np.mean(np.asarray(ref["inbound_cnt_raw"])))
    assert 0.05 < valid_frac < 0.95  # a mix of valid and invalid views
    _check(got, ref)


def test_plain_matches_jax_mono4_all_invalid(setup):
    """Points behind every camera: every view invalid, un-masked fallback."""
    rng = np.random.default_rng(7)
    r, v, fc = setup["r"], setup["v"], setup["fc"]
    rgb_feat = rng.normal(size=(v, r, 32, fc)).astype(np.float32)
    pts = np.full((r, 32, 3), -50.0, np.float32)
    got, ref = _both(setup, rgb_feat, pts)
    for key in ("rgb", "weights", "inbound_cnt_raw"):
        assert torch.isfinite(got[key]).all()
    assert float(got["inbound_cnt_raw"].abs().max()) == 0.0
    _check(got, ref)


def _cpu_operands(setup, device="cpu"):
    rng = np.random.default_rng(5)
    r, v, fc = setup["r"], setup["v"], setup["fc"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return (
        t(rng.normal(size=(v, r, 32, fc))).to(torch.bfloat16),
        t(rng.normal(0, 1.2, (r, 32, 3)) + [0, 0, 2.5]),
        t(setup["vc"]), t(setup["centers"]), t(setup["projs"]), (H, W),
    )


def test_wrapper_cpu_runs_plain_without_counting(setup):
    ops = _cpu_operands(setup)
    before = k1.gnt_fused_mono4.launches
    got = k1.gnt_fused_mono4(setup["gnt"], *ops)
    ref = k1.gnt_fused_mono4_plain(setup["gnt"], *ops)
    assert k1.gnt_fused_mono4.launches == before
    for key in ref:
        assert torch.equal(got[key], ref[key])


def test_wrapper_cuda_without_card_raises(setup, monkeypatch):
    """Asking for CUDA without a card raises; nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    calls = []
    monkeypatch.setattr(k1, "gnt_fused_mono4_plain",
                        lambda *a, **kw: calls.append(1))
    with pytest.raises((RuntimeError, AssertionError)):
        ops = _cpu_operands(setup, device="cuda")
        k1.gnt_fused_mono4(setup["gnt"], *ops)
    assert not calls
    # without the CUDA toolkit the kernel cannot even be built: that raises
    # too, rather than falling back
    import shutil

    from pgdvs_tpu_torch.kernels import _build

    if shutil.which("nvcc") is None and not _build.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load_library.__wrapped__()
    # a tensor on a device the kernel does not serve is refused outright
    meta = [torch.empty(2, 3, 4, 35, dtype=torch.bfloat16, device="meta")]
    with pytest.raises(ValueError):
        k1.gnt_fused_mono4(setup["gnt"], *meta, None, None, None, None, (H, W))
    assert not calls
