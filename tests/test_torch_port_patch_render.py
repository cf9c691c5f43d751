"""The JAX package's fast preset end to end: the port's ``render_novel_view``
under ``apply_perf_preset(RenderConfig())`` (patch sampling, K1's
patch_rows mode) against the JAX package's, same weights (flax initialiser,
carried by ``params_from_jax``), same scene, same noise, at two geometries:

  24x32: the preset's 4x2 ray blocks (6x4-pixel rows);
  22x32: a height that is not a multiple of 4, where both sides warn and
         take 2x2 blocks (4x4-pixel rows).

Bounds are the JAX package's own for its fast paths (tests/test_gnt_model.py):
rgb 0.04, depth 0.1, inbound count 0.02; the dynamic layer 1e-4. The JAX side
runs mono4 on patch rows in bf16 (Pallas interpret mode); the port's CPU path
runs the float32 combine and the plain float32 network.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.config import apply_perf_preset as j_apply_perf_preset
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models, resolve_epipolar_cfg

TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02}
W, V, S = 32, 3, 16
BLOCK = {24: "4x2", 22: "2x2"}


@pytest.fixture(scope="module", params=[24, 22], ids=["4x2", "2x2"])
def both(request):
    h = request.param
    data = make_contract_data(h=h, w=W, n_spatial=V, n_frames=6)
    cfg_j = j_apply_perf_preset(
        JRenderConfig(n_coarse_samples_per_ray=S, ray_tile=256, knn_tile=256))
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}

    import pgdvs_tpu.kernels.gnt_fused_mono4 as m4

    calls = []
    real = m4.gnt_fused_apply_mono4

    def counting(*a, **kw):
        calls.append(kw.get("patch_rows") is not None)
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        mp.setattr(m4, "gnt_fused_apply_mono4", counting)
        ref = jax.jit(
            lambda p: j_render_novel_view(models, p, jdata, cfg_j, key, static_mode="gnt")
        )(params)
        ref = jax.tree_util.tree_map(np.asarray, ref)

    fnet, gnt = init_gnt_models(device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
    gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
    noise = np.array(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
             if isinstance(v, np.ndarray)}
    cfg = apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=S, ray_tile=256))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = render_novel_view((fnet, gnt), tdata, cfg, noise=torch.from_numpy(noise))
    return {"h": h, "ref": ref, "got": got, "cfg": cfg, "gnt": gnt, "mono4_calls": calls,
            "warned": {"jax": [str(w.message) for w in jw],
                       "port": [str(w.message) for w in tw]}}


def test_both_sides_take_the_patch_block(both):
    """The JAX side ran mono4 on patch rows only; both sides warned of the
    2x2 fallback exactly where the height is not a multiple of 4; the
    port's resolution picks the same block."""
    assert both["mono4_calls"] and all(both["mono4_calls"])
    assert both["cfg"].epipolar_mode == "patch"
    h = both["h"]
    cfg, block = resolve_epipolar_cfg(both["cfg"], both["gnt"], h, W)
    assert (cfg.epipolar_mode, block) == ("patch", BLOCK[h])
    for side in ("jax", "port"):
        fell_back = [m for m in both["warned"][side] if "falling back to '2x2'" in m]
        assert bool(fell_back) == (h % 4 != 0), (side, both["warned"][side])
        assert not [m for m in both["warned"][side] if "falling back to 'quad'" in m]


@pytest.mark.parametrize("key", ["combined_rgb", "static_coarse_rgb",
                                 "static_coarse_depth", "static_coarse_inbound_cnt"])
def test_patch_render_matches_jax(both, key):
    tol = TOL[key.rsplit("_", 1)[-1] if "cnt" not in key else "inbound_cnt"]
    got = both["got"][key].numpy()
    ref = both["ref"][key]
    assert got.shape == ref.shape == (both["h"], W) + ref.shape[2:]
    np.testing.assert_allclose(got, ref, atol=tol)


def test_patch_render_dynamic_layer(both):
    for key in ("render_dyn_rgb", "render_dyn_mask"):
        np.testing.assert_allclose(both["got"][key].numpy(), both["ref"][key], atol=1e-4)


def test_patch_falls_back_to_quad_as_jax_does():
    """The dyn mask, odd render dims and a tile that is not a multiple of 8
    leave patch for quad with a warning; off the patch path nothing moves."""
    gnt = init_gnt_models(device="cpu")[1]
    base = apply_perf_preset(RenderConfig())
    for cfg, rh, rw in ((base.replace(gnt_use_dyn_mask=True, epipolar_mode="patch"), 24, 32),
                        (base, 24, 31), (base.replace(ray_tile=252), 24, 32)):
        with pytest.warns(UserWarning, match="falling back to 'quad'"):
            got, block = resolve_epipolar_cfg(cfg, gnt, rh, rw)
        assert (got.epipolar_mode, block) == ("quad", None)
    for mode in ("quad", "exact"):
        cfg = base.replace(epipolar_mode=mode)
        assert resolve_epipolar_cfg(cfg, gnt, 22, 31) == (cfg, None)
