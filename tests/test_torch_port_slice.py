"""The ported slice end to end: the port's ``render_novel_view`` against the
JAX package's on the quad sampler + mono4 (the fast preset with
``epipolar_mode="quad"`` on both sides; the preset's own patch sampler is
held in test_torch_port_patch_render.py), same weights (flax initialiser,
carried by ``params_from_jax``), same scene, same noise.

Bounds are the JAX package's own for its fast paths against quad
(tests/test_gnt_model.py): rgb 0.04, depth 0.1, inbound_cnt 0.02. The JAX
side runs mono4 in bf16 (Pallas interpret mode); the port's CPU path runs
the plain float32 network.
"""

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
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02}


@pytest.fixture(scope="module")
def both():
    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)
    cfg_j = j_apply_perf_preset(
        JRenderConfig(n_coarse_samples_per_ray=16, ray_tile=256, knn_tile=256)
    ).replace(epipolar_mode="quad")
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=3)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}

    import pgdvs_tpu.kernels.gnt_fused_mono4 as m4

    calls = []
    real = m4.gnt_fused_apply_mono4

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m4, "gnt_fused_apply_mono4", counting)
        ref = jax.jit(
            lambda p: j_render_novel_view(models, p, jdata, cfg_j, key,
                                          static_mode="gnt")
        )(params)
        ref = jax.tree_util.tree_map(np.asarray, ref)

    fnet, gnt = init_gnt_models(device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
    gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
    noise = np.array(jax.random.normal(key, data["rgb_src_temporal"][0].shape,
                                         jnp.float32))
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
             if isinstance(v, np.ndarray)}
    cfg = apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=16, ray_tile=256)).replace(
        epipolar_mode="quad")
    got = render_novel_view((fnet, gnt), tdata, cfg,
                            noise=torch.from_numpy(noise))
    return {"ref": ref, "got": got, "mono4_calls": len(calls), "models": (fnet, gnt),
            "tdata": tdata, "cfg": cfg, "noise": torch.from_numpy(noise)}


def test_jax_side_took_mono4(both):
    assert both["mono4_calls"] >= 1


def test_same_output_keys(both):
    assert sorted(both["got"]) == sorted(both["ref"])


@pytest.mark.parametrize("key", ["combined_rgb", "static_coarse_rgb",
                                 "static_coarse_depth", "static_coarse_inbound_cnt"])
def test_slice_matches_jax(both, key):
    tol = TOL[key.rsplit("_", 1)[-1] if "cnt" not in key else "inbound_cnt"]
    got = both["got"][key].numpy()
    ref = both["ref"][key]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize("key", ["render_dyn_rgb", "render_dyn_mask"])
def test_slice_dynamic_layer(both, key):
    np.testing.assert_allclose(both["got"][key].numpy(), both["ref"][key], atol=1e-4)


def test_slice_oob_mask(both):
    """The out-of-bounds mask thresholds inbound_cnt at 1/V: it may differ
    only where the reference count lies within the count tolerance of it."""
    got = both["got"]["static_coarse_oob_mask"].numpy()
    ref = both["ref"]["static_coarse_oob_mask"]
    cnt = both["ref"]["static_coarse_inbound_cnt"]
    near = np.abs(cnt - 1.0 / 3.0) <= TOL["inbound_cnt"]
    assert np.all((got == ref) | near)


def test_slice_refuses_configs_outside_it(both):
    """Unknown modes raise, an unknown track mode among them (the geo static
    mode and the pcl / mesh dynamic layers render:
    tests/test_torch_port_geo.py; the track branch with a tracker:
    tests/test_torch_port_track.py). The track mode the port carries,
    "no_tgt", renders without a tracker as JAX's renderer does, skipping
    the branch: the same dynamic layer as JAX's render of this view."""
    data = make_contract_data(h=8, w=8, n_spatial=2, n_frames=3)
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
             if isinstance(v, np.ndarray)}
    models = init_gnt_models(device="cpu")
    base = apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=4))
    for cfg, mode in ((base.replace(dyn_render_type="splat"), "gnt"),
                      (base, "mesh"),
                      (base.replace(dyn_render_type="pcl"), "point"),
                      (base.replace(dyn_render_track_temporal="always"), "gnt"),
                      (base.replace(epipolar_mode="quad_u4"), "gnt")):
        with pytest.raises(ValueError):
            render_novel_view(models, tdata, cfg, static_mode=mode)
    no_tgt = both["cfg"].replace(dyn_render_track_temporal="no_tgt")
    got = render_novel_view(both["models"], both["tdata"], no_tgt, noise=both["noise"])
    for key in ("render_dyn_rgb", "render_dyn_mask", "render_dyn_temporal_track_mask"):
        np.testing.assert_allclose(got[key].numpy(), both["ref"][key], atol=1e-4, err_msg=key)
    assert not got["render_dyn_temporal_track_mask"].any()
