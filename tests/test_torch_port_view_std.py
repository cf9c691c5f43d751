"""The GNT's view-std diagnostics in the port: ``masked_view_std``, the GNT
made with ``ret_view_std=True`` against the JAX package's flax GNT, the
render's view-std maps against the JAX package's, and the route (the plain
network, never a hand kernel's wrapper).

Bounds: ``masked_view_std`` and the float32 network at 1e-5 / 1e-4 (the
same float32 arithmetic in another order); renders at the JAX package's
bounds for its fast paths (tests/test_gnt_model.py): rgb 0.04, depth 0.1,
inbound and dynamic counts 0.02; the view-std maps (per-block feature stds
of 0.4-1.5 here) at 0.01, twice the largest deviation measured between the
port's float32 network on bf16 samples and JAX's bf16 flax network. The
JAX side computes the diagnostics on its flax network, as it always does.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.models.gnt import network as jnet
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.models.gnt.network import GNT, masked_view_std
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers import static_gnt
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02, "dyn_cnt": 0.02, "view_std": 0.01,
       "view_std_normalized": 0.01}


def test_masked_view_std_matches_jax():
    """Tokens with 0, 1, some and all valid views."""
    rng = np.random.default_rng(0)
    k = rng.normal(0, 1, (6, 5, 4, 16)).astype(np.float32)           # [R, S, V, C]
    valid = (rng.uniform(size=(6, 5, 4, 1)) > 0.5).astype(np.float32)
    valid[0] = 0.0
    valid[1] = 0.0
    valid[1, :, 2] = 1.0
    valid[2] = 1.0
    ref = jnet.masked_view_std(k, valid)
    got = masked_view_std(torch.from_numpy(k), torch.from_numpy(valid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    std, norm_std = (g.numpy() for g in got)
    assert not std[1].any() and not norm_std[1].any()                 # one valid view
    np.testing.assert_allclose(std[0], np.std(k[0], axis=-2, ddof=1), rtol=1e-5)  # none
    np.testing.assert_allclose(std[2], np.std(k[2], axis=-2, ddof=1), rtol=1e-5)  # all


@pytest.fixture(scope="module")
def networks():
    """JAX's float32 flax GNT with the diagnostics, and the port's GNT
    (ret_view_std=True) carrying the same parameters through
    ``params_from_jax``; a 4-ray x 9-sample x 3-view input with tokens
    whose views are all invalid."""
    jgnt = jnet.GNT(dtype="float32", ret_view_std=True)
    rng = np.random.default_rng(1)
    r, s, v = 4, 9, 3
    inputs = (rng.normal(0, 1, (r, s, v, 35)).astype(np.float32),
              rng.normal(0, 1, (r, s, v, 4)).astype(np.float32),
              (rng.uniform(size=(r, s, v, 1)) > 0.4).astype(np.float32),
              rng.normal(0, 1, (r, s, 3)).astype(np.float32),
              rng.normal(0, 1, (r, 3)).astype(np.float32))
    inputs[2][0, :4] = 0.0
    params = jgnt.init(jax.random.PRNGKey(3), *inputs)
    gnt = GNT(ret_view_std=True)
    gnt.load_state_dict(gnt_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jgnt, params, gnt.eval(), inputs


def test_ret_view_std_gnt_matches_flax_f32(networks):
    jgnt, params, gnt, inputs = networks
    ref = jgnt.apply(params, *inputs)
    with torch.no_grad():
        got = gnt(*(torch.from_numpy(x) for x in inputs))
    assert sorted(got) == sorted(ref)
    assert tuple(got["view_std"].shape) == (4, 9, gnt.depth + 1)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    # entry 0 is over all views; a block's entry is 0 where one view is valid
    assert (got["view_std"][..., 0] > 0).all() and (got["view_std"] > 0).float().mean() > 0.5


def test_the_flag_adds_outputs_only(networks):
    """The same parameters load into the network without the diagnostics,
    which returns the same rgb and weights and no view-std maps."""
    _jgnt, _params, gnt, inputs = networks
    plain = GNT()
    plain.load_state_dict(gnt.state_dict())
    with torch.no_grad():
        a = gnt(*(torch.from_numpy(x) for x in inputs))
        b = plain.eval()(*(torch.from_numpy(x) for x in inputs))
    assert sorted(b) == ["rgb", "weights"]
    for key in b:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


# ---------------------------------------------------------------- renders

H, W, V, S = 24, 32, 3, 8


def _configs(name):
    """The unmasked exact default, or the `default` bundle on the fast
    preset (quad with the dyn mask). JAX refuses its unmasked fast preset
    with the diagnostics (its mono4-only knob and the flax path's mono3
    fallback), so that one is not a comparison."""
    small = dict(n_coarse_samples_per_ray=S, ray_tile=H * W)
    if name == "exact":
        return JRenderConfig(knn_tile=256, **small), RenderConfig(**small)
    return (j_resolve_benchmark("default")[0].replace(knn_tile=256, **small),
            resolve_benchmark("default")[0].replace(**small))


@pytest.fixture(scope="module", params=["exact", "default"])
def rendered(request):
    data = make_contract_data(h=H, w=W, n_spatial=V, n_frames=6)
    cfg_j, cfg = _configs(request.param)
    models = make_gnt_models(ret_view_std=True)
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: j_render_novel_view(models, p, jdata, cfg_j, key, static_mode="gnt")
    )(params))
    fnet, gnt = init_gnt_models(device="cpu", ret_view_std=True)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
    gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
    noise = np.array(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
             if isinstance(v, np.ndarray)}
    got = render_novel_view((fnet, gnt), tdata, cfg, noise=torch.from_numpy(noise))
    return {"ref": ref, "got": got, "cfg": cfg}


@pytest.mark.parametrize("key", ["combined_rgb", "static_coarse_rgb", "static_coarse_depth",
                                 "static_coarse_inbound_cnt", "static_coarse_dyn_cnt",
                                 "static_coarse_view_std",
                                 "static_coarse_view_std_normalized"])
def test_view_std_render_matches_jax(rendered, key):
    got, ref = rendered["got"][key].numpy(), rendered["ref"][key]
    assert got.shape == ref.shape and np.isfinite(got).all()
    tol = TOL[next(name for name in sorted(TOL, key=len, reverse=True) if key.endswith(name))]
    np.testing.assert_allclose(got, ref, atol=tol)
    if "view_std" in key:
        assert got.shape[-1] == 9 and (got > 0).mean() > 0.9


def test_view_std_route_is_the_plain_network(monkeypatch):
    """With ret_view_std no kernel wrapper is called, only the plain
    versions (the fast preset's patch falls back to quad with a warning, as
    in JAX); without it the wrappers run and the maps are zero."""
    calls = []
    for name in ("gnt_fused_mono4", "gnt_fused_mono4_patch", "gnt_fused_mono3",
                 "gnt_fused_apply_mono3", "gnt_fused_mono4_plain",
                 "gnt_fused_mono4_patch_plain", "gnt_fused_mono3_plain",
                 "gnt_fused_apply_mono3_plain"):
        real = getattr(static_gnt, name)
        monkeypatch.setattr(static_gnt, name,
                            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw))
    data = make_contract_data(h=H, w=W, n_spatial=2, n_frames=4)
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
             if isinstance(v, np.ndarray)}
    cfg = apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=4, ray_tile=256))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = render_novel_view(init_gnt_models(device="cpu", ret_view_std=True), tdata, cfg,
                                noise=torch.zeros(H, W, 3))
    assert any("view-std" in str(w.message) for w in caught)
    assert calls == ["gnt_fused_mono4_plain"] * 3  # 768 rays in tiles of 256, quad
    assert (out["static_coarse_view_std"] > 0).all()
    calls.clear()
    out = render_novel_view(init_gnt_models(device="cpu"), tdata, cfg, noise=torch.zeros(H, W, 3))
    assert calls == ["gnt_fused_mono4_patch"] * 3
    assert not out["static_coarse_view_std"].any()
