"""The exact-sampler slice end to end: the port's ``render_novel_view`` on
the exact preset against the JAX package's with ``epipolar_mode="exact"``,
same weights (flax initialiser, carried by ``params_from_jax``), same
scene, same noise. Two configurations: the `default` bundle (masked view
attention, outlier removal) and the unmasked ``RenderConfig()``; each
against two JAX programs: the one JAX's config runs unforced (mono3 in its
unfolded mode, Pallas in interpret mode: what the port runs on K2) and JAX
forced onto ``pallas_kernel="split"`` (the split view / ray kernels).

Bounds are those of tests/test_torch_port_default.py, the JAX package's own
for its fast paths (tests/test_gnt_model.py): rgb 0.04, depth 0.1, inbound
and dynamic counts 0.02. The JAX side runs in bf16, the port's CPU path the
plain float32 network on K2's bf16 operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.kernels import gnt_fused_mono3 as k2
from pgdvs_tpu_torch.kernels import gnt_fused_split as k3
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers import static_gnt
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02, "dyn_cnt": 0.02}
H, W, V, S = 24, 32, 3, 16
SMALL = dict(n_coarse_samples_per_ray=S, ray_tile=256)


def _configs(name, forced):
    """(JAX config, port config) of ``name``: the `default` bundle on the
    exact preset, or the unmasked ``RenderConfig()``; JAX forced onto the
    split kernels or not."""
    if name == "default":
        cfg_j = j_resolve_benchmark("default", preset="exact")[0]
        cfg = resolve_benchmark("default", preset="exact")[0]
    else:
        cfg_j, cfg = JRenderConfig(), RenderConfig()
    # the ray tile is a multiple of pallas_ray_block, so JAX takes a kernel
    cfg_j = cfg_j.replace(knn_tile=256, **SMALL)
    if forced:
        cfg_j = cfg_j.replace(pallas_kernel="split")
    assert cfg_j.epipolar_mode == "exact" and 256 % cfg_j.pallas_ray_block == 0
    return cfg_j, cfg.replace(**SMALL)


def _counting(mp, module, name, calls):
    real = getattr(module, name)

    def counting(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    mp.setattr(module, name, counting)


_PORT = {}  # the port's render of a configuration, shared by both JAX programs


@pytest.fixture(scope="module",
                params=["default", "unmasked", "default_unforced", "unmasked_unforced"])
def both(request):
    name, forced = request.param.split("_")[0], not request.param.endswith("_unforced")
    data = make_contract_data(h=H, w=W, n_spatial=V, n_frames=6)
    cfg_j, cfg = _configs(name, forced)
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}

    import pgdvs_tpu.kernels.gnt_fused as split
    import pgdvs_tpu.kernels.gnt_fused_mono3 as m3

    calls = {"split": [], "mono3": []}
    with pytest.MonkeyPatch.context() as mp:
        _counting(mp, split, "gnt_fused_apply", calls["split"])
        _counting(mp, m3, "gnt_fused_apply_mono3", calls["mono3"])
        ref = jax.jit(
            lambda p: j_render_novel_view(models, p, jdata, cfg_j, key,
                                          static_mode="gnt")
        )(params)
        ref = jax.tree_util.tree_map(np.asarray, ref)

    if name not in _PORT:
        fnet, gnt = init_gnt_models(device="cpu")
        np_params = jax.tree_util.tree_map(np.asarray, params)
        fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
        gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
        noise = np.array(jax.random.normal(key, data["rgb_src_temporal"][0].shape,
                                           jnp.float32))
        tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
                 if isinstance(v, np.ndarray)}
        _PORT[name] = render_novel_view((fnet, gnt), tdata, cfg,
                                        noise=torch.from_numpy(noise))
    return {"ref": ref, "got": _PORT[name], "forced": forced,
            "split_calls": len(calls["split"]), "mono3_calls": calls["mono3"],
            "cfg": cfg}


def test_jax_side_took_the_split_kernel(both):
    """The split kernels run exactly when JAX is forced onto them."""
    assert (both["split_calls"] >= 1) == both["forced"]


def test_jax_side_took_mono3_unfolded_unforced(both):
    """Unforced, JAX's exact default runs mono3 with every operand read: no
    fused maps, so no fold (``pgdvs_tpu/renderers/static_gnt.py:128-168``)."""
    calls = both["mono3_calls"]
    if both["forced"]:
        assert not calls
        return
    assert calls
    for kw in calls:
        assert not (kw.get("separate_mask") or kw.get("fold_pos_code")
                    or kw.get("fold_lerp") or kw.get("fold_mask_hw") is not None
                    or kw.get("pts") is not None)


def test_same_output_keys(both):
    assert sorted(both["got"]) == sorted(both["ref"])


@pytest.mark.parametrize("key", ["combined_rgb", "static_coarse_rgb",
                                 "static_coarse_depth", "static_coarse_inbound_cnt",
                                 "static_coarse_dyn_cnt"])
def test_exact_render_matches_jax(both, key):
    if key == "static_coarse_dyn_cnt" and not both["cfg"].gnt_use_dyn_mask:
        assert not both["got"][key].any() and not both["ref"][key].any()
        return
    tol = next(t for name, t in TOL.items() if key.endswith(name))
    got = both["got"][key].numpy()
    ref = both["ref"][key]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol)


def test_exact_render_sees_dynamic_views(both):
    """With the dyn mask, some rays (not all) have dynamic views."""
    dyn_cnt = both["got"]["static_coarse_dyn_cnt"].numpy()
    frac = float(np.mean(dyn_cnt > 0))
    assert (0.0 < frac < 1.0) if both["cfg"].gnt_use_dyn_mask else frac == 0.0


def test_exact_route_runs_k2_unfolded(monkeypatch):
    """The exact sampler's tiles go to K2's unfolded mode, as the JAX
    package's RenderConfig() runs mono3 there, not to the split kernels."""
    modes, split_calls = [], []
    real = k2.gnt_fused_apply_mono3

    def spy(*a, **kw):
        modes.append(k2.mono3_operands(*a[1:], **kw).mode)
        return real(*a, **kw)

    monkeypatch.setattr(static_gnt, "gnt_fused_apply_mono3", spy)
    monkeypatch.setattr(k3, "gnt_fused_split", lambda *a, **kw: split_calls.append(1))
    data = make_contract_data(h=H, w=W, n_spatial=2, n_frames=4)
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
             if isinstance(v, np.ndarray)}
    cfg = RenderConfig(n_coarse_samples_per_ray=8, ray_tile=256)
    out = render_novel_view(init_gnt_models(device="cpu"), tdata, cfg,
                            noise=torch.zeros(H, W, 3))
    assert modes == ["unfolded"] * 3 and not split_calls  # 768 rays, tiles of 256
    assert torch.isfinite(out["combined_rgb"]).all()
