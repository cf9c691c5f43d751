"""The exact-sampler slice end to end: the port's ``render_novel_view`` on
the exact preset against the JAX package's with ``epipolar_mode="exact"``
and ``pallas_kernel="split"`` (the split view / ray kernels in Pallas
interpret mode), same weights (flax initialiser, carried by
``params_from_jax``), same scene, same noise. Two configurations: the
`default` bundle (masked view attention, outlier removal) and the unmasked
``RenderConfig()``.

Bounds are those of tests/test_torch_port_default.py, the JAX package's own
for its fast paths (tests/test_gnt_model.py): rgb 0.04, depth 0.1, inbound
and dynamic counts 0.02. The JAX side runs in bf16, the port's CPU path the
plain float32 half-blocks.
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
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02, "dyn_cnt": 0.02}
H, W, V, S = 24, 32, 3, 16
SMALL = dict(n_coarse_samples_per_ray=S, ray_tile=256)


def _configs(name):
    """(JAX config, port config) of ``name``: the `default` bundle on the
    exact preset, or the unmasked ``RenderConfig()``."""
    if name == "default":
        cfg_j = j_resolve_benchmark("default", preset="exact")[0]
        cfg = resolve_benchmark("default", preset="exact")[0]
    else:
        cfg_j, cfg = JRenderConfig(), RenderConfig()
    # the ray tile is a multiple of pallas_ray_block, so JAX takes the kernel
    cfg_j = cfg_j.replace(pallas_kernel="split", knn_tile=256, **SMALL)
    assert cfg_j.epipolar_mode == "exact" and 256 % cfg_j.pallas_ray_block == 0
    return cfg_j, cfg.replace(**SMALL)


@pytest.fixture(scope="module", params=["default", "unmasked"])
def both(request):
    data = make_contract_data(h=H, w=W, n_spatial=V, n_frames=6)
    cfg_j, cfg = _configs(request.param)
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}

    import pgdvs_tpu.kernels.gnt_fused as split

    calls = []
    real = split.gnt_fused_apply

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(split, "gnt_fused_apply", counting)
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
    got = render_novel_view((fnet, gnt), tdata, cfg, noise=torch.from_numpy(noise))
    return {"ref": ref, "got": got, "split_calls": len(calls), "cfg": cfg}


def test_jax_side_took_the_split_kernel(both):
    assert both["split_calls"] >= 1


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
