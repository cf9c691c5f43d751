"""The paper's `default` bundle end to end: the port's ``render_novel_view``
with ``resolve_benchmark("default")`` (masked view attention + outlier
removal of the dynamic cloud) against the JAX package's, same weights (flax
initialiser, carried by ``params_from_jax``), same scene, same noise.

Bounds are the JAX package's own for its fast paths against quad
(tests/test_gnt_model.py): rgb 0.04, depth 0.1, inbound and dynamic counts
0.02; the dynamic layer 1e-4. The JAX side runs mono3 in bf16 (Pallas
interpret mode); the port's CPU path runs the plain float32 network.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.dynamic import render_dynamic as j_render_dynamic
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.dynamic import compute_dyn_pointcloud
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02, "dyn_cnt": 0.02}
H, W, V, S = 24, 32, 3, 16


def _tdata(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()
            if isinstance(v, np.ndarray)}


@pytest.fixture(scope="module")
def both():
    data = make_contract_data(h=H, w=W, n_spatial=V, n_frames=6)
    cfg_j = j_resolve_benchmark("default")[0].replace(
        n_coarse_samples_per_ray=S, ray_tile=256, knn_tile=256)
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}

    import pgdvs_tpu.kernels.gnt_fused_mono3 as m3

    calls = []
    real = m3.gnt_fused_apply_mono3

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m3, "gnt_fused_apply_mono3", counting)
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
    cfg = resolve_benchmark("default")[0].replace(n_coarse_samples_per_ray=S,
                                                  ray_tile=256)
    got = render_novel_view((fnet, gnt), _tdata(data), cfg,
                            noise=torch.from_numpy(noise))
    return {"ref": ref, "got": got, "mono3_calls": len(calls), "data": data,
            "cfg": cfg, "models": (fnet, gnt)}


def test_jax_side_took_mono3(both):
    assert both["mono3_calls"] >= 1


def test_same_output_keys(both):
    assert sorted(both["got"]) == sorted(both["ref"])


@pytest.mark.parametrize("key", ["combined_rgb", "static_coarse_rgb",
                                 "static_coarse_depth", "static_coarse_inbound_cnt",
                                 "static_coarse_dyn_cnt"])
def test_default_matches_jax(both, key):
    tol = next(t for name, t in TOL.items() if key.endswith(name))
    got = both["got"][key].numpy()
    ref = both["ref"][key]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol)


def test_default_sees_dynamic_views(both):
    """The scene's dynamic square lands in the sources: some rays have
    dynamic views, and the masked attention changes the render."""
    dyn_cnt = both["got"]["static_coarse_dyn_cnt"].numpy()
    assert 0.0 < float(np.mean(dyn_cnt > 0)) < 1.0


@pytest.mark.parametrize("key,thres", [("dyn_mask_any", 0.0), ("dyn_mask_all", 1.0),
                                       ("dyn_mask_thres", 4.0 / V)])
def test_default_dyn_masks(both, key, thres):
    """Thresholds of dyn_cnt: equal except where the JAX count lies within
    the count tolerance of the threshold."""
    got = both["got"][f"static_coarse_{key}"].numpy()
    ref = both["ref"][f"static_coarse_{key}"]
    cnt = both["ref"]["static_coarse_dyn_cnt"]
    near = np.abs(cnt - thres) <= TOL["dyn_cnt"]
    assert got.shape == ref.shape
    assert np.all((got == ref) | near)


@pytest.mark.parametrize("key", ["render_dyn_rgb", "render_dyn_mask"])
def test_default_dynamic_layer(both, key):
    np.testing.assert_allclose(both["got"][key].numpy(), both["ref"][key], atol=1e-4)


def test_default_outlier_removal_drops_points(both):
    """The bundle's outlier removal runs on the dynamic cloud and removes
    some of its points, but not most."""
    td = _tdata(both["data"])
    kw = dict(
        rgb_1=td["rgb_src_temporal"][0], dyn_mask_1=td["dyn_mask_src_temporal"][0],
        depth_1=td["depth_src_temporal"][0], flow_12=td["flow_fwd"],
        flow_12_occ_mask=td["flow_fwd_occ_mask"], rgb_2=td["rgb_src_temporal"][1],
        depth_2=td["depth_src_temporal"][1], cam_1=td["flat_cam_src_temporal"][0],
        cam_2=td["flat_cam_src_temporal"][1], cam_tgt=td["flat_cam_tgt"],
        time_1=td["time_src_temporal"][0], time_2=td["time_src_temporal"][1],
        time_tgt=td["time_tgt"][0])
    cfg = both["cfg"]
    kept = int(compute_dyn_pointcloud(cfg=cfg, **kw)["valid"].sum())
    cand = int(compute_dyn_pointcloud(
        cfg=cfg.replace(dyn_pcl_remove_outlier=False), **kw)["valid"].sum())
    assert 0.5 * cand < kept < cand


def test_masked_bundles_refuse_what_stays_outside(both):
    """An unknown track mode, an unknown static mode and a contract without
    the dynamic masks raise; the point and mesh bundles render (below). The
    track bundle renders too: given no tracker it skips the branch, as
    JAX's renderer does, so it is this view's `default` render, held
    against JAX's (with LK it is held in tests/test_torch_port_track.py)."""
    data = make_contract_data(h=8, w=8, n_spatial=2, n_frames=3)
    models = init_gnt_models(device="cpu")
    base = resolve_benchmark("default")[0].replace(n_coarse_samples_per_ray=4)
    with pytest.raises(ValueError, match="dyn_render_track_temporal"):
        render_novel_view(models, _tdata(data), base.replace(dyn_render_track_temporal="always"))
    with pytest.raises(ValueError, match="static_mode"):
        render_novel_view(models, _tdata(data), base, static_mode="mesh")
    no_masks = {k: v for k, v in _tdata(data).items() if k != "dyn_mask_src_spatial"}
    with pytest.raises(ValueError, match="dynamic masks"):
        render_novel_view(models, no_masks, base)
    cfg = resolve_benchmark("st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir")[0].replace(
        n_coarse_samples_per_ray=S, ray_tile=256)
    assert cfg.dyn_render_track_temporal == "no_tgt"
    noise = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                       both["data"]["rgb_src_temporal"][0].shape, jnp.float32))
    got = render_novel_view(both["models"], _tdata(both["data"]), cfg,
                            noise=torch.from_numpy(noise))
    ref = both["ref"]
    assert sorted(got) == sorted(ref)
    for key in ("combined_rgb", "static_coarse_rgb"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=TOL["rgb"], err_msg=key)
    for key in ("render_dyn_rgb", "render_dyn_mask", "render_dyn_temporal_track_mask"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=1e-4, err_msg=key)


@pytest.mark.parametrize("bundle,kind", [
    ("st_gnt_masked_attn_dy_cvd_pcl_clean_render_point", "pcl"),
    ("st_gnt_masked_attn_dy_cvd_pcl_clean_render_mesh", "mesh")])
def test_masked_point_and_mesh_bundles_render(both, bundle, kind):
    """The `default` bundle with the dynamic layer rasterized as points
    (radius 0.1 NDC, 1.2 pixels here) or as a grid mesh: the static layer
    is `default`'s bit for bit (the same GNT configuration), the dynamic
    layer JAX's (``render_dynamic``) at 1e-5 with equal masks, the
    composite within the `default` rgb bound of JAX's static layer
    composited with JAX's dynamic layer."""
    over = dict(n_coarse_samples_per_ray=S, ray_tile=256, dyn_render_pcl_pt_radius=0.1)
    cfg = resolve_benchmark(bundle)[0].replace(**over)
    cfg_j = j_resolve_benchmark(bundle)[0].replace(**over, knn_tile=256)
    assert cfg.dyn_render_type == kind
    got = render_novel_view(both["models"], _tdata(both["data"]), cfg)
    dyn = j_render_dynamic({k: v for k, v in both["data"].items() if k != "misc"}, cfg_j,
                           jax.random.PRNGKey(1))
    np.testing.assert_array_equal(got["static_coarse_rgb"].numpy(),
                                  both["got"]["static_coarse_rgb"].numpy())
    mask = np.asarray(dyn["mask"])
    assert mask.sum() > 0
    np.testing.assert_array_equal(got["render_dyn_mask"].numpy(), mask)
    np.testing.assert_allclose(got["render_dyn_rgb"].numpy(), np.asarray(dyn["rgb"]),
                               rtol=1e-5, atol=1e-5)
    want = (1.0 - mask) * both["ref"]["static_coarse_rgb"] + mask * np.asarray(dyn["rgb"])
    np.testing.assert_allclose(got["combined_rgb"].numpy(), want, atol=TOL["rgb"])


def test_pure_gnt_with_dyn_mask_returns_the_static_layer():
    data = make_contract_data(h=H, w=W, n_spatial=2, n_frames=3)
    cfg = resolve_benchmark("st_gnt_masked_attn")[0].replace(n_coarse_samples_per_ray=4)
    out = render_novel_view(init_gnt_models(device="cpu"), _tdata(data), cfg)
    assert torch.equal(out["combined_rgb"], out["static_coarse_rgb"])
    assert "static_coarse_dyn_mask_thres" in out and "render_dyn_rgb" not in out


def test_init_gnt_models_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU."""
    default = inspect.signature(init_gnt_models).parameters["device"].default
    assert default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            init_gnt_models()
