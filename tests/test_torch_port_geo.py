"""The point-cloud renderers and the pure-geometry reader of the port
against the JAX package's, on the CPU, from the same numpy inputs.

``rasterize_points`` (radii whose footprint is 1-2 pixels, in NDC and in
pixels), ``grid_mesh_faces`` / ``rasterize_grid_mesh``, ``render_static_geo``
(with and without outlier removal), ``render_dynamic`` with
``dyn_render_type`` pcl and mesh, and ``render_novel_view(static_mode=
"geo")`` on the synthetic contract at 24x32 (the softsplat noise passed in
as the other port tests pass it); ``NvidiaPureGeoEvalDataset`` on the JAX
package's fixture scene (tests/test_datasets.py, 48x64), from its PNG mono
directory, from its JPEG mono frames, and under a capacity.

Alpha, masks and coverage are equal; rgb within 1e-5; the static cloud has
the same point count, its points within 1e-5. No coverage pixel flips at
these seeds, so none is excused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.nvidia_pure_geo import NvidiaPureGeoEvalDataset as JPureGeo
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.kernels.mesh_raster import grid_mesh_faces as j_faces
from pgdvs_tpu.kernels.mesh_raster import rasterize_grid_mesh as j_mesh
from pgdvs_tpu.kernels.point_raster import rasterize_points as j_points
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.dynamic import render_dynamic as j_render_dynamic
from pgdvs_tpu.renderers.static_geo import render_static_geo as j_static_geo
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.core import cameras
from pgdvs_tpu_torch.core.geometry import unproject_depth
from pgdvs_tpu_torch.data.combined import CombinedDataset
from pgdvs_tpu_torch.data.nvidia_pure_geo import NvidiaPureGeoEvalDataset
from pgdvs_tpu_torch.kernels.mesh_raster import grid_mesh_faces, rasterize_grid_mesh
from pgdvs_tpu_torch.kernels.point_raster import footprint_px, rasterize_points
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.dynamic import render_dynamic
from pgdvs_tpu_torch.renderers.static_geo import render_static_geo
from test_datasets import H as FH
from test_datasets import build_fake_scene

TOL = dict(rtol=1e-5, atol=1e-5)
H, W = 24, 32
# NDC radii at 24x32: 1.2 pixels (a 5x5 footprint) for the point layers
RADIUS = 0.1


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def data():
    return make_contract_data(h=H, w=W, n_spatial=2, n_frames=6)


def _tdata(data):
    return {k: _t(v) for k, v in data.items() if isinstance(v, np.ndarray)}


def _jdata(data):
    return {k: v for k, v in data.items() if k != "misc"}


@pytest.mark.parametrize("radius,ndc", [(0.125, True), (RADIUS, True), (1.0, False)])
def test_rasterize_points_matches_jax(data, radius, ndc):
    """The static cloud of the contract, a fifth of it masked out, into the
    target camera."""
    pcl = data["st_pcl_rgb"]
    valid = np.random.default_rng(0).random(pcl.shape[0]) > 0.2
    r_px, fp = footprint_px(radius, (H, W), ndc)
    assert 1.0 <= r_px <= 1.5 and fp in (1, 2)
    img, alpha = rasterize_points(_t(pcl[:, :3]), _t(pcl[:, 3:]), _t(data["flat_cam_tgt"]),
                                  (H, W), valid=_t(valid), radius=radius, ndc_radius=ndc)
    ref_img, ref_alpha = j_points(jnp.asarray(pcl[:, :3]), jnp.asarray(pcl[:, 3:]),
                                  jnp.asarray(data["flat_cam_tgt"]), (H, W),
                                  valid=jnp.asarray(valid), radius=radius, ndc_radius=ndc)
    assert 0.5 < float(alpha.mean()) < 1.0  # covered and uncovered pixels both occur
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(ref_alpha))
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), **TOL)


@pytest.mark.parametrize("hw", [(5, 7), (3, 2)])
def test_grid_mesh_faces_match_jax(hw):
    faces, ok = grid_mesh_faces(*hw)
    ref_faces, ref_ok = j_faces(*hw)
    np.testing.assert_array_equal(faces.numpy(), np.asarray(ref_faces))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))


@pytest.mark.parametrize("which", ["dyn_mask", "random"])
def test_rasterize_grid_mesh_matches_jax(data, which):
    """Temporal source 0 lifted by its depth, its dynamic pixels (or 90 %
    of all pixels, at random) as the valid vertices, into the target."""
    cam = _t(data["flat_cam_src_temporal"][0])
    verts = unproject_depth(data["depth_src_temporal"][0][..., 0], cameras.flat_cam_intrinsics(cam),
                            cameras.flat_cam_c2w(cam)).reshape(-1, 3).numpy()
    cols = data["rgb_src_temporal"][0].reshape(-1, 3)
    if which == "dyn_mask":
        valid = data["dyn_mask_src_temporal"][0].reshape(-1) > 0
    else:
        valid = np.random.default_rng(1).random(verts.shape[0]) > 0.1
    rgb, mask = rasterize_grid_mesh(_t(verts), _t(cols), _t(valid), _t(data["flat_cam_tgt"]),
                                    (H, W))
    ref_rgb, ref_mask = j_mesh(jnp.asarray(verts), jnp.asarray(cols), jnp.asarray(valid),
                               jnp.asarray(data["flat_cam_tgt"]), (H, W))
    assert float(mask.sum()) > 0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), **TOL)


def _cfgs(bundle, **overrides):
    ours = resolve_benchmark(bundle)[0].replace(**overrides)
    ref = j_resolve_benchmark(bundle)[0].replace(**overrides, knn_tile=256)
    return ours, ref


@pytest.mark.parametrize("bundle", ["st_cvd_dy_cvd", "st_cvd_pcl_clean_dy_cvd_pcl_clean"])
def test_render_static_geo_matches_jax(data, bundle):
    """The bundle's static layer, without and with the cloud's outlier
    removal (k 50, std 0.2), padded entries included."""
    cfg, cfg_j = _cfgs(bundle, st_render_pcl_pt_radius=RADIUS)
    pcl = np.concatenate([data["st_pcl_rgb"], np.zeros((31, 6), np.float32)])
    valid = np.arange(pcl.shape[0]) < data["st_pcl_rgb"].shape[0]
    rgb, mask = render_static_geo(_t(pcl), _t(data["flat_cam_tgt"]), (H, W), cfg,
                                  valid=_t(valid))
    ref_rgb, ref_mask = j_static_geo(jnp.asarray(pcl), jnp.asarray(data["flat_cam_tgt"]),
                                     (H, W), cfg_j, valid=jnp.asarray(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), **TOL)


@pytest.mark.parametrize("bundle,kind", [
    ("st_gnt_masked_attn_dy_cvd_pcl_clean_render_point", "pcl"),
    ("st_gnt_masked_attn_dy_cvd_pcl_clean_render_mesh", "mesh")])
def test_render_dynamic_matches_jax(data, bundle, kind):
    """The bundles' dynamic layer (outlier removal on): the dense cloud
    rasterized as points or as a grid mesh; no noise is drawn."""
    cfg, cfg_j = _cfgs(bundle, dyn_render_pcl_pt_radius=RADIUS)
    assert cfg.dyn_render_type == kind
    got = render_dynamic(_tdata(data), cfg)
    ref = j_render_dynamic(_jdata(data), cfg_j, jax.random.PRNGKey(1))
    assert float(got["mask"].sum()) > 0
    np.testing.assert_array_equal(got["pcl"]["valid"].numpy(), np.asarray(ref["pcl"]["valid"]))
    for key in ("mask", "temporal_closest_mask", "temporal_track_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in ("rgb", "temporal_closest_rgb", "temporal_track_rgb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("bundle,dyn", [
    ("st_cvd_dy_cvd", "softsplat"), ("st_cvd_dy_cvd_pcl_clean", "softsplat"),
    ("st_cvd_pcl_clean_dy_cvd_pcl_clean", "softsplat"), ("st_cvd_dy_cvd", "pcl")])
def test_render_novel_view_geo_matches_jax(data, bundle, dyn):
    """The three pure-geometry bundles end to end with no models, and one
    with the point-rasterized dynamic layer; every output key."""
    cfg, cfg_j = _cfgs(bundle, st_render_pcl_pt_radius=RADIUS,
                       dyn_render_pcl_pt_radius=RADIUS, dyn_render_type=dyn)
    key = jax.random.PRNGKey(2)
    noise = np.asarray(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
    got = render_novel_view(None, _tdata(data), cfg, static_mode="geo", noise=_t(noise))
    ref = j_render_novel_view(None, None, _jdata(data), cfg_j, key, static_mode="geo")
    assert sorted(got) == sorted(ref)
    assert 0 < float(got["render_dyn_mask"].mean()) < 1
    for k, r in ref.items():
        r = np.asarray(r)
        if k.endswith("mask"):
            np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), r, **TOL, err_msg=k)


# ------------------------------------------------------------- the reader

DIRS = dict(raw_data_dir="raw", depth_data_dir="depths", mask_data_dir="flowmask",
            flow_data_dir="flowmask", tgt_height=FH, n_src_views_spatial=3)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """"png": the fixture as written (the images_64x48 mono directory);
    "jpeg": that directory removed, so the cloud's colours come from the
    JPEG mono frames."""
    png = build_fake_scene(tmp_path_factory.mktemp("geo_png"))
    jpg = build_fake_scene(tmp_path_factory.mktemp("geo_jpeg"))
    mono = jpg / "raw" / "Balloon1" / "dense" / "images_64x48"
    for f in mono.iterdir():
        f.unlink()
    mono.rmdir()
    return {"png": png, "jpeg": jpg}


@pytest.mark.parametrize("variant,capacity", [("png", 0), ("jpeg", 0), ("png", 1000)])
def test_pure_geo_reader_matches_jax(scenes, variant, capacity):
    """Two items (one in the mono video, one held out): the static cloud
    with the same point count and its points within 1e-5, its valid mask
    equal, every other contract key at 1e-5; under a capacity the strided
    cloud padded to it."""
    kw = dict(data_root=str(scenes[variant]), st_pcl_capacity=capacity, **DIRS)
    ours, ref = NvidiaPureGeoEvalDataset(**kw), JPureGeo(**kw)
    assert ours.items == ref.items
    n = ours._scene_pcl("Balloon1").shape[0]
    assert n == ref._scene_pcl("Balloon1").shape[0] > 0
    np.testing.assert_allclose(ours._scene_pcl("Balloon1"), ref._scene_pcl("Balloon1"), **TOL)
    for i in (2, 7):
        got, want = ours[i], ref[i]
        assert sorted(got) == sorted(want)
        cap = capacity or n
        assert got["st_pcl_rgb"].shape == (cap, 6) and got["st_pcl_valid"].dtype == bool
        if capacity:
            assert n > capacity and 0 < got["st_pcl_valid"].sum() <= capacity
        np.testing.assert_array_equal(got["st_pcl_valid"], want["st_pcl_valid"])
        for key, r in want.items():
            if key == "misc":
                assert got[key]["scene_id"] == r["scene_id"]
                continue
            assert got[key].dtype == r.dtype and got[key].shape == r.shape, key
            np.testing.assert_allclose(got[key], r, **TOL, err_msg=key)


def test_pure_geo_reader_is_registered(scenes):
    kw = dict(data_root=str(scenes["png"]), **DIRS)
    ds = CombinedDataset([("nvidia_eval_pure_geo", kw)])
    assert isinstance(ds.datasets[0], NvidiaPureGeoEvalDataset) and len(ds) == 12
