"""The port's pure-geometry static layer against the benchmark's plain
reference (``perfbench/reference/geo.py``), on the CPU at small sizes.

* the static K-NN outlier removal (``kernels/knn.py``, k 50, std 0.2) on a
  seeded 3,000-point cloud with planted outliers: the means within the
  float32 rounding of the program's ``|q|^2 - 2 q.c + |c|^2``, the
  decisions equal off the ties, every planted outlier dropped by both;
* ``rasterize_points`` against ``splat_points`` at 48x64 (radii of 0.96
  and 1.44 pixels, the second the benchmark's at 288x550): the masks equal
  but at pixels that a point's footprint reaches within float32's reach of
  its edge, the colours within float32 rounding where the masks agree;
* ``NvidiaPureGeoEvalDataset``'s cloud against ``aggregate_static_cloud``
  on a 6-frame NVIDIA-layout scene (``perfbench/harness/disk_scene.py``)
  at 48x64: the same rows, xyz within float32 rounding, colours within the
  JPEG frames' error; and the tie-aware check the benchmark makes of it;
* faults that must fail: one footprint tap shifted by a pixel, 1 % of the
  cloud's points dropped;
* a geo view runs no GNT kernel and no sampler: the entries the GNT path
  calls are not called and their launch counters do not move.
"""

import numpy as np
import pytest
import torch

from perfbench.harness import geo_check
from perfbench.harness.disk_scene import SCENE, DiskScene
from perfbench.reference import geo, render
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.data.nvidia_pure_geo import NvidiaPureGeoEvalDataset
from pgdvs_tpu_torch.data.synthetic import make_contract_data
from pgdvs_tpu_torch.kernels import epipolar, gnt_fused_mono3, knn, point_raster
from pgdvs_tpu_torch.renderers import static_gnt
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models
from test_torch_port_lk import one_thread

H, W = 48, 64
K, STD = 50, 0.2
EPS32 = float(np.finfo(np.float32).eps)
# the raster's footprint edge: a projection in float32 moves a tap's d^2 by
# a few ulps of the pixel coordinates (~64 * eps at 48x64); pixels whose
# coverage turns within this of r^2 may flip between program and reference
EDGE_D2 = 1e-4
# colours where the masks agree: float32 weights and sums against float64
RGB_TOL = 1e-5
# the cloud's colours: the reader decodes the q95 JPEG frames written at
# 96x128 and area-averages them to 48x64, the reference reads the frames as
# written; the textures put most JPEG error into each pixel at this size
# (0.022-0.026 relative RMS at 24x32 and 48x64, 0.008-0.010 at 288x550)
CLOUD_RGB_TOL = 0.04


@pytest.fixture(autouse=True)
def single_thread():
    with one_thread():
        yield


def _plane_cloud(seed, n=3000, n_out=30):
    """A plane at depth ~6 as the benchmark's background (a jittered grid
    of spacing ~0.014, |x|^2 ~ 40), plus ``n_out`` points 0.3-0.6 off it."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2)[:n]
    xy = (g - side / 2) * 0.0136 + rng.normal(0, 0.003, (n, 2)) + np.array([2.5, 1.5])
    pts = np.concatenate([xy, np.full((n, 1), 6.0) + rng.normal(0, 0.002, (n, 1))], 1)
    off = rng.uniform(0.3, 0.6, n_out) * rng.choice([-1.0, 1.0], n_out)
    out = pts[rng.choice(n, n_out, replace=False)] + np.stack(
        [rng.normal(0, 0.1, n_out), rng.normal(0, 0.1, n_out), off], 1)
    return torch.from_numpy(np.concatenate([pts, out]).astype(np.float32)), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_static_knn_means_and_decisions(seed):
    points, n = _plane_cloud(seed)
    valid = torch.ones(points.shape[0], dtype=torch.bool)
    valid[7] = False  # a padded row
    means = knn.knn_mean_sq_dist(points, valid, k=K)
    keep, thres = knn.statistical_outlier_mask(points, valid, k=K, std_thres=STD)
    own, own_thres, own_keep = geo.static_outlier_rule(points, valid, K, STD)
    gap = (means[valid].double() - own[valid].double()).abs()
    # |q|^2 - 2 q.c + |c|^2 rounds each of its terms: a few eps of |q|^2
    bound = 8 * EPS32 * float((points[valid].double() ** 2).sum(1).max())
    assert float(gap.max()) <= bound, (float(gap.max()), bound)
    assert abs(float(thres) - own_thres) <= bound
    thres_gap = abs(float(render.outlier_threshold(means, valid, STD)) - own_thres)
    tie = (own[valid].double() - own_thres).abs() <= gap + thres_gap
    assert torch.equal(keep[valid][~tie], own_keep[valid][~tie])
    assert int(tie.sum()) <= 3
    assert not bool(keep[n:].any()) and not bool(own_keep[n:].any())
    assert not bool(keep[7]) and int(keep.sum()) > 0.8 * n


def _cloud_and_cam():
    data = make_contract_data(h=H, w=W, n_spatial=2, n_frames=6)
    pcl = torch.from_numpy(data["st_pcl_rgb"])
    keep = torch.from_numpy(np.random.default_rng(3).random(pcl.shape[0]) > 0.1)
    return pcl[:, :3], pcl[:, 3:], keep, torch.from_numpy(data["flat_cam_tgt"])


def _edge_pixels(points, keep, cam, radius):
    """[H*W] bool: the pixels a kept point's footprint reaches with d^2
    within EDGE_D2 of r^2."""
    r = geo.radius_px(radius, (H, W))
    idx, d2, _z = geo._footprint(points[keep], cam, (H, W), r)
    near = ((d2 - r * r).abs() <= EDGE_D2) & (idx < H * W)
    edge = torch.zeros(H * W + 1, dtype=torch.bool)
    edge[idx[near]] = True
    return edge[:H * W]


@pytest.mark.parametrize("radius", [0.04, 0.06])
def test_rasterize_points_against_splat_points(radius):
    points, colors, keep, cam = _cloud_and_cam()
    rgb, alpha = point_raster.rasterize_points(points, colors, cam, (H, W), valid=keep,
                                               radius=radius)
    ref_rgb, ref_mask = geo.splat_points(points, colors, keep, cam, (H, W), radius)
    edge = _edge_pixels(points, keep, cam, radius)
    differ = (alpha.reshape(-1) != ref_mask.reshape(-1))
    assert 0.3 < float(ref_mask.mean()) <= 1.0
    assert not bool((differ & ~edge).any())
    agree = ~differ
    err = (rgb.reshape(-1, 3)[agree] - ref_rgb.reshape(-1, 3)[agree]).abs().max()
    assert float(err) <= RGB_TOL


@pytest.mark.parametrize("fault", ["shifted_tap", "dropped_points"])
def test_planted_fault_fails(monkeypatch, tmp_path, fault):
    """One footprint tap shifted by a pixel: masks or colours differ from
    the reference beyond the tolerances above. 1 % of the reader's points
    dropped: the benchmark's cloud check reads far over its limit."""
    if fault == "shifted_tap":
        orig = point_raster.point_taps

        def shifted(points, flat_cam, image_hw, valid, r_px, fp):
            z, taps = orig(points, flat_cam, image_hw, valid, r_px, fp)
            idx, d2, cover = taps[len(taps) // 2 + 1]
            h, w = image_hw
            moved = torch.where(idx < h * w - 1, idx + 1, idx)
            taps[len(taps) // 2 + 1] = (moved, d2, cover)
            return z, taps

        monkeypatch.setattr(point_raster, "point_taps", shifted)
        points, colors, keep, cam = _cloud_and_cam()
        rgb, alpha = point_raster.rasterize_points(points, colors, cam, (H, W), valid=keep,
                                                   radius=0.06)
        ref_rgb, ref_mask = geo.splat_points(points, colors, keep, cam, (H, W), 0.06)
        differ = (alpha.reshape(-1) != ref_mask.reshape(-1)) & ~_edge_pixels(points, keep, cam,
                                                                             0.06)
        agree = alpha.reshape(-1) == ref_mask.reshape(-1)
        err = (rgb.reshape(-1, 3)[agree] - ref_rgb.reshape(-1, 3)[agree]).abs().max()
        assert bool(differ.any()) or float(err) > 100 * RGB_TOL
    else:
        frames, cloud = _reader_cloud(tmp_path)
        drop = np.ones(len(cloud["xyz"]), bool)
        drop[::100] = False
        dropped = {**cloud, "xyz": cloud["xyz"][drop], "rgb": cloud["rgb"][drop]}
        dropped["starts"] = cloud["starts"][:-1] + [len(dropped["xyz"])]
        limit = 1e-5  # perfbench/limits/geo_pcl_clean.nvidia_geo.json
        assert geo_check.cloud_numbers(frames, cloud)["geo_cloud"] <= limit
        assert geo_check.cloud_numbers(frames, dropped)["geo_cloud"] > 100 * limit


def _reader_cloud(root, seed=2 ** 31 + 3, n_frames=6):
    """(reference frames, the reader's cloud with its recorded coverage
    tests) of a seeded NVIDIA-layout scene at 48x64 from 96x128 frames."""
    scene = DiskScene(seed, n_frames, (2 * H, 2 * W), (H, W))
    sources = scene.write(root, 95, 0.6, seed)
    ds = NvidiaPureGeoEvalDataset(root, scene_ids=[SCENE], n_src_views_spatial=2,
                                  tgt_height=H)

    class Rec:
        pass

    rec = Rec()
    geo_check.capture_coverage(rec, ds)
    pcl = ds[0]["st_pcl_rgb"]
    frames = geo_check.reference_frames(scene, sources)
    return frames, geo_check.program_cloud(pcl[:, :3], pcl[:, 3:], rec.coverage, n_frames)


def test_reader_cloud_against_aggregate_static_cloud(tmp_path):
    frames, cloud = _reader_cloud(tmp_path)
    ref = geo.aggregate_static_cloud(frames)
    assert len(cloud["xyz"]) == len(ref["xyz"]) > 0.7 * H * W
    assert cloud["starts"] == ref["starts"]
    for a, b in zip(cloud["covered"][1:], ref["covered"][1:]):
        np.testing.assert_array_equal(a, b)
    # the reader unprojects in float32, the reference in float64
    np.testing.assert_allclose(cloud["xyz"], ref["xyz"], rtol=1e-5, atol=1e-5)
    gap = np.sqrt(((cloud["rgb"] - ref["rgb"]) ** 2).sum() / (ref["rgb"] ** 2).sum())
    assert gap <= CLOUD_RGB_TOL
    nums = geo_check.cloud_numbers(frames, cloud)
    assert nums["geo_cloud"] <= 1e-6 and nums["geo_cloud_rgb"] <= CLOUD_RGB_TOL


def test_coverage_ties_name_both_pixels():
    """A point projecting onto integer coordinates: its pixel is a tie,
    named by ``maybe`` but not ``sure``; one off them is sure."""
    k = np.array([[10.0, 0, 4.0], [0, 10.0, 3.0], [0, 0, 1.0]])
    c2w = np.eye(4)
    pts = np.array([[0.2, 0.1, 1.0], [0.23, 0.13, 1.0]])  # (6, 4) exactly; (6.3, 4.3)
    sure, maybe = geo.covered_pixels(pts, k, c2w, 8, 10, tie_px=1e-3)
    assert sure.reshape(8, 10)[4, 6] and not sure.reshape(8, 10)[4, 5]
    assert maybe.reshape(8, 10)[3, 5] and maybe.reshape(8, 10)[4, 6]
    plain, same = geo.covered_pixels(pts, k, c2w, 8, 10)
    assert np.array_equal(plain, same)


def test_geo_view_runs_no_gnt_kernel_and_no_sampler(monkeypatch):
    """The pure-geometry bundle's view calls neither the GNT kernel entry
    nor the sampler its configuration names, and their launch counters do
    not move; a GNT view on the same data calls both."""
    calls = {"gnt": 0, "sampler": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(static_gnt, "gnt_fused_apply_mono3",
                        counting("gnt", static_gnt.gnt_fused_apply_mono3))
    monkeypatch.setattr(static_gnt, "epipolar_sample",
                        counting("sampler", static_gnt.epipolar_sample))
    data = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in make_contract_data(h=24, w=32, n_spatial=3, n_frames=6).items()}
    noise = torch.zeros(24, 32, 3)
    k2 = sum(gnt_fused_mono3.gnt_fused_apply_mono3.launches.values())
    smp = sum(epipolar.launches.values())
    cfg = resolve_benchmark("st_cvd_pcl_clean_dy_cvd_pcl_clean", "exact")[0]
    out = render_novel_view(None, data, cfg, static_mode="geo", noise=noise)
    assert "geo_static_rgb" in out and calls == {"gnt": 0, "sampler": 0}
    assert sum(gnt_fused_mono3.gnt_fused_apply_mono3.launches.values()) == k2
    assert sum(epipolar.launches.values()) == smp
    gnt_cfg = resolve_benchmark("default", "exact")[0].replace(n_coarse_samples_per_ray=8,
                                                               ray_tile=256)
    render_novel_view(init_gnt_models(device="cpu", feat_ch=32), data, gnt_cfg, noise=noise)
    assert calls["gnt"] > 0 and calls["sampler"] > 0
