"""The pieces of the masked (`default` bundle) slice against the JAX package:
the masked quad sampler, KNN statistical outlier removal, and the named
benchmark bundles. All float32 on the CPU.

Bounds: sampled features within bf16 rounding (atol 1e-2 + rtol 2^-7: the
maps are bf16 on both sides, and the JAX package also upsamples its
features and lerps its taps in bf16, rounding at every step); the
in-bounds mask exactly; the dynamic mask exactly, except at taps whose JAX
value lies within 1e-3 * 2^-7 of the 1e-3 threshold; KNN means
rtol 1e-4 (both use |q|^2 - 2 q.c + |c|^2 in float32, summed in another
order); median and std to 1e-6 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.configs.benchmarks import BENCHMARK_TYPES as J_BENCHMARK_TYPES
from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.kernels import knn as jknn
from pgdvs_tpu.models.gnt.projector import (
    build_quad_maps,
    epipolar_sample_fused,
    flatten_quad_maps,
    quad_bilinear,
    project_all_views as j_project_all_views,
)
from pgdvs_tpu_torch.configs.benchmarks import BENCHMARK_TYPES, resolve_benchmark
from pgdvs_tpu_torch.core import cameras
from pgdvs_tpu_torch.kernels import knn
from pgdvs_tpu_torch.models.gnt.projector import (
    build_fused_maps,
    epipolar_sample_quad_masked,
)
from pgdvs_tpu_torch.renderers.config import RenderConfig


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# --------------------------------------------------------------- sampler


@pytest.fixture(scope="module")
def sampled():
    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)
    rng = np.random.default_rng(2)
    v, h, w = 3, 24, 32
    rgbs = data["rgb_src_spatial"]
    feats = rng.uniform(-1, 1, (v, 6, 8, 32)).astype(np.float32)
    masks = data["dyn_mask_src_spatial"]
    cams = data["flat_cam_src_spatial"]
    # points around the scene's depth range, some projecting out of bounds
    pts = np.stack([rng.uniform(-2.5, 2.5, (40, 24)), rng.uniform(-2, 2, (40, 24)),
                    rng.uniform(1.5, 8, (40, 24))], -1).astype(np.float32)
    qmaps = flatten_quad_maps(build_quad_maps(
        jnp.asarray(rgbs), jnp.asarray(feats), jnp.asarray(masks),
        dtype=jnp.bfloat16))
    ref = epipolar_sample_fused(
        jnp.asarray(pts), jnp.asarray(data["flat_cam_tgt"]), jnp.asarray(cams),
        qmaps, with_mask=True, quad=True, views_outer=True, with_ray_diff=False)
    uv, _z, _f = j_project_all_views(jnp.asarray(pts), jnp.asarray(cams))
    lerped = quad_bilinear(qmaps, uv[..., 0], uv[..., 1])[..., -1]
    maps = build_fused_maps(_t(rgbs), _t(feats), _t(masks))
    got = epipolar_sample_quad_masked(
        _t(pts), cameras.flat_cam_projection(_t(cams)), maps)
    ref = {k: np.asarray(x.astype(jnp.float32)) for k, x in ref.items()
           if x is not None}
    return got, ref, np.asarray(lerped.astype(jnp.float32))


def test_masked_sampler_features(sampled):
    got, ref, _ = sampled
    assert got["rgb_feat"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["rgb_feat"].float().numpy(), ref["rgb_feat"],
                               atol=1e-2, rtol=2.0 ** -7)


def test_masked_sampler_inbound_exact(sampled):
    got, ref, _ = sampled
    inb = ref["mask_inbound"][..., 0]
    assert 0.2 < inb.mean() < 0.95  # a mix of in- and out-of-bounds taps
    np.testing.assert_array_equal(got["mask_inbound"].numpy(), inb > 0)


def test_masked_sampler_dynamic_mask(sampled):
    got, ref, lerped = sampled
    inv = ref["mask_invalid"][..., 0] > 0
    assert inv.any() and not inv.all()
    near = np.abs(lerped - 1e-3) <= 1e-3 * 2.0 ** -7
    assert np.all((got["mask_invalid"].numpy() == inv) | near)
    np.testing.assert_array_equal(
        got["mask"].numpy(), got["mask_inbound"].numpy() & ~got["mask_invalid"].numpy())
    np.testing.assert_array_equal(got["mask"].numpy() | near,
                                  (ref["mask"][..., 0] > 0) | near)


# ------------------------------------------------------------------- KNN


def _cloud(n, n_valid, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pts[:5] += 3.0  # a few far outliers
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    valid[:5] = True
    return pts, valid


@pytest.mark.parametrize("n,n_valid,k,tile", [(300, 240, 8, 64), (40, 7, 8, 16)])
def test_knn_mean_sq_dist(n, n_valid, k, tile):
    """Tiles smaller than the cloud, and a cloud with fewer valid points
    than K + 1 (missing neighbours count as 1e30 on both sides)."""
    pts, valid = _cloud(n, n_valid, seed=n)
    ref = np.asarray(jknn.knn_mean_sq_dist(jnp.asarray(pts), jnp.asarray(valid),
                                           k=k, tile=tile))
    got = knn.knn_mean_sq_dist(_t(pts), torch.from_numpy(valid), k=k, tile=tile,
                               query_tile=tile).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-4)
    assert np.all(got[~valid] == 1e30)


@pytest.mark.parametrize("n_valid", [240, 241])
def test_statistical_outlier_mask(n_valid):
    """Odd and even valid counts (the lower middle element is the median)."""
    pts, valid = _cloud(300, n_valid, seed=n_valid)
    pts_t, valid_t = _t(pts), torch.from_numpy(valid)
    keep_j, thres_j = jknn.statistical_outlier_mask(
        jnp.asarray(pts), jnp.asarray(valid), k=8, std_thres=0.1, tile=64)
    keep, thres = knn.statistical_outlier_mask(pts_t, valid_t, k=8, std_thres=0.1,
                                               tile=64)
    np.testing.assert_allclose(float(thres), float(thres_j), rtol=1e-4)
    d2 = knn.knn_mean_sq_dist(pts_t, valid_t, k=8).numpy()
    near = np.abs(d2 - float(thres_j)) <= 1e-4 * float(thres_j)
    keep_j = np.asarray(keep_j)
    assert np.all((keep.numpy() == keep_j) | near)
    assert not keep.numpy()[:5].any()  # the far outliers go
    assert keep.numpy().sum() > 0.3 * n_valid

    med_j = float(jknn.masked_median(jnp.asarray(d2), jnp.asarray(valid)))
    std_j = float(jknn.masked_std(jnp.asarray(d2), jnp.asarray(valid)))
    assert float(knn.masked_median(torch.from_numpy(d2), valid_t)) == pytest.approx(
        med_j, rel=1e-6)
    assert float(knn.masked_std(torch.from_numpy(d2), valid_t)) == pytest.approx(
        std_j, rel=1e-6)
    vals = np.sort(d2[valid])
    assert float(knn.masked_median(torch.from_numpy(d2), valid_t)) == vals[(len(vals) - 1) // 2]


# --------------------------------------------------------------- bundles


SEMANTIC = [f.name for f in dataclasses.fields(RenderConfig)
            if f.name not in ("ray_tile", "epipolar_mode")]


def test_bundle_table_is_the_jax_one():
    assert sorted(BENCHMARK_TYPES) == sorted(J_BENCHMARK_TYPES)
    for name, spec in BENCHMARK_TYPES.items():
        assert spec == J_BENCHMARK_TYPES[name], name
    assert (BENCHMARK_TYPES["st_gnt_masked_attn_dy_cvd_pcl_clean"]
            is BENCHMARK_TYPES["default"])


@pytest.mark.parametrize("name", sorted(J_BENCHMARK_TYPES))
def test_bundle_resolves_like_jax(name):
    cfg, spec = resolve_benchmark(name)
    cfg_j, spec_j = j_resolve_benchmark(name)
    assert spec == spec_j
    for field in SEMANTIC:
        assert getattr(cfg, field) == getattr(cfg_j, field), (name, field)
    # the fast preset's sampler too: patch without the dyn mask, quad with it
    assert cfg.epipolar_mode == cfg_j.epipolar_mode
    assert cfg.epipolar_mode == ("quad" if cfg.gnt_use_dyn_mask else "patch")


def test_unknown_bundle_or_preset_raises():
    with pytest.raises(KeyError):
        resolve_benchmark("no_such_bundle")
    with pytest.raises(KeyError):
        resolve_benchmark("default", preset="no_such_preset")
    # the exact preset resolves, on the reference-faithful sampler
    assert resolve_benchmark("default", preset="exact")[0].epipolar_mode == "exact"
