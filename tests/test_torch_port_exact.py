"""The pieces of the exact-sampler slice against the JAX package: the exact
epipolar sampler, the benchmark bundles on the exact preset, the slice check
and the masked PSNR / SSIM metrics. All on the CPU.

Bounds: the ray-difference code to 1e-5 (float32 on both sides); the
in-bounds mask exactly; the dynamic mask exactly, except at taps whose JAX
lerp (float32 on both sides) lies within 1e-6 of the 1e-3 threshold.
rgb_feat to bf16 rounding, atol 1e-2 + rtol 2^-7: JAX casts the maps to
bf16 and lerps in bf16, rounding each product and partial sum; the port
gathers the same bf16 map rows, lerps them in float32 and casts once to
bf16. Measured here: 7.8e-3 max abs error on maps of magnitude up to 1,
two bf16 ulps of the taps. Metrics to 1e-9 (the same numpy code).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.configs.benchmarks import BENCHMARK_TYPES as J_BENCHMARK_TYPES
from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.metrics import psnr_ssim as j_metrics
from pgdvs_tpu.models.gnt.projector import (
    epipolar_sample as j_epipolar_sample,
    multiview_bilinear as j_multiview_bilinear,
    project_all_views as j_project_all_views,
)
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.metrics import psnr_ssim
from pgdvs_tpu_torch.models.gnt.projector import epipolar_sample, multiview_bilinear
from pgdvs_tpu_torch.renderers.config import RenderConfig, check_slice


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# --------------------------------------------------------------- sampler


@pytest.fixture(scope="module", params=[True, False], ids=["dyn_mask", "no_mask"])
def sampled(request):
    with_masks = request.param
    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)
    rng = np.random.default_rng(4)
    v = 3
    rgbs = data["rgb_src_spatial"]
    feats = rng.uniform(-1, 1, (v, 6, 8, 32)).astype(np.float32)
    masks = data["dyn_mask_src_spatial"] if with_masks else None
    cams, tgt = data["flat_cam_src_spatial"], data["flat_cam_tgt"]
    # points around the scene's depth range, some projecting out of bounds
    pts = np.stack([rng.uniform(-2.5, 2.5, (40, 24)), rng.uniform(-2, 2, (40, 24)),
                    rng.uniform(1.5, 8, (40, 24))], -1).astype(np.float32)
    ref = j_epipolar_sample(
        jnp.asarray(pts), jnp.asarray(tgt), jnp.asarray(cams), jnp.asarray(rgbs),
        jnp.asarray(feats), None if masks is None else jnp.asarray(masks),
        sample_dtype=jnp.bfloat16, views_outer=True)
    lerped = None
    if with_masks:
        uv, _z, _f = j_project_all_views(jnp.asarray(pts), jnp.asarray(cams))
        lerped = np.asarray(j_multiview_bilinear(
            jnp.asarray(masks, jnp.float32), uv[..., 0], uv[..., 1]))[..., 0]
    got = epipolar_sample(
        _t(pts), _t(tgt), _t(cams), _t(rgbs).to(torch.bfloat16),
        _t(feats).to(torch.bfloat16), None if masks is None else _t(masks))
    ref = {k: np.asarray(x.astype(jnp.float32)) for k, x in ref.items()}
    return got, ref, lerped


def test_exact_sampler_features(sampled):
    got, ref, _ = sampled
    assert got["rgb_feat"].dtype == torch.bfloat16
    assert tuple(got["rgb_feat"].shape) == ref["rgb_feat"].shape == (3, 40, 24, 35)
    np.testing.assert_allclose(got["rgb_feat"].float().numpy(), ref["rgb_feat"],
                               atol=1e-2, rtol=2.0 ** -7)


def test_exact_sampler_ray_diff(sampled):
    got, ref, _ = sampled
    assert got["ray_diff"].dtype == torch.float32
    np.testing.assert_allclose(got["ray_diff"].numpy(), ref["ray_diff"], atol=1e-5)


def test_exact_sampler_inbound_exact(sampled):
    got, ref, _ = sampled
    inb = ref["mask_inbound"][..., 0]
    assert 0.2 < inb.mean() < 0.95  # a mix of in- and out-of-bounds taps
    np.testing.assert_array_equal(got["mask_inbound"].numpy(), inb > 0)


def test_exact_sampler_dynamic_mask(sampled):
    got, ref, lerped = sampled
    inv = ref["mask_invalid"][..., 0] > 0
    if lerped is None:
        assert not inv.any() and not got["mask_invalid"].any()
        near = np.zeros_like(inv)
    else:
        assert inv.any() and not inv.all()
        near = np.abs(lerped - 1e-3) <= 1e-6
    assert np.all((got["mask_invalid"].numpy() == inv) | near)
    np.testing.assert_array_equal(
        got["mask"].numpy(), got["mask_inbound"].numpy() & ~got["mask_invalid"].numpy())
    np.testing.assert_array_equal(got["mask"].numpy() | near,
                                  (ref["mask"][..., 0] > 0) | near)


def test_multiview_bilinear_matches_jax_in_float32():
    """f32 maps on both sides: the same taps, weights and summation order."""
    rng = np.random.default_rng(9)
    imgs = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    x = rng.uniform(-1.5, 7.5, (2, 30)).astype(np.float32)
    y = rng.uniform(-1.5, 5.5, (2, 30)).astype(np.float32)
    ref = np.asarray(j_multiview_bilinear(jnp.asarray(imgs), jnp.asarray(x),
                                          jnp.asarray(y)))
    got = multiview_bilinear(_t(imgs), _t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert np.abs(ref).max() > 0 and np.any(ref == 0)  # some taps fall outside


# --------------------------------------------------------------- bundles


SEMANTIC = [f.name for f in dataclasses.fields(RenderConfig) if f.name != "ray_tile"]


@pytest.mark.parametrize("name", sorted(J_BENCHMARK_TYPES))
def test_bundle_resolves_like_jax_on_the_exact_preset(name):
    """Every semantic field, the sampler included (the fast preset is held
    in test_torch_port_masked.py)."""
    cfg, spec = resolve_benchmark(name, preset="exact")
    cfg_j, spec_j = j_resolve_benchmark(name, preset="exact")
    assert spec == spec_j
    assert cfg.epipolar_mode == "exact"
    for field in SEMANTIC:
        assert getattr(cfg, field) == getattr(cfg_j, field), (name, field)


def test_check_slice_accepts_exact_and_quad_only():
    """Exact (the default), quad, patch and, since the JAX package's other
    samplers are ported, fused and quad_i8; a mode JAX does not know is
    refused."""
    check_slice(RenderConfig())
    assert RenderConfig().epipolar_mode == "exact"
    for mode in ("quad", "patch", "fused", "quad_i8"):
        check_slice(RenderConfig(epipolar_mode=mode))
    with pytest.raises(ValueError, match="epipolar_mode"):
        check_slice(RenderConfig(epipolar_mode="quad_u4"))


# --------------------------------------------------------------- metrics


def test_psnr_ssim_equal_jax_numpy():
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 1, (20, 26, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), -0.1, 1.1)
    mask = (rng.uniform(size=(20, 26, 1)) < 0.7).astype(np.float64)
    qa, qb = psnr_ssim.quantize_uint8(a), psnr_ssim.quantize_uint8(b)
    np.testing.assert_array_equal(qa, j_metrics.quantize_uint8(a))
    np.testing.assert_array_equal(qb, j_metrics.quantize_uint8(b))
    full = np.ones((20, 26, 3))
    for m in (mask, np.repeat(mask, 3, axis=-1), full):
        assert psnr_ssim.masked_psnr(qa, qb, m) == pytest.approx(
            j_metrics.masked_psnr(qa, qb, m), abs=1e-9)
        assert psnr_ssim.masked_ssim(qa, qb, m) == pytest.approx(
            j_metrics.masked_ssim(qa, qb, m), abs=1e-9)
    assert psnr_ssim.masked_psnr(qa, qa, full) == 0.0
    assert psnr_ssim.masked_ssim(qa, qa, full) == pytest.approx(1.0, abs=1e-9)
