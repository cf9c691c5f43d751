"""The quality cost of the quad sampler, the port's against the JAX
package's: PSNR / SSIM of the `default` bundle's static layer rendered on
the exact preset against the fast (quad) one, same weights (flax
initialiser, carried by ``params_from_jax``), same scene, on both sides.
The JAX package's own figure of this delta is docs/BENCHMARK.md:60-66
(scripts/fast_preset_delta.py); ``chip_smoke.py`` prints the port's at full
size.

The two deltas measure the same sampler approximation (features upsampled
once to full resolution, one bilinear tap set per sample and view), so
they agree to within 1 dB of PSNR and 0.01 of SSIM; measured here at
48x64 / 3 sources / 16 samples: port 32.49 dB / 0.9924, JAX 32.44 dB /
0.9919. The
JAX exact side runs the flax network (``use_pallas_gnt=False``, the
program docs/BENCHMARK.md:73-79 measures exact + masked on), its fast side
mono3 in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.metrics import psnr_ssim as j_metrics
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.metrics.psnr_ssim import masked_psnr, masked_ssim, quantize_uint8
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

H, W, V, S = 48, 64, 3, 16
SMALL = dict(n_coarse_samples_per_ray=S, ray_tile=1024)


def _delta(exact, fast, psnr, ssim, quantize):
    a, b = quantize(exact), quantize(fast)
    full = np.ones_like(a)
    return psnr(a, b, full), ssim(a, b, full)


@pytest.fixture(scope="module")
def deltas():
    data = make_contract_data(h=H, w=W, n_spatial=V, n_frames=6)
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}
    cfgs_j = {
        "fast": j_resolve_benchmark("default")[0].replace(knn_tile=1024, **SMALL),
        "exact": j_resolve_benchmark("default", preset="exact")[0].replace(
            use_pallas_gnt=False, knn_tile=1024, **SMALL),
    }
    ref = {p: np.asarray(jax.jit(
        lambda prm, c=c: j_render_novel_view(models, prm, jdata, c, key, static_mode="gnt")
    )(params)["static_coarse_rgb"]) for p, c in cfgs_j.items()}

    fnet, gnt = init_gnt_models(device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
    gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
             if isinstance(v, np.ndarray)}
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32)))
    got = {p: render_novel_view((fnet, gnt), tdata,
                                resolve_benchmark("default", preset=p)[0].replace(**SMALL),
                                noise=noise)["static_coarse_rgb"].numpy()
           for p in ("fast", "exact")}
    return {
        "port": _delta(got["exact"], got["fast"], masked_psnr, masked_ssim, quantize_uint8),
        "jax": _delta(ref["exact"], ref["fast"], j_metrics.masked_psnr,
                      j_metrics.masked_ssim, j_metrics.quantize_uint8),
    }


def test_quad_delta_matches_jax(deltas):
    (p_psnr, p_ssim), (j_psnr, j_ssim) = deltas["port"], deltas["jax"]
    assert 20.0 < j_psnr < 60.0  # the two samplers differ, but not wildly
    assert abs(p_psnr - j_psnr) < 1.0, (p_psnr, j_psnr)
    assert abs(p_ssim - j_ssim) < 0.01, (p_ssim, j_ssim)
