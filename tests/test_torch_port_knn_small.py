"""The port's outlier filter against the JAX package's on clouds with fewer
valid points than K (ROADMAP.md §3, F13), on the CPU.

With n valid points and K >= n, every point's mean squared distance to its
K nearest carries the 1e30 stand-in of the K - n + 1 missing neighbours, so
all means are equal up to the last bit of a float32 sum of stand-ins, and
the std of those means is either 0 (the filter keeps no point) or inf (it
keeps all). Both packages must decide alike: the keep masks equal, the
thresholds equal (inf where JAX's is inf), on a 64-slot padded cloud of n
seeded normal points at K = 50; at n = 60 the cloud is larger than K and
the ordinary arithmetic holds (threshold at 1e-5 relative).

Then the dynamic layer with the outlier filter on (as ``default``) on the 18x18 synthetic scene, whose
base dynamic cloud is smaller than K: every mask equal, rgb 1e-4 (as
tests/test_torch_port_dynamic.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.kernels.knn import knn_mean_sq_dist as j_knn
from pgdvs_tpu.kernels.knn import statistical_outlier_mask as j_outlier
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.dynamic import render_dynamic as j_render_dynamic
from pgdvs_tpu_torch.kernels.knn import knn_mean_sq_dist, statistical_outlier_mask, xla_order_sum
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.renderers.dynamic import render_dynamic

K = 50
SLOTS = 64


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _cloud(n):
    rng = np.random.default_rng(n)
    pts = np.zeros((SLOTS, 3), np.float32)
    pts[:n] = rng.normal(size=(n, 3))
    valid = np.zeros(SLOTS, bool)
    valid[:n] = True
    return pts, valid


@pytest.mark.parametrize("n", [10, 20, 29, 30, 31, 40, 49, 60])
def test_outlier_mask_under_k_matches_jax(n):
    pts, valid = _cloud(n)
    ref_keep, ref_t = j_outlier(jnp.asarray(pts), jnp.asarray(valid), k=K)
    keep, t = statistical_outlier_mask(torch.from_numpy(pts), torch.from_numpy(valid), k=K)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    if n <= K:
        assert float(t) == float(ref_t)
        means = knn_mean_sq_dist(torch.from_numpy(pts), torch.from_numpy(valid), k=K)
        np.testing.assert_array_equal(
            means.numpy(), np.asarray(j_knn(jnp.asarray(pts), jnp.asarray(valid), k=K)))
    else:
        np.testing.assert_allclose(float(t), float(ref_t), rtol=1e-5)


@pytest.mark.parametrize("length", [7, 32, 33, 50, 65, 1100])
def test_xla_order_sum_equals_xla(length):
    """The fixed order equals XLA's CPU reduce bit for bit on values of
    twelve decades, along a row of a 2-D array (as the per-point mean) and
    over a vector (as the std)."""
    rng = np.random.default_rng(length)
    a = (rng.normal(size=(3, length)) * 10.0 ** rng.integers(-6, 7, (3, length))).astype(np.float32)
    np.testing.assert_array_equal(xla_order_sum(torch.from_numpy(a)).numpy(),
                                  np.asarray(jax.jit(lambda b: jnp.sum(b, axis=1))(a)))
    np.testing.assert_array_equal(xla_order_sum(torch.from_numpy(a[0])).numpy(),
                                  np.asarray(jnp.sum(jnp.asarray(a[0]))))


def test_render_dynamic_18x18_matches_jax():
    data = make_contract_data(h=18, w=18, n_spatial=3, n_frames=6)
    key = jax.random.PRNGKey(3)
    ref = j_render_dynamic({k: v for k, v in data.items() if k != "misc"}, JRenderConfig(dyn_pcl_remove_outlier=True), key)
    noise = np.asarray(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
    tdata = {k: _t(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    got = render_dynamic(tdata, RenderConfig(dyn_pcl_remove_outlier=True), noise=_t(noise))
    assert 0 < int(np.asarray(ref["pcl"]["valid"]).sum()) <= K  # a cloud under K, all kept
    assert float(got["pcl"]["nn_dist_thres"]) == float(ref["pcl"]["nn_dist_thres"]) == np.inf
    np.testing.assert_array_equal(got["pcl"]["valid"].numpy(), np.asarray(ref["pcl"]["valid"]))
    for key_ in ("rgb", "mask", "temporal_closest_rgb", "temporal_track_rgb"):
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(ref[key_]), atol=1e-4,
                                   err_msg=key_)
