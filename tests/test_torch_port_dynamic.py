"""Softmax splatting and the dynamic layer of the port against the JAX
package, on the synthetic contract scene, with the JAX noise draw handed to
the port. float32 on the CPU; atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.kernels.softsplat import brightness_metric as j_brightness_metric
from pgdvs_tpu.kernels.softsplat import softsplat as j_softsplat
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.dynamic import render_dynamic as j_render_dynamic
from pgdvs_tpu_torch.kernels import softsplat as tss
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.renderers.dynamic import render_dynamic

ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def data():
    return make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)


@pytest.mark.parametrize("mode", ["sum", "avg", "linear", "soft",
                                  "soft-zeroeps", "soft-clipeps"])
def test_softsplat_modes(mode):
    rng = np.random.default_rng(11)
    img = rng.uniform(size=(12, 16, 3)).astype(np.float32)
    flow = rng.normal(0, 3.0, (12, 16, 2)).astype(np.float32)
    flow[0, 0] = [np.inf, 0.0]  # a non-finite flow is dropped
    metric = rng.uniform(-2, 0, (12, 16, 1)).astype(np.float32)
    ref = j_softsplat(img, flow, metric, mode=mode)
    got = tss.softsplat(_t(img), _t(flow), _t(metric), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)


def test_brightness_metric(data):
    rgb = data["rgb_src_temporal"]
    ref = j_brightness_metric(rgb[0], rgb[1], data["flow_fwd"], 100.0)
    got = tss.brightness_metric(_t(rgb[0]), _t(rgb[1]), _t(data["flow_fwd"]), 100.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_render_dynamic_matches(data):
    key = jax.random.PRNGKey(3)
    cfg_j = JRenderConfig()
    ref = j_render_dynamic({k: v for k, v in data.items() if k != "misc"}, cfg_j, key)
    noise = np.asarray(jax.random.normal(key, data["rgb_src_temporal"][0].shape,
                                         jnp.float32))
    tdata = {k: _t(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    got = render_dynamic(tdata, RenderConfig(), noise=_t(noise))
    assert float(got["mask"].sum()) > 0  # the scene has dynamic content
    for key_ in ("rgb", "mask", "temporal_closest_rgb", "temporal_track_rgb"):
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(ref[key_]),
                                   atol=ATOL, err_msg=key_)
    np.testing.assert_allclose(got["pcl"]["flow_to_tgt"].numpy(),
                               np.asarray(ref["pcl"]["flow_to_tgt"]), atol=ATOL)


def test_render_dynamic_refuses_other_branches(data):
    """An unknown dyn_render_type raises (pcl and mesh render since the
    point-cloud slice: tests/test_torch_port_geo.py). The track mode renders
    since the track slice (with a tracker: tests/test_torch_port_track.py);
    without one it skips the branch, as JAX's does: the same layer as JAX's,
    the track layer empty."""
    tdata = {k: _t(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    with pytest.raises(ValueError):
        render_dynamic(tdata, RenderConfig(dyn_render_type="splat"),
                       generator=torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
    got = render_dynamic(tdata, RenderConfig(dyn_render_track_temporal="no_tgt"),
                         noise=_t(noise))
    jdata = {k: v for k, v in data.items() if k != "misc"}
    ref = j_render_dynamic(jdata, JRenderConfig(dyn_render_track_temporal="no_tgt"), key)
    for k in ("rgb", "mask", "temporal_track_rgb", "temporal_track_mask"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, err_msg=k)
    assert not got["temporal_track_mask"].any()
    np.testing.assert_allclose(float(got["pcl"]["nn_dist_thres"]),
                               float(ref["pcl"]["nn_dist_thres"]), rtol=1e-5)
