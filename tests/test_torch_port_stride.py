"""Render stride in the port: ``get_rays`` on every stride-th pixel, the
dynamic layer's resize (``jax.image.resize``'s cubic and nearest, written
from their definition), and ``render_novel_view`` at ``render_stride=2``
against the JAX package's.

Bounds: rays at 1e-6; the resize at 1e-5 (separable float32 weight
matrices, contracted in another order); renders at the JAX package's bounds
for its fast paths (tests/test_gnt_model.py): rgb 0.04, depth 0.1, inbound
count 0.02, and the dynamic layer at 1e-4 as in
tests/test_torch_port_patch_render.py. The JAX side runs its Pallas
kernels in interpret mode, the port's CPU path the plain float32 network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pgdvs_tpu.core import cameras as jcam
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.config import apply_perf_preset as j_apply_perf_preset
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.core import cameras as tcam
from pgdvs_tpu_torch.core import interpolate as tint
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02}


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("hw", [(24, 32), (13, 19)])
def test_get_rays_with_stride(stride, hw):
    h, w = hw
    rng = np.random.default_rng(stride)
    k = np.eye(4, dtype=np.float32)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 30.0, 28.0, w / 2 + 0.3, h / 2 - 0.2
    ang = rng.normal(0, 0.2, 3)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_rotvec(ang).as_matrix()
    c2w[:3, 3] = rng.normal(0, 1, 3)
    ref = jcam.get_rays(h, w, k, c2w, stride=stride)
    got = tcam.get_rays(h, w, torch.from_numpy(k), torch.from_numpy(c2w), stride=stride)
    assert got[3] == ref[3] == (-(-h // stride), -(-w // stride))
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["cubic", "nearest", "linear"])
@pytest.mark.parametrize("src,dst", [((24, 32), (12, 16)), ((24, 32), (8, 11)),
                                     ((13, 19), (7, 10)), ((7, 10), (13, 19)),
                                     ((9, 9), (9, 20)), ((288, 550), (144, 275))])
def test_resize_is_jax_image_resize(method, src, dst):
    """Down- and up-sampling, odd sizes, one axis unchanged, the strided
    full-size render; the mask's nearest resize as it is used (then > 0)."""
    rng = np.random.default_rng(src[0] * dst[1])
    img = rng.uniform(-0.2, 1.2, src + (3,)).astype(np.float32)
    ref = np.asarray(jax.image.resize(img, dst + (3,), method))
    got = tint.resize(torch.from_numpy(img), *dst, method)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    if method == "nearest":
        mask = (rng.uniform(size=src + (1,)) > 0.7).astype(np.float32)
        ref_m = np.asarray(jax.image.resize(mask, dst + (1,), "nearest") > 0)
        np.testing.assert_array_equal(
            (tint.resize(torch.from_numpy(mask), *dst, "nearest") > 0).numpy(), ref_m)


def test_resize_is_not_torch_interpolate():
    """Why the resize is written out: torch's bicubic (a = -0.75, no
    antialiasing) and nearest (no half-pixel centres) give other images."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    x = torch.from_numpy(img).permute(2, 0, 1)[None]
    for method, mode in (("cubic", "bicubic"), ("nearest", "nearest")):
        ref = np.asarray(jax.image.resize(img, (12, 16, 3), method))
        kw = {"align_corners": False} if mode == "bicubic" else {}
        other = torch.nn.functional.interpolate(x, size=(12, 16), mode=mode, **kw)
        assert np.abs(other[0].permute(1, 2, 0).numpy() - ref).max() > 1e-2
    with pytest.raises(ValueError, match="resize method"):
        tint.resize(torch.from_numpy(img), 12, 16, "lanczos3")


# ---------------------------------------------------------------- renders

H, W, V, S = 24, 32, 3, 16


def _per_pixel_depth_range(data):
    """A [H, W, 2] depth range around the scene's, varying over the image,
    so the stride's [::2, ::2] pick shows."""
    near, far = data["depth_range"]
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    return np.stack([near * (0.9 + 0.2 * yy), far * (0.9 + 0.2 * xx)], -1).astype(np.float32)


@pytest.fixture(scope="module", params=["fast", "exact"])
def rendered(request):
    """stride 2: the fast preset (patch on 4x2 blocks of the 12x16 render)
    with the scene's depth range; the exact default with a per-pixel one."""
    data = make_contract_data(h=H, w=W, n_spatial=V, n_frames=6)
    small = dict(n_coarse_samples_per_ray=S, ray_tile=256, render_stride=2)
    if request.param == "fast":
        cfg_j = j_apply_perf_preset(JRenderConfig(knn_tile=256, **small))
        cfg = apply_perf_preset(RenderConfig(**small))
    else:
        data = dict(data, depth_range=_per_pixel_depth_range(data))
        cfg_j, cfg = JRenderConfig(knn_tile=256, **small), RenderConfig(**small)
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p: j_render_novel_view(models, p, jdata, cfg_j, key, static_mode="gnt")
    )(params))
    fnet, gnt = init_gnt_models(device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
    gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
    noise = np.array(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()
             if isinstance(v, np.ndarray)}
    got = render_novel_view((fnet, gnt), tdata, cfg, noise=torch.from_numpy(noise))
    return {"ref": ref, "got": got}


def test_strided_shapes(rendered):
    got = rendered["got"]
    assert sorted(got) == sorted(rendered["ref"])
    for key in ("combined_rgb", "static_coarse_rgb", "render_dyn_rgb"):
        assert tuple(got[key].shape) == (H // 2, W // 2, 3)
    assert tuple(got["render_dyn_mask"].shape) == (H // 2, W // 2, 1)
    # the dynamic layer's temporal renders stay at full size, as in JAX
    assert tuple(got["render_dyn_temporal_closest_rgb"].shape) == \
        rendered["ref"]["render_dyn_temporal_closest_rgb"].shape


@pytest.mark.parametrize("key", ["combined_rgb", "static_coarse_rgb", "static_coarse_depth",
                                 "static_coarse_inbound_cnt"])
def test_strided_render_matches_jax(rendered, key):
    got, ref = rendered["got"][key].numpy(), rendered["ref"][key]
    assert got.shape == ref.shape and np.isfinite(got).all()
    tol = next(t for name, t in TOL.items() if key.endswith(name))
    np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize("key", ["render_dyn_rgb", "render_dyn_mask"])
def test_resized_dynamic_layer_matches_jax(rendered, key):
    got, ref = rendered["got"][key].numpy(), rendered["ref"][key]
    np.testing.assert_allclose(got, ref, atol=1e-4)
    if key == "render_dyn_mask":
        assert 0.0 < float(got.mean()) < 1.0
