"""The port's ResUNet, GNT and quad sampler against the JAX package, with
weights carried from the flax initialiser through ``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.models.gnt.feature_net import ResUNet as JResUNet
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu.models.gnt import projector as jproj
from pgdvs_tpu.core import cameras as jcam
from pgdvs_tpu_torch.core import cameras as tcam
from pgdvs_tpu_torch.models.gnt.feature_net import ResUNet
from pgdvs_tpu_torch.models.gnt.network import GNT
from pgdvs_tpu_torch.models.gnt import params_from_jax as pj
from pgdvs_tpu_torch.models.gnt import projector as tproj


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    """flax (feature_net, gnt) params from the JAX package's initialiser."""
    from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models

    fnet_j, gnt_j = make_gnt_models(dtype="float32", ret_view_std=False)
    return init_gnt_params(jax.random.PRNGKey(0), fnet_j, gnt_j, n_src=2)


def test_resunet_matches_flax(jax_params):
    """Same features from the same weights, f32 convs on both sides. The
    image is 64x80: at smaller sizes the 2x2 bottleneck's InstanceNorm
    amplifies summation-order differences past 1e-4."""
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(1, 64, 80, 3)).astype(np.float32)
    net_j = JResUNet()
    params = jax_params["feature_net"]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(net_j.apply(params, x))
    net = ResUNet().eval()
    net.load_state_dict(pj.resunet_state_dict(_np_tree(params)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 16, 20, 32)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_gnt_matches_flax_f32(jax_params):
    """Plain port GNT vs flax GNT(dtype=float32), including a ray whose
    samples are invalid in every view (the un-masked fallback)."""
    rng = np.random.default_rng(2)
    r, s, v, f = 6, 16, 4, 32
    rgb_feat = rng.normal(size=(r, s, v, 3 + f)).astype(np.float32)
    ray_diff = rng.normal(size=(r, s, v, 4)).astype(np.float32)
    mask = (rng.uniform(size=(r, s, v, 1)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    pts = rng.normal(size=(r, s, 3)).astype(np.float32)
    ray_d = rng.normal(size=(r, 3)).astype(np.float32)
    gnt_j = JGNT(dtype="float32", ret_view_std=False)
    params = jax_params["gnt"]
    with jax.default_matmul_precision("highest"):
        ref = gnt_j.apply(params, rgb_feat, ray_diff, mask, pts, ray_d)
    gnt = GNT().eval()
    gnt.load_state_dict(pj.gnt_state_dict(_np_tree(params)))
    with torch.no_grad():
        got = gnt(*(torch.from_numpy(a) for a in (rgb_feat, ray_diff, mask, pts, ray_d)))
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]), atol=1e-4)
    np.testing.assert_allclose(got["weights"].numpy(), np.asarray(ref["weights"]),
                               atol=1e-4)


def test_quad_sampler_matches_jax():
    """Fused-map 4-tap sampling vs epipolar_sample_fused(quad=True,
    views_outer=True, with_ray_diff=False, emit_mask=False) on the flattened
    quad maps, at bf16 tolerance (both sides sample bf16 maps)."""
    rng = np.random.default_rng(4)
    v, h, w, f = 3, 24, 32, 32
    rgbs = rng.uniform(size=(v, h, w, 3)).astype(np.float32)
    feats = rng.normal(size=(v, h // 4, w // 4, f)).astype(np.float32)
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 26.0
    k[0, 2], k[1, 2] = w / 2, h / 2
    cams = []
    for i in range(v + 1):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i - 0.15, 0.05 * i, 0.0]
        cams.append(np.asarray(jcam.make_flat_cam(h, w, k, c2w), np.float32))
    tgt, src = cams[0], np.stack(cams[1:])
    pts = (rng.normal(0, 0.8, (20, 9, 3)) + [0, 0, 2.0]).astype(np.float32)
    qmaps = jproj.flatten_quad_maps(
        jproj.build_quad_maps(rgbs, feats, None, dtype=jnp.bfloat16))
    ref = jproj.epipolar_sample_fused(
        pts, tgt, src, qmaps, with_mask=False, quad=True, views_outer=True,
        with_ray_diff=False, emit_mask=False)["rgb_feat"]
    fused = tproj.build_fused_maps(torch.from_numpy(rgbs), torch.from_numpy(feats))
    got = tproj.epipolar_sample_quad(
        torch.from_numpy(pts), tcam.flat_cam_projection(torch.from_numpy(src)), fused)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (v, 20, 9, 3 + f)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=0.03, rtol=0.02)
    assert np.count_nonzero(ref) > 0.5 * ref.size  # most taps land in-image
