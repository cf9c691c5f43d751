"""The torch port's core math and synthetic data against the JAX package.

Same inputs (numpy, from a seed) through both; float32 on the CPU.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.core import cameras as jcam
from pgdvs_tpu.core import geometry as jgeo
from pgdvs_tpu.core import interpolate as jint
from pgdvs_tpu.core import sampling as jsamp
from pgdvs_tpu.data.synthetic import make_contract_data as j_make_contract_data
from pgdvs_tpu_torch.core import cameras as tcam
from pgdvs_tpu_torch.core import geometry as tgeo
from pgdvs_tpu_torch.core import interpolate as tint
from pgdvs_tpu_torch.core import sampling as tsamp
from pgdvs_tpu_torch.data.synthetic import make_contract_data as t_make_contract_data

ATOL = 1e-5  # float32 on both sides


def _close(a, b, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def rig():
    rng = np.random.default_rng(3)
    h, w = 24, 32
    k = np.eye(4)
    k[0, 0], k[1, 1] = 30.0, 28.0
    k[0, 1] = 0.3
    k[0, 2], k[1, 2] = w / 2 + 0.4, h / 2 - 0.3
    cams = []
    for i in range(3):
        ang = 0.1 * i
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]]
        c2w[:3, 3] = [0.3 * i - 0.2, 0.1 * i, -0.1 * i]
        cams.append(np.asarray(jcam.make_flat_cam(h, w, k, c2w), np.float32))
    pts = (rng.normal(0, 1.0, (7, 5, 3)) + [0, 0, 3.0]).astype(np.float32)
    pts[0, 0] = [0.0, 0.0, -2.0]  # behind every camera
    return {"h": h, "w": w, "k": k, "cams": np.stack(cams), "pts": pts, "rng": rng}


def test_flat_cam_and_projection(rig):
    cam = rig["cams"][1]
    _close(tcam.make_flat_cam(rig["h"], rig["w"], rig["k"], cam[18:].reshape(4, 4)), cam)
    _close(tcam.flat_cam_projection(_t(rig["cams"])),
           jax.vmap(jcam.flat_cam_projection)(rig["cams"]), atol=1e-4)
    for c in rig["cams"]:
        uv_j, z_j, f_j = jcam.project_points(rig["pts"], c)
        uv_t, z_t, f_t = tcam.project_points(_t(rig["pts"]), _t(c))
        _close(uv_t, uv_j, atol=1e-4)
        _close(z_t, z_j)
        np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
        np.testing.assert_array_equal(
            tcam.pixel_inbound(uv_t, rig["h"], rig["w"]).numpy(),
            np.asarray(jcam.pixel_inbound(uv_j, float(rig["h"]), float(rig["w"]))),
        )


def test_get_rays_and_ray_diff(rig):
    cam = rig["cams"][2]
    ro_j, rd_j, uv_j, hw_j = jcam.get_rays(
        rig["h"], rig["w"], jcam.flat_cam_intrinsics(cam), jcam.flat_cam_c2w(cam))
    ro_t, rd_t, uv_t, hw_t = tcam.get_rays(
        rig["h"], rig["w"], tcam.flat_cam_intrinsics(_t(cam)),
        tcam.flat_cam_c2w(_t(cam)))
    assert hw_j == hw_t
    _close(ro_t, ro_j)
    _close(rd_t, rd_j)
    _close(uv_t, uv_j)
    tgt, src = rig["cams"][0], rig["cams"][1]
    rd_j = jcam.ray_diff_features(rig["pts"], jcam.flat_cam_c2w(tgt),
                                  jcam.flat_cam_c2w(src))
    rd_t = tcam.ray_diff_features(_t(rig["pts"]), _t(tgt[18:].reshape(4, 4)[:3, 3]),
                                  _t(src[18:].reshape(4, 4)[:3, 3]))
    _close(rd_t, rd_j)


@pytest.mark.parametrize("inv_uniform", [True, False])
def test_sample_along_rays(rig, inv_uniform):
    rng = rig["rng"]
    ro = rng.normal(size=(9, 3)).astype(np.float32)
    rd = rng.normal(size=(9, 3)).astype(np.float32)
    dr = np.stack([rng.uniform(1, 2, 9), rng.uniform(4, 8, 9)], -1).astype(np.float32)
    pj, zj = jsamp.sample_along_rays(ro, rd, dr, 16, inv_uniform=inv_uniform)
    pt, zt = tsamp.sample_along_rays(_t(ro), _t(rd), _t(dr), 16, inv_uniform=inv_uniform)
    _close(zt, zj)
    _close(pt, pj)


@pytest.mark.parametrize("zero_pad", [True, False])
@pytest.mark.parametrize("channels", [3, 16])
def test_bilinear_and_nearest(rig, zero_pad, channels):
    rng = rig["rng"]
    img = rng.uniform(size=(11, 13, channels)).astype(np.float32)
    x = rng.uniform(-2, 15, (40,)).astype(np.float32)
    y = rng.uniform(-2, 13, (40,)).astype(np.float32)
    x[:4] = [0.0, 12.0, 12.5, -0.5]  # on and just past the border
    _close(tint.bilinear_sample(_t(img), _t(x), _t(y), zero_pad=zero_pad),
           jint.bilinear_sample(img, x, y, zero_pad=zero_pad))
    _close(tint.nearest_sample(_t(img), _t(x), _t(y)), jint.nearest_sample(img, x, y))


@pytest.mark.parametrize("zero_pad", [True, False])
@pytest.mark.parametrize("hw", [(1, 13), (11, 1), (1, 1)])
def test_bilinear_one_pixel_axis(rig, zero_pad, hw):
    """An axis one pixel wide (CoTracker's coarsest correlation level on
    small frames): with zero padding its second tap lies outside and adds
    nothing, as JAX's narrow-image path (C < 8) samples it."""
    rng = rig["rng"]
    img = rng.uniform(size=hw + (1,)).astype(np.float32)
    x = rng.uniform(-1.5, hw[1] + 0.5, (40,)).astype(np.float32)
    y = rng.uniform(-1.5, hw[0] + 0.5, (40,)).astype(np.float32)
    _close(tint.bilinear_sample(_t(img), _t(x), _t(y), zero_pad=zero_pad),
           jint.bilinear_sample(img, x, y, zero_pad=zero_pad))


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_and_backwarp(rig, align_corners):
    rng = rig["rng"]
    img = rng.uniform(size=(6, 8, 5)).astype(np.float32)
    _close(tint.resize_bilinear(_t(img), 24, 32, align_corners=align_corners),
           jint.resize_bilinear(img, 24, 32, align_corners=align_corners))
    flow = rng.normal(0, 2.0, (6, 8, 2)).astype(np.float32)
    _close(tint.backwarp(_t(img), _t(flow)), jint.backwarp(img, flow))


def test_uv_depth_to_world(rig):
    rng = rig["rng"]
    uv = rng.uniform(0, 30, (10, 2)).astype(np.float32)
    depth = rng.uniform(1, 5, (10,)).astype(np.float32)
    cam = rig["cams"][1]
    k4, c2w = cam[2:18].reshape(4, 4), cam[18:].reshape(4, 4)
    _close(tgeo.uv_depth_to_world(_t(uv), _t(depth), _t(k4), _t(c2w)),
           jgeo.uv_depth_to_world(uv, depth, k4, c2w), atol=1e-4)


def test_make_contract_data_matches():
    kw = dict(h=24, w=32, n_spatial=3, n_frames=6)
    dj, dt = j_make_contract_data(**kw), t_make_contract_data(**kw)
    assert sorted(dj) == sorted(dt)
    for key in dj:
        if key == "misc":
            _close(dt[key]["tgt_dyn_mask"], dj[key]["tgt_dyn_mask"], atol=1e-6)
            continue
        assert np.asarray(dt[key]).shape == np.asarray(dj[key]).shape, key
        _close(dt[key], dj[key], atol=1e-6, rtol=0)


def test_port_imports_no_jax():
    """The port package and every submodule import without JAX, the JAX
    package, PIL or OpenCV."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import pgdvs_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pgdvs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pgdvs_tpu', 'PIL', 'cv2'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
