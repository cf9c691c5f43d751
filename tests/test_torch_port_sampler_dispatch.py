"""The routes around the epipolar sampler's hand kernel, on the CPU: the
public exact and quad-masked samplers are their plain versions there, bit
for bit and without a launch; the training render takes the plain exact
sampler by name; the kernel's C entries are declared as the source
defines them; its wrappers refuse CPU tensors. No JAX; a few seconds.
"""

import re

import numpy as np
import pytest
import torch

from pgdvs_tpu_torch.core import cameras as cam
from pgdvs_tpu_torch.kernels import _build, epipolar
from pgdvs_tpu_torch.models.gnt import projector
from pgdvs_tpu_torch.renderers import static_gnt
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.utils import tracing


def _rig(v=3, r=9, s=7, hw=(12, 16), fhw=(3, 4), f=32, seed=3):
    rng = np.random.default_rng(seed)
    h, w = hw
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.8 * w
    k[0, 2], k[1, 2] = w / 2, h / 2
    cams = []
    for i in range(v + 1):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * i - 0.3, 0.05 * i, -0.1 * i]
        cams.append(cam.make_flat_cam(h, w, k, c2w))
    cams = torch.stack(cams).float()
    pts = np.stack([rng.uniform(-3, 3, (r, s)), rng.uniform(-2, 2, (r, s)),
                    rng.uniform(-1, 8, (r, s))], -1).astype(np.float32)
    rgbs = torch.from_numpy(rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(0, 1, (v,) + fhw + (f,)).astype(np.float32))
    masks = torch.from_numpy((rng.uniform(0, 1, (v, h, w, 1)) > 0.7).astype(np.float32))
    return torch.from_numpy(pts), cams[0], cams[1:], rgbs, feats, masks


def _assert_same(got, ref):
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].dtype == ref[key].dtype and torch.equal(got[key], ref[key]), key


@pytest.mark.parametrize("mode", ["exact", "exact_no_mask", "quad_masked"])
def test_public_samplers_are_plain_on_cpu(mode):
    pts, tgt, cams, rgbs, feats, masks = _rig()
    before = sum(epipolar.launches.values())
    tracing.reset()
    tracing.enable()
    try:
        if mode == "quad_masked":
            fused = projector.build_fused_maps(rgbs, feats, masks)
            proj = cam.flat_cam_projection(cams)
            got = projector.epipolar_sample_quad_masked(pts, proj, fused)
            ref = projector.epipolar_sample_quad_masked_plain(pts, proj, fused)
        else:
            args = (pts, tgt, cams, rgbs.to(torch.bfloat16), feats.to(torch.bfloat16),
                    masks if mode == "exact" else None)
            got = projector.epipolar_sample(*args)
            ref = projector.epipolar_sample_plain(*args)
        counters = tracing.summary()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    _assert_same(got, ref)
    assert got["mask_inbound"].any() and not got["mask_inbound"].all()
    assert sum(epipolar.launches.values()) == before
    assert "sampler.launches" not in counters


def test_render_rays_plain_takes_the_plain_exact_sampler(monkeypatch):
    pts, tgt, cams, rgbs, feats, _masks = _rig(fhw=(3, 4))
    _fnet, gnt = static_gnt.init_gnt_models(seed=0, device="cpu")
    calls = []

    def public(*a, **kw):
        raise AssertionError("render_rays_plain reached the public sampler")

    def plain(*a, **kw):
        calls.append(kw)
        return projector.epipolar_sample_plain(*a, **kw)

    monkeypatch.setattr(static_gnt, "epipolar_sample", public)
    monkeypatch.setattr(static_gnt, "epipolar_sample_plain", plain)
    rays_o = torch.zeros(4, 3)
    rays_d = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.0, 1.0], [0.0, 0.1, 1.0], [-0.1, 0.1, 1.0]])
    depth_range = torch.tensor([[1.0, 6.0]]).expand(4, 2)
    cfg = RenderConfig(n_coarse_samples_per_ray=8, n_fine_samples_per_ray=4)
    out = static_gnt.render_rays_plain(gnt, rays_o, rays_d, depth_range, tgt, cams, rgbs,
                                       feats, cfg)
    assert len(calls) == 2  # the coarse and the fine pass
    assert out["rgb"].shape == (4, 3) and torch.isfinite(out["rgb"]).all()


def test_sampler_entries_declared():
    src = (_build.CSRC_DIR / "epipolar_sample.cu").read_text()
    for name in ("epipolar_exact", "epipolar_quad_masked"):
        args, res = _build.SIGNATURES[name]
        assert res is _build.c_int
        params = re.search(rf"\bint {name}\(([^)]*)\)", src).group(1).split(",")
        assert len(params) == len(args), name
        for p, a in zip(params, args):
            want = {"float": _build.c_float, "int": _build.c_int}.get(p.split()[0],
                                                                      _build.c_void_p)
            assert a is want, (name, p)


def test_kernel_wrappers_refuse_cpu_tensors():
    pts, tgt, cams, rgbs, feats, masks = _rig()
    with pytest.raises(ValueError, match="CUDA"):
        epipolar.sample_quad_masked(pts, cam.flat_cam_projection(cams),
                                    projector.build_fused_maps(rgbs, feats, masks))
    with pytest.raises(ValueError, match="CUDA"):
        epipolar.sample_exact(pts, tgt, cams, rgbs.to(torch.bfloat16),
                              feats.to(torch.bfloat16))
