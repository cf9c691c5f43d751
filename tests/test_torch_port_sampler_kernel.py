"""The epipolar sampler's hand kernel (``kernels/epipolar.py``) against the
plain samplers (``epipolar_sample_plain``, ``epipolar_sample_quad_masked_plain``)
on a CUDA card only, in both modes, at one benchmark tile (V = 10, R = 2048,
S = 256, 288x550, 32 feature channels) and at a ragged shape (V = 3,
R = 1000, S = 320, 360x480).

No JAX here, so the file runs on the GPU machine:

    python -m pytest tests/test_torch_port_sampler_kernel.py -q -m cuda --noconftest

Without a card every test skips. The points reach behind the cameras and
off the images. Bounds, as the samplers' CPU tests hold them: rgb_feat atol
1e-2 + rtol 2^-7 (one or two bf16 ulps of the taps), the ray-difference
code atol 1e-5; the masks equal, except at ties. The kernel sums the
projection, norms and dot products in the order the plain version's einsum
and reductions take on the card at these shapes; where a library picks
another order a coordinate moves by a few float32 ulps, so a tie is a
projection within ``_TIE_ULPS`` ulps of an image edge (or a depth within
them of 0), or a lerped dynamic mask whose distance from 1e-3 such a shift
(four taps) can bridge.
"""

import numpy as np
import pytest
import torch

from pgdvs_tpu_torch.core import cameras as cam
from pgdvs_tpu_torch.kernels import epipolar
from pgdvs_tpu_torch.models.gnt import projector
from pgdvs_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

_TIE_ULPS = 8
# V, R, S, (H, W), (Hf, Wf), F
SHAPES = {"tile": (10, 2048, 256, (288, 550), (72, 138), 32),
          "ragged": (3, 1000, 320, (360, 480), (90, 120), 32)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rig(shape, dev, seed=7):
    """Cameras, points and maps: bf16 rgb and features, float32 0/1 masks
    with soft edges, the fused map of the three."""
    v, r, s, (h, w), (hf, wf), f = SHAPES[shape]
    rng = np.random.default_rng(seed)
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.8 * w
    k[0, 2], k[1, 2] = w / 2, h / 2
    cams = torch.stack([cam.make_flat_cam(h, w, k, _c2w(i)) for i in range(v + 1)]).float()
    # lateral spread past the frusta, depths from behind the cameras to 8
    pts = np.stack([rng.uniform(-3, 3, (r, s)), rng.uniform(-2, 2, (r, s)),
                    rng.uniform(-1, 8, (r, s))], -1).astype(np.float32)
    rgbs = rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32)
    feats = rng.normal(0, 1, (v, hf, wf, f)).astype(np.float32)
    masks = (rng.uniform(0, 1, (v, h, w, 1)) > 0.8).astype(np.float32)
    masks[:, ::7] *= 0.5  # values between 0 and 1 too
    t = {name: torch.from_numpy(x).to(dev) for name, x in
         (("pts", pts), ("rgbs", rgbs), ("feats", feats), ("masks", masks))}
    t["tgt"], t["cams"] = cams[0].to(dev), cams[1:].to(dev)
    t["fused"] = projector.build_fused_maps(t["rgbs"], t["feats"], t["masks"])
    t["rgbs"], t["feats"] = t["rgbs"].to(torch.bfloat16), t["feats"].to(torch.bfloat16)
    return t


def _c2w(i):
    c2w = np.eye(4)
    c2w[:3, 3] = [0.15 * i - 0.7, 0.05 * i, -0.03 * i]
    return c2w


def _ties(t, hw, lerped_mask):
    """Where the in-bounds and dynamic masks may flip: projections within
    _TIE_ULPS ulps of an edge (or depths of 0), lerped masks within the
    change such a shift makes of 1e-3."""
    h, w = hw
    uv, z, _front = projector.project_all_views(t["pts"], cam.flat_cam_projection(t["cams"]))
    x, y = uv[..., 0], uv[..., 1]
    tol = _TIE_ULPS * torch.finfo(torch.float32).eps * torch.maximum(
        torch.maximum(x.abs(), y.abs()), torch.ones_like(x))
    edge = torch.stack([x.abs(), (x - (w - 1)).abs(), y.abs(), (y - (h - 1)).abs()]).amin(0)
    inb = (edge <= tol) | (z.abs() <= _TIE_ULPS * torch.finfo(torch.float32).eps * 10)
    # each of the four tap weights moves by at most tol per axis; plus a
    # bf16 ulp at 1e-3 where the lerp is in bf16
    inv = (lerped_mask - 1e-3).abs() <= 8 * tol + 2.0 ** -17
    return inb, inv


def _assert_masks(got, ref, ties):
    inb_tie, inv_tie = ties
    for key, tie in (("mask_inbound", inb_tie), ("mask_invalid", inv_tie)):
        off = got[key] != ref[key]
        assert not (off & ~tie).any(), f"{key}: {int((off & ~tie).sum())} flips off a tie"
        assert int(off.sum()) <= 1e-4 * off.numel()
    assert torch.equal(got["mask"], got["mask_inbound"] & ~got["mask_invalid"])
    assert 0.05 < got["mask_inbound"].float().mean() < 0.95
    assert got["mask_invalid"].any() and not got["mask_invalid"].all()


def _assert_features(got, ref):
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("with_mask", [True, False], ids=["dyn_mask", "no_mask"])
def test_exact_kernel_matches_plain(card, shape, with_mask):
    t = _rig(shape, card)
    masks = t["masks"] if with_mask else None
    args = (t["pts"], t["tgt"], t["cams"], t["rgbs"], t["feats"], masks)
    before = epipolar.launches["exact"]
    got = projector.epipolar_sample(*args)
    torch.cuda.synchronize()
    assert epipolar.launches["exact"] == before + 1
    ref = projector.epipolar_sample_plain(*args)
    _assert_features(got["rgb_feat"], ref["rgb_feat"])
    assert got["ray_diff"].dtype == torch.float32
    torch.testing.assert_close(got["ray_diff"], ref["ray_diff"], atol=1e-5, rtol=0)
    if with_mask:
        uv, _z, _f = projector.project_all_views(t["pts"], cam.flat_cam_projection(t["cams"]))
        lerped = projector.multiview_bilinear(t["masks"], uv[..., 0], uv[..., 1])[..., 0]
        _assert_masks(got, ref, _ties(t, SHAPES[shape][3], lerped))
    else:
        assert not got["mask_invalid"].any()
        inb_tie, _ = _ties(t, SHAPES[shape][3], torch.zeros(()))
        off = got["mask_inbound"] != ref["mask_inbound"]
        assert not (off & ~inb_tie).any()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_quad_masked_kernel_matches_plain(card, shape):
    t = _rig(shape, card)
    proj = cam.flat_cam_projection(t["cams"])
    before = epipolar.launches["quad_masked"]
    got = projector.epipolar_sample_quad_masked(t["pts"], proj, t["fused"])
    torch.cuda.synchronize()
    assert epipolar.launches["quad_masked"] == before + 1
    ref = projector.epipolar_sample_quad_masked_plain(t["pts"], proj, t["fused"])
    _assert_features(got["rgb_feat"], ref["rgb_feat"])
    lerped = projector._sample_fused_quad(t["pts"], proj, t["fused"])[0][..., -1].float()
    _assert_masks(got, ref, _ties(t, SHAPES[shape][3], lerped))


def test_kernel_counts_launches_in_tracing(card):
    t = _rig("ragged", card)
    proj = cam.flat_cam_projection(t["cams"])
    tracing.reset()
    tracing.enable()
    try:
        projector.epipolar_sample_quad_masked(t["pts"], proj, t["fused"])
        projector.epipolar_sample(t["pts"], t["tgt"], t["cams"], t["rgbs"], t["feats"])
        counters = tracing.summary()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    assert counters["sampler.launches"] == 2


def test_kernel_refuses_what_it_does_not_take(card):
    t = _rig("ragged", card)
    proj = cam.flat_cam_projection(t["cams"])
    with pytest.raises(ValueError, match="bfloat16"):
        projector.epipolar_sample_quad_masked(t["pts"], proj, t["fused"].float())
    with pytest.raises(ValueError, match="bfloat16"):
        projector.epipolar_sample(t["pts"], t["tgt"], t["cams"], t["rgbs"].float(), t["feats"])
    with pytest.raises(ValueError, match="float32 into bfloat16"):
        projector.epipolar_sample(t["pts"], t["tgt"], t["cams"], t["rgbs"], t["feats"],
                                  out_dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        projector.epipolar_sample_quad_masked(t["pts"], proj, t["fused"].transpose(1, 2))
