"""The hand kernels (K1 on sampled features and on patch rows, K2 in each
operand mode, K3a, K3b, the prologue alone per loader) against their plain
versions, on a CUDA card only.

No JAX here, so the file runs on the GPU machine:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda

Without a card every test skips. Tolerances: rgb atol/rtol 0.02, count 0.01
(bf16 operands with f32 accumulation against the float32 plain network);
weights 0.05 / S, a share of their mean 1/S, which rejects weights written
uniform or in a wrong sample order wherever the samples of a ray differ.
One K3 half-block's q: atol 0.02 + 2 % of |q|. The tiny renders are held to
the slice's bounds. Shapes include N not a multiple of the view kernel's
16-token tile and V from 1 to 32.
"""

import collections

import numpy as np
import pytest
import torch

from pgdvs_tpu_torch.core import cameras as cam
from pgdvs_tpu_torch.kernels import gnt_fused as k1
from pgdvs_tpu_torch.kernels import gnt_fused_mono3 as k2
from pgdvs_tpu_torch.kernels import gnt_fused_patch as kp
from pgdvs_tpu_torch.kernels import gnt_fused_split as k3
from pgdvs_tpu_torch.models.gnt.network import sinusoidal_embed

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(v, r, s, behind=False, seed=13, hw=(20, 28)):
    rng = np.random.default_rng(seed)
    h, w = hw
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 25.0
    k[0, 2], k[1, 2] = w / 2, h / 2
    cams = []
    for i in range(v):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * i - 0.3, 0.1 * i, -0.2 * i]
        cams.append(cam.make_flat_cam(h, w, k, c2w))
    cams = torch.stack(cams)
    if behind:
        pts = np.full((r, s, 3), -50.0, np.float32)
    else:
        pts = (rng.normal(0, 1.2, (r, s, 3)) + [0, 0, 2.5]).astype(np.float32)
    ray_d = torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32))
    return (
        torch.from_numpy(rng.normal(size=(v, r, s, 35)).astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(pts),
        sinusoidal_embed(ray_d / ray_d.norm(dim=-1, keepdim=True)),
        torch.cat([cam.flat_cam_c2w(cams[0])[None, :3, 3], cam.flat_cam_c2w(cams)[:, :3, 3]]),
        cam.flat_cam_projection(cams),
        hw,
    )


def _assert_weights(got, ref, s, spread):
    """Weights [R, S] within 0.05 / S; where the samples of a ray differ
    (``spread``), uniform or reordered weights would not be."""
    tol = 0.05 / s
    torch.testing.assert_close(got, ref, atol=tol, rtol=0)
    if spread:
        eo = torch.cat([torch.arange(0, s, 2), torch.arange(1, s, 2)]).to(ref.device)
        for wrong in (torch.full_like(ref, 1.0 / s), ref.flip(-1), ref[:, eo]):
            assert float((wrong - ref).abs().max()) > tol


def _assert_matches_plain(got, ref, s, behind):
    torch.testing.assert_close(got["rgb"], ref["rgb"], atol=0.02, rtol=0.02)
    # points all at one place give uniform weights by right
    _assert_weights(got["weights"], ref["weights"], s, spread=not behind)
    if "inbound_cnt_raw" in ref:
        torch.testing.assert_close(got["inbound_cnt_raw"], ref["inbound_cnt_raw"],
                                   atol=0.01, rtol=0)


@pytest.mark.parametrize("v,r,s,behind", [(5, 16, 32, False), (5, 16, 23, False),
                                          (5, 16, 32, True), (10, 64, 256, False),
                                          (5, 16, 384, False)])
def test_kernel_matches_plain(card, v, r, s, behind):
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    ops = [o.to(card) if torch.is_tensor(o) else o for o in _operands(v, r, s, behind)]
    before = k1.gnt_fused_mono4.launches
    got = k1.gnt_fused_mono4(gnt, *ops)
    torch.cuda.synchronize()
    assert k1.gnt_fused_mono4.launches == before + 1
    ref = k1.gnt_fused_mono4_plain(gnt, *ops)
    _assert_matches_plain(got, ref, s, behind)


def test_render_on_card_matches_cpu(card):
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)
    cfg = apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=16, ray_tile=256)).replace(
        epipolar_mode="quad")
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 32, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", card):
        tdata = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in data.items()
                 if isinstance(v, np.ndarray)}
        before = k1.gnt_fused_mono4.launches
        outs[str(dev)] = render_novel_view(init_gnt_models(seed=0, device=dev), tdata,
                                           cfg, noise=noise.to(dev))
        launched = k1.gnt_fused_mono4.launches - before
        # one launch per ray tile: 24 * 32 rays in tiles of 256
        assert launched == (0 if dev == "cpu" else 3)
    got, ref = outs["cuda"], outs["cpu"]
    for key, tol in (("combined_rgb", 0.04), ("static_coarse_depth", 0.1),
                     ("static_coarse_inbound_cnt", 0.02)):
        torch.testing.assert_close(got[key].cpu(), ref[key], atol=tol, rtol=0)


def _patch_operands(v, r, s, behind, block_rays, n_pos, seed=21):
    """K1's patch_rows operands: random bf16 rows [V, R/B, S, n_pos*35] and
    Dirichlet coefficients [V, R/4, 4, S, n_pos] (non-negative, summing to 1
    per tap, like bilinear weights), then the rig's pts, view code,
    centres, projections and map size."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(0, 0.5, (v, r // block_rays, s, n_pos * 35)).astype(np.float32)
    coef = rng.dirichlet(np.ones(n_pos), (v, r // 4, 4, s)).astype(np.float32)
    return (torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(coef).to(torch.bfloat16),
            *_operands(v, r, s, behind)[1:])


@pytest.mark.parametrize("v,r,s,behind,block_rays,n_pos", [
    (5, 16, 23, False, 4, 16), (5, 16, 23, False, 8, 24), (5, 16, 32, True, 8, 24),
    (10, 64, 256, False, 8, 24)])
def test_patch_kernel_matches_plain(card, v, r, s, behind, block_rays, n_pos):
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    ops = [o.to(card) if torch.is_tensor(o) else o
           for o in _patch_operands(v, r, s, behind, block_rays, n_pos)]
    before = kp.gnt_fused_mono4_patch.launches
    got = kp.gnt_fused_mono4_patch(gnt, *ops)
    torch.cuda.synchronize()
    assert kp.gnt_fused_mono4_patch.launches == before + 1
    ref = kp.gnt_fused_mono4_patch_plain(gnt, *ops)
    _assert_matches_plain(got, ref, s, behind)


def test_patch_render_on_card_matches_cpu(card):
    """The fast preset (patch sampling on 4x2 blocks) on the card: K1's
    patch_rows mode once per ray tile and no other kernel."""
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)
    cfg = apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=16, ray_tile=256))
    assert cfg.epipolar_mode == "patch"
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 32, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", card):
        tdata = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in data.items()
                 if isinstance(v, np.ndarray)}
        k1.gnt_fused_mono4.launches = kp.gnt_fused_mono4_patch.launches = 0
        outs[str(dev)] = render_novel_view(init_gnt_models(seed=0, device=dev), tdata,
                                           cfg, noise=noise.to(dev))
        # one launch per ray tile: 24 * 32 rays in tiles of 256
        assert kp.gnt_fused_mono4_patch.launches == (0 if dev == "cpu" else 3)
        assert k1.gnt_fused_mono4.launches == 0
    got, ref = outs["cuda"], outs["cpu"]
    for key, tol in (("combined_rgb", 0.04), ("static_coarse_depth", 0.1),
                     ("static_coarse_inbound_cnt", 0.02)):
        torch.testing.assert_close(got[key].cpu(), ref[key], atol=tol, rtol=0)


def _mask(ops, dyn_frac, all_dyn_rays=0, seed=3):
    """K2's mask [V, R, S]: in bounds & in front (the projection test K1
    runs) & not dynamic, dynamic at a random fraction of taps and at every
    view of the first ``all_dyn_rays`` rays."""
    from pgdvs_tpu_torch.core.cameras import pixel_inbound, project_with

    rgb_feat, pts, _vc, _ctr, proj, hw = ops
    uv, _z, front = project_with(proj[:, None, None], pts[None])
    inbound = pixel_inbound(uv, float(hw[0]), float(hw[1])) & front
    gen = torch.Generator(device=pts.device).manual_seed(seed)
    dyn = torch.rand(inbound.shape, generator=gen, device=pts.device) < dyn_frac
    dyn[:, :all_dyn_rays] = True
    return inbound & ~dyn


@pytest.mark.parametrize("v,r,s,behind,dyn_frac,all_dyn", [
    (5, 16, 32, False, 0.3, 2), (5, 16, 23, False, 0.3, 2), (5, 16, 32, True, 0.3, 0),
    (5, 16, 32, False, 1.0, 0), (10, 64, 256, False, 0.2, 4)])
def test_k2_matches_plain(card, v, r, s, behind, dyn_frac, all_dyn):
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    ops = [o.to(card) if torch.is_tensor(o) else o for o in _operands(v, r, s, behind)]
    mask = _mask(ops, dyn_frac, all_dyn)
    args = (ops[0], mask, ops[1], ops[2], ops[3])
    before = k2.gnt_fused_mono3.launches
    got = k2.gnt_fused_mono3(gnt, *args)
    torch.cuda.synchronize()
    assert k2.gnt_fused_mono3.launches == before + 1
    ref = k2.gnt_fused_mono3_plain(gnt, *args)
    _assert_matches_plain(got, ref, s, behind)


def test_default_render_on_card_matches_cpu(card):
    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)
    cfg = resolve_benchmark("default")[0].replace(n_coarse_samples_per_ray=16,
                                                  ray_tile=256)
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 32, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", card):
        tdata = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in data.items()
                 if isinstance(v, np.ndarray)}
        k1.gnt_fused_mono4.launches = k2.gnt_fused_mono3.launches = 0
        outs[str(dev)] = render_novel_view(init_gnt_models(seed=0, device=dev), tdata,
                                           cfg, noise=noise.to(dev))
        # one K2 launch per ray tile (24 * 32 rays in tiles of 256), no K1
        assert k2.gnt_fused_mono3.launches == (0 if dev == "cpu" else 3)
        assert k1.gnt_fused_mono4.launches == 0
    got, ref = outs["cuda"], outs["cpu"]
    for key, tol in (("combined_rgb", 0.04), ("static_coarse_depth", 0.1),
                     ("static_coarse_inbound_cnt", 0.02), ("static_coarse_dyn_cnt", 0.02)):
        torch.testing.assert_close(got[key].cpu(), ref[key], atol=tol, rtol=0)


def _split_operands(card, v, r, s, behind, dyn_frac, all_dyn):
    """q [R, S, 64] f32 and h [V, R, S, 64] bf16 at random, the rig's
    ray-diff code [V, R, S, 4] and K2's mask [V, R, S]."""
    ops = [o.to(card) if torch.is_tensor(o) else o for o in _operands(v, r, s, behind)]
    rd = cam.ray_diff_features(ops[1][None], ops[3][0], ops[3][1:, None, None, :])
    gen = torch.Generator(device=card).manual_seed(7)
    q = torch.randn((r, s, 64), generator=gen, device=card)
    h = torch.randn((v, r, s, 64), generator=gen, device=card).to(torch.bfloat16)
    return ops, q, h, rd, _mask(ops, dyn_frac, all_dyn)


SPLIT_CASES = [(5, 16, 32, False, 0.3, 2), (5, 16, 23, False, 0.3, 2),
               (5, 16, 32, True, 0.3, 0), (5, 16, 32, False, 1.0, 0),
               (10, 64, 256, False, 0.2, 4)]


@pytest.mark.parametrize("v,r,s,behind,dyn_frac,all_dyn", SPLIT_CASES)
def test_k3_half_blocks_match_plain(card, v, r, s, behind, dyn_frac, all_dyn):
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    _ops, q, h, rd, mask = _split_operands(card, v, r, s, behind, dyn_frac, all_dyn)
    packed = k3.pack_split_weights(gnt, card)
    vt, rt = packed.view[3], packed.ray[3]
    with pytest.raises(ValueError):  # on CUDA a wrapper takes packed weights only
        k3.gnt_split_view(q, h, rd, mask, gnt.view_crosstrans[3])
    before = (k3.gnt_split_view.launches, k3.gnt_split_ray.launches)
    got = k3.gnt_split_view(q, h, rd, mask, vt)
    got_q, got_w = k3.gnt_split_ray(q, rt)
    torch.cuda.synchronize()
    assert (k3.gnt_split_view.launches, k3.gnt_split_ray.launches) == (
        before[0] + 1, before[1] + 1)
    ref = k3.split_view_plain(q, h, rd, mask, vt)
    torch.testing.assert_close(got, ref, atol=0.02, rtol=0.02)
    ref_q, ref_w = k3.split_ray_plain(q, rt)
    torch.testing.assert_close(got_q, ref_q, atol=0.02, rtol=0.02)
    _assert_weights(got_w, ref_w, s, spread=True)  # random q spreads them


@pytest.mark.parametrize("v,r,s", [(1, 5, 23), (32, 5, 23), (10, 7, 13)])
def test_k3a_view_counts_and_ragged_n_match_plain(card, v, r, s):
    """K3a at one view, at the 32 the validity bitmask holds, and with N
    (115, 91) not a multiple of the view kernel's 16-token tile."""
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    _ops, q, h, rd, mask = _split_operands(card, v, r, s, False, 0.3, 2)
    vt = k3.pack_split_weights(gnt, card).view[4]
    before = k3.gnt_split_view.launches
    got = k3.gnt_split_view(q, h, rd, mask, vt)
    torch.cuda.synchronize()
    assert k3.gnt_split_view.launches == before + 1
    torch.testing.assert_close(got, k3.split_view_plain(q, h, rd, mask, vt),
                               atol=0.02, rtol=0.02)


def test_k1_and_k2_unfolded_ragged_tile_match_plain(card):
    """K1 and K2's unfolded mode on 5 rays x 23 samples: N = 115 tokens, not a
    multiple of the view kernel's 16-token tile."""
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    ops = [o.to(card) if torch.is_tensor(o) else o for o in _operands(5, 5, 23)]
    got = k1.gnt_fused_mono4(gnt, *ops)
    torch.cuda.synchronize()
    _assert_matches_plain(got, k1.gnt_fused_mono4_plain(gnt, *ops), 23, False)
    args, kw = _mode_operands(card, 5, 5, 23, False, 0.3, "unfolded")
    before = k2.gnt_fused_apply_mono3.launches["unfolded"]
    got = k2.gnt_fused_apply_mono3(gnt, *args, **kw)
    torch.cuda.synchronize()
    assert k2.gnt_fused_apply_mono3.launches["unfolded"] == before + 1
    _assert_matches_plain(got, k2.gnt_fused_apply_mono3_plain(gnt, *args, **kw), 23, False)


@pytest.mark.parametrize("v,r,s,behind,dyn_frac,all_dyn", SPLIT_CASES)
def test_k3_split_forward_matches_plain(card, v, r, s, behind, dyn_frac, all_dyn):
    from pgdvs_tpu_torch.models.gnt.network import sinusoidal_embed
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    ops, _q, _h, rd, mask = _split_operands(card, v, r, s, behind, dyn_frac, all_dyn)
    args = (ops[0], rd, mask, sinusoidal_embed(ops[1]), ops[2])
    before = k3.gnt_split_view.launches
    got = k3.gnt_fused_split(gnt, *args)
    torch.cuda.synchronize()
    assert k3.gnt_split_view.launches == before + 8
    _assert_matches_plain(got, k3.gnt_fused_split_plain(gnt, *args), s, behind)


def test_exact_default_render_on_card_matches_cpu(card):
    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)
    cfg = resolve_benchmark("default", preset="exact")[0].replace(
        n_coarse_samples_per_ray=16, ray_tile=256)
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 32, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", card):
        tdata = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in data.items()
                 if isinstance(v, np.ndarray)}
        k1.gnt_fused_mono4.launches = k2.gnt_fused_mono3.launches = 0
        k3.gnt_split_view.launches = k3.gnt_split_ray.launches = 0
        k2.gnt_fused_apply_mono3.launches = collections.Counter()
        outs[str(dev)] = render_novel_view(init_gnt_models(seed=0, device=dev), tdata,
                                           cfg, noise=noise.to(dev))
        # one launch of K2's unfolded mode per ray tile (24 * 32 rays in
        # tiles of 256), as the JAX package's default runs mono3; no K3
        n = 0 if dev == "cpu" else 3
        assert dict(k2.gnt_fused_apply_mono3.launches) == ({"unfolded": n} if n else {})
        assert (k3.gnt_split_view.launches, k3.gnt_split_ray.launches) == (0, 0)
        assert k1.gnt_fused_mono4.launches == k2.gnt_fused_mono3.launches == 0
    got, ref = outs["cuda"], outs["cpu"]
    for key, tol in (("combined_rgb", 0.04), ("static_coarse_depth", 0.1),
                     ("static_coarse_inbound_cnt", 0.02), ("static_coarse_dyn_cnt", 0.02)):
        torch.testing.assert_close(got[key].cpu(), ref[key], atol=tol, rtol=0)


def _mode_operands(card, v, r, s, behind, dyn_frac, mode, seed=31):
    """The rig's operands of ``gnt_fused_apply_mono3`` in ``mode`` (a
    ``mode_name``): features (random raw quad rows [V, R, S, 140] and
    offsets in [-0.6, 1.6] with fold_lerp; the mask as a trailing channel
    pre-packed), ray-diff code, K2's mask, point and view code, keywords."""
    from pgdvs_tpu_torch.core.cameras import pixel_inbound, project_with

    folds = set(mode.split("+"))
    ops = [o.to(card) if torch.is_tensor(o) else o for o in _operands(v, r, s, behind)]
    rgb_feat, pts, vc, ctr, proj, hw = ops
    if "fold_mask" in folds:
        uv, _z, front = project_with(proj[:, None, None], pts[None])
        valid = pixel_inbound(uv, float(hw[0]), float(hw[1])) & front
    else:
        valid = _mask(ops, dyn_frac, 2 if not behind else 0)
    kw = dict(views_outer=True, separate_mask="separate_mask" in folds,
              fold_pos_code="fold_pos_code" in folds)
    feats = rgb_feat
    if "fold_lerp" in folds:
        gen = torch.Generator(device=card).manual_seed(seed)
        feats = (torch.randn((v, r, s, 4 * 35), generator=gen, device=card)
                 * 0.5).to(torch.bfloat16)
        kw.update(fold_lerp=True, frac=torch.rand((v, r, s, 2), generator=gen,
                                                  device=card) * 2.2 - 0.6)
    if "pre_packed" in folds:
        feats = torch.cat([feats, valid[..., None].to(torch.bfloat16)], dim=-1)
    if "fold_ray_diff" in folds:
        kw.update(pts=pts, cam_centers=ctr)
    if "fold_mask" in folds:
        kw.update(fold_mask_hw=hw, proj_mats=proj)
    rd = None if "fold_ray_diff" in folds else cam.ray_diff_features(
        pts[None], ctr[0], ctr[1:, None, None, :])
    mask = None if folds & {"fold_mask", "pre_packed"} else valid
    pts_code = None if "fold_pos_code" in folds else sinusoidal_embed(pts)
    return (feats, rd, mask, pts_code, vc), kw


K2_MODES = ["unfolded", "pre_packed", "separate_mask", "fold_ray_diff",
            "fold_ray_diff+fold_pos_code", "fold_mask+fold_ray_diff",
            "fold_lerp+separate_mask+fold_ray_diff+fold_pos_code",
            "fold_lerp+fold_mask+fold_ray_diff+fold_pos_code"]


@pytest.mark.parametrize("mode", K2_MODES)
@pytest.mark.parametrize("v,r,s,behind,dyn_frac", [
    (5, 16, 23, False, 0.3), (5, 16, 32, True, 0.3), (10, 64, 256, False, 0.2)])
def test_k2_modes_match_plain(card, mode, v, r, s, behind, dyn_frac):
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    args, kw = _mode_operands(card, v, r, s, behind, dyn_frac, mode)
    before = k2.gnt_fused_apply_mono3.launches[mode]
    got = k2.gnt_fused_apply_mono3(gnt, *args, **kw)
    torch.cuda.synchronize()
    assert k2.gnt_fused_apply_mono3.launches[mode] == before + 1
    _assert_matches_plain(got, k2.gnt_fused_apply_mono3_plain(gnt, *args, **kw), s, behind)


@pytest.mark.parametrize("s", [23, 384, 520])
def test_k3b_any_sample_count_matches_plain(card, s):
    """The ray kernel streams the sample axis: K3b at S past the old
    one-block-per-ray cap (368) against its plain version."""
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    rt = k3.pack_split_weights(gnt, card).ray[5]
    gen = torch.Generator(device=card).manual_seed(s)
    q = torch.randn((16, s, 64), generator=gen, device=card)
    before = k3.gnt_split_ray.launches
    got_q, got_w = k3.gnt_split_ray(q, rt)
    torch.cuda.synchronize()
    assert k3.gnt_split_ray.launches == before + 1
    ref_q, ref_w = k3.split_ray_plain(q, rt)
    torch.testing.assert_close(got_q, ref_q, atol=0.02, rtol=0.02)
    _assert_weights(got_w, ref_w, s, spread=True)


def test_k2_unfolded_above_the_old_cap_matches_plain(card):
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    _fnet, gnt = init_gnt_models(seed=0, device=card)
    args, kw = _mode_operands(card, 5, 16, 384, False, 0.3, "unfolded")
    before = k2.gnt_fused_apply_mono3.launches["unfolded"]
    got = k2.gnt_fused_apply_mono3(gnt, *args, **kw)
    torch.cuda.synchronize()
    assert k2.gnt_fused_apply_mono3.launches["unfolded"] == before + 1
    _assert_matches_plain(got, k2.gnt_fused_apply_mono3_plain(gnt, *args, **kw), 384, False)


def test_render_at_384_samples_matches_cpu(card):
    """The fast preset at n_coarse_samples_per_ray=384, which the old ray
    kernel refused: K1's patch_rows mode once per ray tile."""
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=6)
    cfg = apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=384, ray_tile=256))
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 32, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", card):
        tdata = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in data.items()
                 if isinstance(v, np.ndarray)}
        kp.gnt_fused_mono4_patch.launches = 0
        outs[str(dev)] = render_novel_view(init_gnt_models(seed=0, device=dev), tdata,
                                           cfg, noise=noise.to(dev))
        assert kp.gnt_fused_mono4_patch.launches == (0 if dev == "cpu" else 3)
    got, ref = outs["cuda"], outs["cpu"]
    for key, tol in (("combined_rgb", 0.04), ("static_coarse_depth", 0.1),
                     ("static_coarse_inbound_cnt", 0.02)):
        torch.testing.assert_close(got[key].cpu(), ref[key], atol=tol, rtol=0)


def test_no_sample_cap_is_left(card):
    """The library has no ray shared-memory query and the wrappers no check
    against it; the ray kernel reports its own footprint."""
    from pgdvs_tpu_torch.kernels._build import load_library

    lib = load_library().lib
    with pytest.raises(AttributeError):
        lib.gnt_mono4_ray_smem
    assert not hasattr(k1, "check_ray_smem") and not hasattr(k3, "check_ray_smem")
    assert lib.gnt_ray_blocks_per_sm() >= 1
    assert lib.gnt_ray_smem_bytes() <= torch.cuda.get_device_properties(
        card).shared_memory_per_block_optin


# the prologue alone: (source, row stride or (rays per row block, n_pos), V,
# R, S); N = R * S not a multiple of 8 where the geometry allows it
PROLOGUE_CASES = [
    ("rgb_feat", 35, 1, 5, 23), ("rgb_feat", 36, 1, 5, 23), ("rgb_feat", 35, 32, 5, 23),
    ("rgb_feat", 36, 32, 3, 7), ("patch", (4, 16), 1, 12, 23), ("patch", (4, 16), 32, 4, 23),
    ("patch", (8, 24), 1, 8, 23), ("patch", (8, 24), 32, 8, 40),
    ("quad_rows", None, 1, 5, 23), ("quad_rows", None, 32, 3, 23),
]


def _prologue_operands(source, geom, v, r, s, dev, seed=11):
    rng = np.random.default_rng(seed)

    def b16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(dev)

    if source == "rgb_feat":
        return {"rgb_feat": b16(rng.normal(0, 2, (v, r, s, geom)))}
    if source == "patch":
        nb, n_pos = geom
        coef = rng.uniform(size=(v, r // 4, 4, s, n_pos))
        return {"rows": b16(rng.normal(0, 2, (v, r // nb, s, n_pos * 35))),
                "coef": b16(coef / coef.sum(-1, keepdims=True))}
    return {"rows": b16(rng.normal(0, 2, (v, r, s, 140))),
            "frac": torch.from_numpy(rng.uniform(-0.6, 1.6, (v, r, s, 2)).astype(np.float32))
            .to(dev)}


@pytest.mark.parametrize("source,geom,v,r,s", PROLOGUE_CASES)
def test_prologue_matches_plain(card, source, geom, v, r, s):
    """``k_prologue`` alone against ``prologue_plain``: h and q within one
    bf16 ulp of relative error plus 0.01 (chip_smoke.PRO_TOL); V = 1 and 32,
    S = 23, ragged tiles, row stride 35 and 36, both patch geometries and
    the quad-rows loader."""
    from pgdvs_tpu_torch.kernels import gnt_prologue as kpro
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    gnt = init_gnt_models(seed=0, device=card)[1]
    ops = _prologue_operands(source, geom, v, r, s, card)
    before = kpro.gnt_prologue.launches[source]
    h, q = kpro.gnt_prologue(gnt, **ops)
    torch.cuda.synchronize()
    assert kpro.gnt_prologue.launches[source] == before + 1
    ref_h, ref_q = kpro.prologue_plain(gnt, kpro.prologue_features(35, **ops))
    assert h.shape == (v, r * s, 64) and h.dtype == torch.bfloat16 and q.shape == (r * s, 64)
    for got, ref in ((h.float(), ref_h.float()), (q, ref_q)):
        assert bool(torch.isfinite(got).all())
        err = (got - ref).abs()
        assert bool((err <= 0.01 + 2.0 ** -7 * ref.abs()).all()), float(err.max())


def test_prologue_reads_rows_at_any_offset(card):
    """Sampled features whose data starts 2 bytes past a 16-byte boundary
    (the loader copies each tile's enclosing aligned span) give the same h
    and q as an aligned copy."""
    from pgdvs_tpu_torch.kernels import gnt_prologue as kpro
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    gnt = init_gnt_models(seed=0, device=card)[1]
    feats = _prologue_operands("rgb_feat", 35, 3, 5, 23, card)["rgb_feat"]
    buf = torch.empty(feats.numel() + 8, dtype=torch.bfloat16, device=card)
    off = buf[1:feats.numel() + 1].view(feats.shape)
    off.copy_(feats)
    assert off.data_ptr() % 16 != 0
    h, q = kpro.gnt_prologue(gnt, off)
    h0, q0 = kpro.gnt_prologue(gnt, feats)
    torch.cuda.synchronize()
    assert torch.equal(h, h0) and torch.equal(q, q0)


# ------------------------------------------------- the renderer's other modes

def _render_card_and_cpu(card, cfg, models_kw=None, hw=(24, 32)):
    """The tiny scene rendered on the CPU (plain versions) and on the card
    with the launch counts set to 0 just before; (card out, cpu out,
    {kernel: launches} of the card's render)."""
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.kernels import gnt_prologue as kpro
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    h, w = hw
    data = make_contract_data(h=h, w=w, n_spatial=3, n_frames=6)
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(h, w, 3)).astype(np.float32))
    outs, counted = {}, (k1.gnt_fused_mono4, kp.gnt_fused_mono4_patch, k2.gnt_fused_mono3,
                         k3.gnt_split_view, k3.gnt_split_ray)
    for dev in ("cpu", card):
        tdata = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in data.items()
                 if isinstance(v, np.ndarray)}
        for fn in counted:
            fn.launches = 0
        k2.gnt_fused_apply_mono3.launches = collections.Counter()
        kpro.gnt_prologue.launches = collections.Counter()
        outs[str(dev)] = render_novel_view(init_gnt_models(seed=0, device=dev, **(models_kw or {})),
                                           tdata, cfg, noise=noise.to(dev))
    launches = {fn.__name__: fn.launches for fn in counted if fn.launches}
    launches.update({f"gnt_fused_apply_mono3[{m}]": n
                     for m, n in k2.gnt_fused_apply_mono3.launches.items()})
    return outs["cuda"], outs["cpu"], launches


def _assert_slice_close(got, ref, keys=("combined_rgb", "static_coarse_rgb",
                                        "static_coarse_depth", "static_coarse_inbound_cnt")):
    for key in keys:
        tol = {"rgb": 0.04, "depth": 0.1, "cnt": 0.02, "std": 0.01,
               "normalized": 0.01}[key.rsplit("_", 1)[-1]]
        assert got[key].shape == ref[key].shape
        torch.testing.assert_close(got[key].cpu(), ref[key], atol=tol, rtol=0)


@pytest.mark.parametrize("preset", ["fast", "exact"])
def test_fine_render_on_card_matches_cpu(card, preset):
    """Fine samples (7 + 5, the merged count odd) on the fast preset (K1
    patch_rows) and on `default` exact (K2 unfolded): two launches per ray
    tile, one per pass."""
    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset

    small = dict(n_coarse_samples_per_ray=7, n_fine_samples_per_ray=5, ray_tile=256)
    if preset == "fast":
        cfg, want = apply_perf_preset(RenderConfig(**small)), {"gnt_fused_mono4_patch": 6}
    else:
        cfg = resolve_benchmark("default", preset="exact")[0].replace(**small)
        want = {"gnt_fused_apply_mono3[unfolded]": 6}
    got, ref, launches = _render_card_and_cpu(card, cfg)
    assert launches == want  # 24 * 32 rays in tiles of 256, two passes
    assert got["static_coarse_weights"].shape == (24, 32, 12)
    _assert_slice_close(got, ref)


def test_strided_render_on_card_matches_cpu(card):
    """`default` quad at render stride 2: a 12x16 render on K2, the dynamic
    layer resized to it."""
    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark

    cfg = resolve_benchmark("default")[0].replace(n_coarse_samples_per_ray=16, ray_tile=128,
                                                  render_stride=2)
    got, ref, launches = _render_card_and_cpu(card, cfg)
    assert launches == {"gnt_fused_mono3": 2}
    assert got["render_dyn_rgb"].shape == (12, 16, 3)
    assert got["render_dyn_mask"].shape == (12, 16, 1)
    _assert_slice_close(got, ref, ("combined_rgb", "static_coarse_rgb", "static_coarse_depth",
                                   "static_coarse_inbound_cnt", "static_coarse_dyn_cnt"))


@pytest.mark.parametrize("mode,dyn,want", [
    ("fused", False, {"gnt_fused_mono3": 3}), ("fused", True, {"gnt_fused_mono3": 3}),
    ("quad_i8", False, {"gnt_fused_mono4": 3}), ("quad_i8", True, {"gnt_fused_mono3": 3})])
def test_fused_and_quad_i8_renders_on_card_match_cpu(card, mode, dyn, want):
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset

    cfg = apply_perf_preset(RenderConfig(gnt_use_dyn_mask=dyn, n_coarse_samples_per_ray=16,
                                         ray_tile=256)).replace(epipolar_mode=mode)
    got, ref, launches = _render_card_and_cpu(card, cfg)
    assert launches == want
    _assert_slice_close(got, ref)


def test_view_std_render_on_card_launches_no_kernel(card):
    """A GNT made with ret_view_std renders on the plain network on the card:
    no kernel launch, view-std maps finite, non-zero and as on the CPU."""
    from pgdvs_tpu_torch.renderers.config import RenderConfig

    cfg = RenderConfig(n_coarse_samples_per_ray=16, ray_tile=256, epipolar_mode="quad")
    got, ref, launches = _render_card_and_cpu(card, cfg, {"ret_view_std": True})
    assert launches == {}
    assert bool(torch.isfinite(got["static_coarse_view_std"]).all())
    assert float(got["static_coarse_view_std"][..., 0].min()) > 0
    _assert_slice_close(got, ref, ("combined_rgb", "static_coarse_depth",
                                   "static_coarse_view_std", "static_coarse_view_std_normalized"))


def test_new_samplers_on_card_match_cpu(card):
    """The quad maps, their int8 quantization, both forms of
    epipolar_sample_fused, the 2x2 XLA-combine patch sampler and the fine
    samples, on the card against the same functions on the CPU: the same
    bf16 / float32 steps, so equal up to one bf16 ulp (float32 ulps for the
    fine samples)."""
    from pgdvs_tpu_torch.core import sampling
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.models.gnt import projector as proj
    from pgdvs_tpu_torch.renderers.static_gnt import patch_ray_perm

    rng = np.random.default_rng(2)
    data = make_contract_data(h=24, w=32, n_spatial=3, n_frames=4)
    rgbs = torch.from_numpy(rng.uniform(0, 1, (3, 24, 32, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.uniform(-1, 1, (3, 6, 8, 32)).astype(np.float32))
    masks = torch.from_numpy((rng.uniform(size=(3, 24, 32, 1)) > 0.6).astype(np.float32))
    tgt = torch.from_numpy(data["flat_cam_tgt"])
    cams = torch.from_numpy(data["flat_cam_src_spatial"])
    rays_o, rays_d, _uv, _ = cam.get_rays(24, 32, cam.flat_cam_intrinsics(tgt),
                                          cam.flat_cam_c2w(tgt))
    perm, _ = patch_ray_perm(24 * 32, 24, 32, 2, 2)
    pts = rays_o[perm, None] + rays_d[perm, None] * torch.linspace(1.5, 8.0, 9)[:, None]

    def run(dev):
        p = cam.flat_cam_projection(cams.to(dev))
        q = proj.build_quad_maps(rgbs.to(dev), feats.to(dev), masks.to(dev))
        i8 = proj.flatten_quad_maps(*proj.quantize_quad_maps(q))
        fused = proj.build_fused_maps(rgbs.to(dev), feats.to(dev), masks.to(dev))
        pm = proj.build_patch_maps(rgbs.to(dev), feats.to(dev))
        z = sampling.sample_z_vals(torch.full((50,), 1.5, device=dev),
                                   torch.full((50,), 8.0, device=dev), 9, True)
        w = torch.softmax(0.3 * torch.arange(9.0, device=dev).expand(50, 9), -1)
        return {"quad": q, "scales": i8.scales, "int8": i8.flat,
                "fused": proj.epipolar_sample_fused(pts.to(dev), p, fused, True)["rgb_feat"],
                "quad_i8": proj.epipolar_sample_fused(pts.to(dev), p, i8, True,
                                                      quad=True)["rgb_feat"],
                "patch": proj.epipolar_sample_patch(pts.to(dev), p, pm),
                "fine_z": sampling.sample_fine_z_vals(z, w, 16, True)}

    got, ref = run(card), run("cpu")
    assert torch.equal(got["int8"].cpu(), ref["int8"])
    for key, val in ref.items():
        g = got[key].cpu().float()
        ulp = (2.0 ** -7 if val.dtype == torch.bfloat16 else 2.0 ** -23) * val.float().abs()
        assert bool(((g - val.float()).abs() <= ulp + 1e-30).all()), key


def test_to_device_prefetch_pinned_items(card):
    """Reader-like items staged through to_device_prefetch (pinned host
    copies, non_blocking copies on a side stream): after synchronize every
    device tensor equals its host array bit for bit, in the loader's order,
    while the consumer's stream is kept busy between items."""
    from pgdvs_tpu_torch.data.loader import PrefetchLoader, to_device_prefetch

    rng = np.random.default_rng(6)
    items = [{"rgb": rng.uniform(size=(10, 288, 550, 3)).astype(np.float32),
              "seq_ids": np.arange(13, dtype=np.int64) + i,
              "depth_range": np.array([1.0 + i, 9.0], np.float32),
              "misc": {"tgt_frame_id": i}} for i in range(4)]
    got = []
    for item in to_device_prefetch(PrefetchLoader(items, n_workers=2), device="cuda"):
        assert item["rgb"].is_cuda and item["misc"] == {"tgt_frame_id": len(got)}
        busy = torch.randn(2048, 2048, device=card)
        for _ in range(8):
            busy = busy @ busy.T / 2048  # consumer work queued behind the copy
        got.append({k: v.clone() for k, v in item.items() if torch.is_tensor(v)})
    torch.cuda.synchronize()
    assert len(got) == len(items)
    for g, want in zip(got, items):
        for key in ("rgb", "seq_ids", "depth_range"):
            assert g[key].dtype == torch.from_numpy(want[key]).dtype
            assert torch.equal(g[key].cpu(), torch.from_numpy(want[key])), key


# ------------------------------------------------------------- evaluation

def _random_lpips(seed=0):
    """LPIPS with a random AlexNet from ``seed`` (torch's initialisers) and
    the bundled heads, on the CPU."""
    from pgdvs_tpu_torch.metrics import lpips as lp

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = lp.LPIPS()
    heads = torch.load(lp.BUNDLED_HEADS, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k in range(5):
            net.lins[k].copy_(heads[f"lin{k}.model.1.weight"].reshape(-1))
    return net.eval()


def test_lpips_on_card_matches_cpu(card):
    """The three regions' masked LPIPS and the spatial map on the card
    equal the CPU's at 1e-5 relative, with cuDNN's TF32 switched on
    globally: lpips_distance turns it off for its own convolutions."""
    from pgdvs_tpu_torch.metrics.lpips import lpips_distance

    rng = np.random.default_rng(8)
    h, w = 96, 136
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    dyn = np.zeros((h, w, 1), np.float32)
    dyn[20:60, 30:90] = 1.0
    net = _random_lpips()
    net_card = _random_lpips().to(card)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for m in (np.ones_like(dyn), dyn, 1.0 - dyn):
            args = [torch.from_numpy(x) for x in (a, b, m)]
            ref = lpips_distance(net, *args[:2], mask=args[2])
            got = lpips_distance(net_card, *(x.to(card) for x in args[:2]), mask=args[2].to(card))
            torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=0)
        ref = lpips_distance(net, torch.from_numpy(a), torch.from_numpy(b), spatial=True)
        got = lpips_distance(net_card, torch.from_numpy(a).to(card), torch.from_numpy(b).to(card),
                             spatial=True)
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=0)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_evaluator_item_on_card(card, tmp_path, monkeypatch):
    """One Evaluator item on the card (the fast preset, K1 patch_rows, LPIPS
    on the card): its metrics are those compute_nvidia_metrics gives on the
    CPU from the same render (PSNR / SSIM bit for bit, LPIPS at 1e-5
    relative), its pickle carries them, its PNG is the truncated render."""
    from pgdvs_tpu_torch.data.image_io import read_png
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.engines import evaluator as ev
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    data = make_contract_data(h=48, w=64, n_spatial=3, n_frames=6)
    cfg = apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=16, ray_tile=1024))
    renders = []
    real = ev.render_novel_view

    def keep(*a, **kw):
        out = real(*a, **kw)
        renders.append(out["combined_rgb"].float().cpu().numpy())
        return out

    monkeypatch.setattr(ev, "render_novel_view", keep)
    kp.gnt_fused_mono4_patch.launches = 0
    evaluator = ev.Evaluator(init_gnt_models(seed=0, device=card), cfg, out_dir=tmp_path,
                             lpips_net=_random_lpips().to(card), save_vis=True)
    rec = evaluator.eval_item(data, item_id="x", seed=3)
    assert kp.gnt_fused_mono4_patch.launches == 3
    (pred,) = renders
    net = _random_lpips()
    ref = ev.compute_nvidia_metrics(
        pred, data["rgb_tgt"], data["misc"]["tgt_dyn_mask"],
        lpips_fn=lambda x, y, m: ev.lpips_on_host_arrays(net, x, y, m))
    for k, v in ref.items():
        if k.startswith("lpips"):
            np.testing.assert_allclose(rec.metrics[k], v, rtol=1e-5)
        else:
            assert rec.metrics[k] == v, k
    import pickle

    assert pickle.loads((tmp_path / "x.pkl").read_bytes()) == rec.metrics
    png = read_png(tmp_path / "x_combined.png")
    assert np.array_equal(png, (np.clip(pred, 0, 1) * 255).astype(np.uint8))


# ------------------------------------------------------- point-cloud renderers

def _synthetic_cloud(h, w, seed=0):
    """The synthetic contract's static cloud and dynamic source frame."""
    from pgdvs_tpu_torch.data.synthetic import make_contract_data

    return make_contract_data(h=h, w=w, n_spatial=2, n_frames=6, seed=seed)


@pytest.mark.parametrize("radius,ndc", [(0.03, True), (1.5, False)])
def test_point_raster_on_card_matches_cpu(card, radius, ndc):
    """The point raster at 96x128 on the card against the CPU: alpha equal
    but for a point on a footprint's edge to the ulp (at most 1e-4 of the
    pixels), the image within 1e-4 where alpha agrees (index_add_'s
    atomics, the projection's summation order)."""
    from pgdvs_tpu_torch.kernels.point_raster import rasterize_points

    data = _synthetic_cloud(96, 128)
    pcl = torch.from_numpy(data["st_pcl_rgb"])
    valid = torch.from_numpy(np.random.default_rng(2).random(pcl.shape[0]) > 0.1)
    cam_t = torch.from_numpy(data["flat_cam_tgt"])
    args = dict(radius=radius, ndc_radius=ndc)
    ref = rasterize_points(pcl[:, :3], pcl[:, 3:], cam_t, (96, 128), valid=valid, **args)
    got = rasterize_points(pcl[:, :3].to(card), pcl[:, 3:].to(card), cam_t.to(card), (96, 128),
                           valid=valid.to(card), **args)
    alpha, ref_alpha = got[1].cpu(), ref[1]
    assert 0.3 < float(ref_alpha.mean()) and int((alpha != ref_alpha).sum()) <= 1e-4 * alpha.numel()
    agree = alpha == ref_alpha
    assert float(((got[0].cpu() - ref[0]).abs() * agree).max()) <= 1e-4


@pytest.mark.parametrize("kind", ["pcl", "mesh"])
def test_dynamic_raster_on_card_matches_cpu(card, kind):
    """The dynamic layer of the point / mesh bundles at 96x128 (outlier
    removal on) on the card against the CPU, held as the point raster
    above."""
    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
    from pgdvs_tpu_torch.renderers.dynamic import render_dynamic

    bundle = {"pcl": "st_gnt_masked_attn_dy_cvd_pcl_clean_render_point",
              "mesh": "st_gnt_masked_attn_dy_cvd_pcl_clean_render_mesh"}[kind]
    cfg = resolve_benchmark(bundle)[0]
    data = {k: torch.from_numpy(v) for k, v in _synthetic_cloud(96, 128).items()
            if isinstance(v, np.ndarray)}
    ref = render_dynamic(data, cfg)
    got = render_dynamic({k: v.to(card) for k, v in data.items()}, cfg)
    mask, ref_mask = got["mask"].cpu(), ref["mask"]
    assert float(ref_mask.sum()) > 0 and int((mask != ref_mask).sum()) <= 1e-4 * mask.numel()
    agree = mask == ref_mask
    assert float(((got["rgb"].cpu() - ref["rgb"]).abs() * agree).max()) <= 1e-4


def test_device_spans_on_card(card):
    """The span registry's CUDA events: device ms for spans on the current
    stream and on the loader's copy stream, no synchronisation inside a
    span, completed pairs folded so the pending list stays bounded."""
    import numpy as np

    from pgdvs_tpu_torch.data.loader import to_device_prefetch
    from pgdvs_tpu_torch.utils import tracing

    tracing.enable()
    tracing.reset()
    try:
        x = torch.randn(2048, 2048, device=card)
        with tracing.span("outer", device=card, root_id=0):
            for _ in range(4):
                with tracing.span("mm", device=card):
                    x = torch.tanh(x @ x * 1e-3)
        items = [{"a": np.ones((512, 1024), np.float32), "b": "text"} for _ in range(3)]
        got = [it["a"].sum().item() for it in to_device_prefetch(items, card)]
        assert got == [512 * 1024.0] * 3
        for _ in range(tracing.FOLD_AT + 10):
            with tracing.span("tiny", device=card):
                pass
        torch.cuda.synchronize()
        with tracing.span("tiny", device=card):
            pass
        assert len(tracing._pending) < tracing.FOLD_AT
        s = tracing.summary()["spans"]
        assert 0.0 < s["mm"]["device_ms"] <= s["outer"]["device_ms"]
        assert s["mm"]["count"] == 4 and s["mm"]["parent"] == "outer"
        assert s["loader.stage"]["count"] == s["loader.pin"]["count"] == 3
        assert s["loader.hand"]["count"] == 3
        assert s["loader.stage"]["device_ms"] > 0.0
        assert tracing.summary()["roots"]["outer"]["records"][0][2] == s["outer"]["device_ms"]
    finally:
        tracing.disable()
        tracing.reset()
