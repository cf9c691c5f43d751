"""The JAX package's other samplers in the port: the fused and quad maps, the
int8 quantization of the quad maps, ``quad_bilinear``, both forms of
``epipolar_sample_fused`` (``fused`` and ``quad_i8``) and the XLA-combine
2x2 ``epipolar_sample_patch``, each against the JAX function on the same
numpy inputs; then renders on ``fused`` and ``quad_i8`` against the JAX
package's, and the kernel each of them runs.

Bounds: the maps and the int8 values bit for bit, the scales at 1e-7
relative; the samples within one bf16 ulp (the port repeats JAX's bf16
arithmetic step by step); the masks exactly; renders at the JAX package's
bounds for its fast paths (tests/test_gnt_model.py): rgb 0.04, depth 0.1,
inbound and dynamic counts 0.02. The JAX side runs its Pallas kernels in
interpret mode, the port's CPU path the plain float32 network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.models.gnt import projector as jproj
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.config import apply_perf_preset as j_apply_perf_preset
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.core import cameras as tcam
from pgdvs_tpu_torch.models.gnt import projector as tproj
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers import static_gnt
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset, check_slice
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02, "dyn_cnt": 0.02}
V, H, W, F = 3, 12, 20, 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def rig():
    """Source rgbs / features / dyn masks from a seed, column 0 and row 0
    holding each channel's largest magnitude (so the shifted quad channels,
    which lose them to the edge clamp, get other int8 scales), cameras of
    the synthetic scene and sample points around its depth range, some
    projecting out of bounds."""
    rng = np.random.default_rng(7)
    data = make_contract_data(h=H, w=W, n_spatial=V, n_frames=4)
    rgbs = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    feats = rng.uniform(-1, 1, (V, H // 4, W // 4, F)).astype(np.float32)
    rgbs[:, 0, 0] = 1.0
    feats[:, 0, 0] = 3.0 * np.sign(rng.normal(size=F))
    masks = (rng.uniform(size=(V, H, W, 1)) > 0.6).astype(np.float32)
    pts = np.stack([rng.uniform(-2.5, 2.5, (40, 9)), rng.uniform(-2, 2, (40, 9)),
                    rng.uniform(1.5, 8, (40, 9))], -1).astype(np.float32)
    return {"rgbs": rgbs, "feats": feats, "masks": masks, "pts": pts,
            "tgt": data["flat_cam_tgt"], "cams": data["flat_cam_src_spatial"]}


@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_and_quad_maps_bit_equal(rig, with_mask):
    masks = rig["masks"] if with_mask else None
    args_j = (rig["rgbs"], rig["feats"], masks)
    args_t = (_t(rig["rgbs"]), _t(rig["feats"]), None if masks is None else _t(masks))
    for build in ("build_fused_maps", "build_quad_maps"):
        ref = _f32(getattr(jproj, build)(*args_j, dtype=jnp.bfloat16))
        got = getattr(tproj, build)(*args_t)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), ref, err_msg=build)


def test_quantize_quad_maps(rig):
    qmaps = jproj.build_quad_maps(rig["rgbs"], rig["feats"], rig["masks"], dtype=jnp.bfloat16)
    q_ref, s_ref = jproj.quantize_quad_maps(qmaps)
    q, s = tproj.quantize_quad_maps(
        tproj.build_quad_maps(_t(rig["rgbs"]), _t(rig["feats"]), _t(rig["masks"])))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-7, atol=0)
    c = q.shape[-1] // 4
    # four scales per fused channel: the shifted copies' maxima differ here
    assert (s[c:2 * c] != s[:c]).any() and (s[2 * c:3 * c] != s[:c]).any()


def _within_one_ulp(got, ref):
    """got (bf16 tensor) within one bf16 ulp of ref (bf16 values as f32)."""
    got = got.float().numpy()
    ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2.0 ** 16  # f32 ulp -> bf16 ulp
    err = np.abs(got - ref)
    assert (err <= ulp).all(), f"{int((err > ulp).sum())} samples off by more than one ulp"


@pytest.mark.parametrize("int8", [False, True])
def test_quad_bilinear(rig, int8):
    qmaps = jproj.build_quad_maps(rig["rgbs"], rig["feats"], rig["masks"], dtype=jnp.bfloat16)
    tq = tproj.build_quad_maps(_t(rig["rgbs"]), _t(rig["feats"]), _t(rig["masks"]))
    if int8:
        flat_j = jproj.flatten_quad_maps(*jproj.quantize_quad_maps(qmaps))
        flat_t = tproj.flatten_quad_maps(*tproj.quantize_quad_maps(tq))
    else:
        flat_j, flat_t = jproj.flatten_quad_maps(qmaps), tproj.flatten_quad_maps(tq)
    uv, _z, _f = jproj.project_all_views(rig["pts"], rig["cams"])
    ref = _f32(jproj.quad_bilinear(flat_j, uv[..., 0], uv[..., 1]))
    tuv = _t(np.asarray(uv))
    got = tproj.quad_bilinear(flat_t, tuv[..., 0], tuv[..., 1])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _within_one_ulp(got, ref)
    assert np.count_nonzero(ref) > 0.5 * ref.size  # most taps land in-image


@pytest.mark.parametrize("mode", ["fused", "quad_i8"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_epipolar_sample_fused(rig, mode, with_mask):
    """Both forms, with the dyn mask channel and without: features within
    one bf16 ulp, the three masks exactly."""
    masks = rig["masks"] if with_mask else None
    if mode == "fused":
        maps_j = jproj.build_fused_maps(rig["rgbs"], rig["feats"], masks, dtype=jnp.bfloat16)
        maps_t = tproj.build_fused_maps(_t(rig["rgbs"]), _t(rig["feats"]),
                                        None if masks is None else _t(masks))
    else:
        maps_j = jproj.flatten_quad_maps(*jproj.quantize_quad_maps(
            jproj.build_quad_maps(rig["rgbs"], rig["feats"], masks, dtype=jnp.bfloat16)))
        maps_t = tproj.flatten_quad_maps(*tproj.quantize_quad_maps(tproj.build_quad_maps(
            _t(rig["rgbs"]), _t(rig["feats"]), None if masks is None else _t(masks))))
    ref = jproj.epipolar_sample_fused(rig["pts"], rig["tgt"], rig["cams"], maps_j,
                                      with_mask=with_mask, quad=mode == "quad_i8",
                                      views_outer=True, with_ray_diff=False)
    got = tproj.epipolar_sample_fused(_t(rig["pts"]),
                                      tcam.flat_cam_projection(_t(rig["cams"])), maps_t,
                                      with_mask, quad=mode == "quad_i8")
    _within_one_ulp(got["rgb_feat"], _f32(ref["rgb_feat"]))
    for key in ("mask", "mask_inbound", "mask_invalid"):
        np.testing.assert_array_equal(got[key].numpy(), _f32(ref[key])[..., 0] > 0, err_msg=key)
    if with_mask:
        frac = got["mask_invalid"].float().mean()
        assert 0.0 < frac < 1.0  # some taps dynamic, not all


def test_epipolar_sample_patch_2x2(rig):
    """JAX's XLA-combine patch sampler on 2x2 ray blocks (the target's rays,
    grouped by ``patch_ray_perm``, 9 samples in the scene's depth range);
    it refuses 4x2 blocks."""
    pm_j = jproj.build_patch_maps(rig["rgbs"], rig["feats"], dtype=jnp.bfloat16)
    pm_t = tproj.build_patch_maps(_t(rig["rgbs"]), _t(rig["feats"]))
    np.testing.assert_array_equal(pm_t.flat.float().numpy(), _f32(pm_j.flat))
    tgt = _t(rig["tgt"])
    rays_o, rays_d, _uv, _hw = tcam.get_rays(H, W, tcam.flat_cam_intrinsics(tgt),
                                             tcam.flat_cam_c2w(tgt))
    perm, _ = static_gnt.patch_ray_perm(H * W, H, W, 2, 2)
    z = torch.linspace(1.5, 8.0, 9)
    pts = (rays_o[perm, None] + rays_d[perm, None] * z[:, None]).numpy()
    ref = _f32(jproj.epipolar_sample_patch(pts, rig["tgt"], rig["cams"], pm_j)["rgb_feat"])
    got = tproj.epipolar_sample_patch(_t(pts), tcam.flat_cam_projection(_t(rig["cams"])), pm_t)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _within_one_ulp(got, ref)
    assert np.count_nonzero(ref) > 0.3 * ref.size
    pm_42 = tproj.build_patch_maps(_t(rig["rgbs"]), _t(rig["feats"]), foot=(6, 4), block=(4, 2))
    with pytest.raises(ValueError, match="2x2"):
        tproj.epipolar_sample_patch(_t(pts), tcam.flat_cam_projection(_t(rig["cams"])), pm_42)


def test_check_slice_takes_the_samplers():
    for mode in ("fused", "quad_i8"):
        check_slice(RenderConfig(epipolar_mode=mode))
    with pytest.raises(ValueError, match="epipolar_mode"):
        check_slice(RenderConfig(epipolar_mode="quad_u4"))


# ---------------------------------------------------------------- renders

RH, RW, S = 24, 32, 8
SMALL = dict(n_coarse_samples_per_ray=S, ray_tile=RH * RW)


def _jax_configs(mode, dyn, forced):
    """The JAX package's config as ``run.py`` builds it (the perf preset,
    then the override) or unforced (``RenderConfig(epipolar_mode=...)``).
    JAX refuses its bare preset with ``fused`` and no dyn mask: it falls back
    from mono4 to mono3 and its guard wants ``pallas_precompute_kv`` (a
    mono4-only knob) on, so that knob is set back to its default."""
    base = JRenderConfig(gnt_use_dyn_mask=dyn, knn_tile=256, **SMALL)
    if not forced:
        return base.replace(epipolar_mode=mode)
    cfg = j_apply_perf_preset(base).replace(epipolar_mode=mode)
    if mode == "fused" and not dyn:
        cfg = cfg.replace(pallas_precompute_kv=True)
    return cfg


def _spy(mp, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    mp.setattr(module, name, spy)


_PORT = {}


@pytest.fixture(scope="module", params=[
    ("fused", False, True), ("fused", False, False),
    ("quad_i8", False, True), ("quad_i8", False, False), ("quad_i8", True, True)],
    ids=["fused-preset", "fused-unforced", "quad_i8-preset", "quad_i8-unforced",
         "quad_i8-dyn-preset"])
def rendered(request):
    mode, dyn, forced = request.param
    data = make_contract_data(h=RH, w=RW, n_spatial=V, n_frames=6)
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    jdata = {k: v for k, v in data.items() if k != "misc"}
    import pgdvs_tpu.kernels.gnt_fused_mono3 as m3
    import pgdvs_tpu.kernels.gnt_fused_mono4 as m4

    calls = {"mono3": [], "mono4": []}
    cfg_j = _jax_configs(mode, dyn, forced)
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, m3, "gnt_fused_apply_mono3", calls["mono3"])
        _spy(mp, m4, "gnt_fused_apply_mono4", calls["mono4"])
        ref = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda p: j_render_novel_view(models, p, jdata, cfg_j, key, static_mode="gnt")
        )(params))
    if (mode, dyn) not in _PORT:
        fnet, gnt = init_gnt_models(device="cpu")
        np_params = jax.tree_util.tree_map(np.asarray, params)
        fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
        gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
        noise = np.array(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
        tdata = {k: _t(v) for k, v in data.items() if isinstance(v, np.ndarray)}
        cfg = apply_perf_preset(RenderConfig(gnt_use_dyn_mask=dyn, **SMALL)).replace(
            epipolar_mode=mode)
        _PORT[(mode, dyn)] = render_novel_view((fnet, gnt), tdata, cfg, noise=_t(noise))
    return {"ref": ref, "got": _PORT[(mode, dyn)], "calls": calls, "mode": mode,
            "dyn": dyn, "forced": forced}


def test_jax_side_took_the_expected_kernel(rendered):
    """Preset: quad_i8 without the dyn mask runs mono4 (full fold set on
    quad maps), fused and every dyn-mask config mono3 with a separate mask
    and folded codes; unforced: mono3 with a separate mask and the ray-diff
    and point codes read (the operands of K2's unfolded mode)."""
    calls = rendered["calls"]
    if rendered["forced"] and rendered["mode"] == "quad_i8" and not rendered["dyn"]:
        assert calls["mono4"] and not calls["mono3"]
        assert all(kw.get("patch_rows") is None for kw in calls["mono4"])
        return
    assert calls["mono3"] and not calls["mono4"]
    for kw in calls["mono3"]:
        assert kw.get("separate_mask") and kw.get("fold_mask_hw") is None
        assert bool(kw.get("fold_pos_code")) == (kw.get("pts") is not None) == rendered["forced"]


@pytest.mark.parametrize("key", ["combined_rgb", "static_coarse_rgb", "static_coarse_depth",
                                 "static_coarse_inbound_cnt", "static_coarse_dyn_cnt"])
def test_render_matches_jax(rendered, key):
    got, ref = rendered["got"][key].numpy(), rendered["ref"][key]
    assert got.shape == ref.shape and np.isfinite(got).all()
    tol = next(t for name, t in TOL.items() if key.endswith(name))
    np.testing.assert_allclose(got, ref, atol=tol)
    if key == "static_coarse_dyn_cnt":
        assert (float(np.mean(got > 0)) > 0.0) == rendered["dyn"]


def test_jax_refuses_its_bare_preset_on_fused():
    """Why the fused preset comparison sets ``pallas_precompute_kv``."""
    cfg = j_apply_perf_preset(JRenderConfig(**SMALL)).replace(epipolar_mode="fused")
    data = make_contract_data(h=RH, w=RW, n_spatial=V, n_frames=4)
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    jdata = {k: v for k, v in data.items() if k != "misc"}
    with pytest.raises(ValueError, match="precompute_kv"):
        jax.eval_shape(lambda p: j_render_novel_view(models, p, jdata, cfg,
                                                     jax.random.PRNGKey(1)), params)


@pytest.mark.parametrize("mode,dyn,kernel", [
    ("fused", False, "gnt_fused_mono3"), ("fused", True, "gnt_fused_mono3"),
    ("quad_i8", False, "gnt_fused_mono4"), ("quad_i8", True, "gnt_fused_mono3")])
def test_route_names_the_kernel(monkeypatch, mode, dyn, kernel):
    """Each mode's tiles go to one kernel: fused to K2 with the sampler's
    mask, quad_i8 to K1 on the dequantized samples without the dyn mask and
    to K2 with it; nothing else launches."""
    calls = []
    names = ("gnt_fused_mono4", "gnt_fused_mono4_patch", "gnt_fused_mono3",
             "gnt_fused_apply_mono3")
    for name in names:
        real = getattr(static_gnt, name)
        monkeypatch.setattr(static_gnt, name,
                            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw))
    data = make_contract_data(h=RH, w=RW, n_spatial=2, n_frames=4)
    tdata = {k: _t(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    cfg = apply_perf_preset(RenderConfig(gnt_use_dyn_mask=dyn, n_coarse_samples_per_ray=4,
                                         ray_tile=256)).replace(epipolar_mode=mode)
    out = render_novel_view(init_gnt_models(device="cpu"), tdata, cfg, noise=torch.zeros(RH, RW, 3))
    assert calls == [kernel] * 3  # 768 rays in tiles of 256
    assert torch.isfinite(out["combined_rgb"]).all()


@pytest.mark.parametrize("with_mask", [False, True])
def test_quad_sampler_bit_equal(rig, with_mask):
    """The quad samplers the renderer calls (``epipolar_sample_quad`` and
    ``epipolar_sample_quad_masked``, four taps of the bf16 fused map) against
    JAX's ``epipolar_sample_fused(quad=True)`` on its quad maps: features
    and masks bit for bit."""
    masks = rig["masks"] if with_mask else None
    qmaps = jproj.flatten_quad_maps(
        jproj.build_quad_maps(rig["rgbs"], rig["feats"], masks, dtype=jnp.bfloat16))
    ref = jproj.epipolar_sample_fused(rig["pts"], rig["tgt"], rig["cams"], qmaps,
                                      with_mask=with_mask, quad=True, views_outer=True,
                                      with_ray_diff=False)
    fused = tproj.build_fused_maps(_t(rig["rgbs"]), _t(rig["feats"]),
                                   None if masks is None else _t(masks))
    proj = tcam.flat_cam_projection(_t(rig["cams"]))
    if with_mask:
        got = tproj.epipolar_sample_quad_masked(_t(rig["pts"]), proj, fused)
        for key in ("mask", "mask_inbound", "mask_invalid"):
            np.testing.assert_array_equal(got[key].numpy(), _f32(ref[key])[..., 0] > 0,
                                          err_msg=key)
        assert 0.0 < got["mask_invalid"].float().mean() < 1.0
        feat = got["rgb_feat"]
    else:
        feat = tproj.epipolar_sample_quad(_t(rig["pts"]), proj, fused)
    assert feat.dtype == torch.bfloat16
    ref_feat = _f32(ref["rgb_feat"])
    np.testing.assert_array_equal(feat.float().numpy(), ref_feat)
    assert np.count_nonzero(ref_feat) > 0.5 * ref_feat.size
