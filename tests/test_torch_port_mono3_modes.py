"""K2 in every operand mode: the port's ``gnt_fused_apply_mono3`` (its plain
version, on the CPU) against the JAX package's ``gnt_fused_apply_mono3``
(Pallas, interpret mode) with the same keyword arguments, the raw quad
sampler against JAX's ``epipolar_sample_quad_raw``, and the combinations
both refuse. The hand kernel against its plain version on a card is in
test_torch_port_cuda.py.

Tolerances are K1's (rgb atol/rtol 0.02, weights 0.01, count 0.01): the
Pallas kernel runs in bf16 with f32 statistics (and lerps fold_lerp's taps
in bf16), the port's plain version in float32 on the same bf16 operands.
The sampler's rows are gathered, so they are held bit-equal; its offsets
to 1e-6 of the pixel coordinate they come from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.core import cameras as jcam
from pgdvs_tpu.kernels.gnt_fused_mono3 import gnt_fused_apply_mono3 as j_apply
from pgdvs_tpu.models.gnt import projector as jproj
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu.models.gnt.network import sinusoidal_embed as j_embed
from pgdvs_tpu_torch.core import cameras as tcam
from pgdvs_tpu_torch.kernels import gnt_fused_mono3 as k2
from pgdvs_tpu_torch.models.gnt import projector as tproj
from pgdvs_tpu_torch.models.gnt.network import GNT
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict

H, W = 20, 28
R, V, F = 8, 3, 32
C = 3 + F

# operand modes: which folds each case turns on (mode_name's vocabulary)
MODES = {
    "unfolded": {},
    "pre_packed": {"pre_packed": True},
    "separate_mask": {"separate_mask": True},
    "fold_ray_diff": {"fold_ray_diff": True},
    "fold_ray_diff+fold_pos_code": {"fold_ray_diff": True, "fold_pos_code": True},
    "fold_mask+fold_ray_diff": {"fold_mask": True, "fold_ray_diff": True},
    "fold_lerp+separate_mask+fold_ray_diff+fold_pos_code": {
        "fold_lerp": True, "separate_mask": True, "fold_ray_diff": True,
        "fold_pos_code": True},
    "fold_lerp+fold_mask+fold_ray_diff+fold_pos_code": {
        "fold_lerp": True, "fold_mask": True, "fold_ray_diff": True, "fold_pos_code": True},
}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    gnt_j = JGNT(netwidth=64, depth=8, in_feat_ch=F, dtype="bfloat16",
                 ret_view_std=False)
    s = 4
    params = gnt_j.init(
        jax.random.PRNGKey(0),
        rng.normal(size=(R, s, V, C)).astype(np.float32),
        rng.normal(size=(R, s, V, 4)).astype(np.float32),
        np.ones((R, s, V, 1), np.float32),
        rng.normal(size=(R, s, 3)).astype(np.float32),
        rng.normal(size=(R, 3)).astype(np.float32),
    )
    gnt = GNT().eval()
    gnt.load_state_dict(gnt_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 25.0
    k[0, 2], k[1, 2] = W / 2, H / 2
    cams = []
    for i in range(V):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * i - 0.3, 0.1 * i, -0.2 * i]
        cams.append(np.asarray(jcam.make_flat_cam(H, W, k, c2w), np.float32))
    cams = jnp.asarray(np.stack(cams))
    centers = jnp.concatenate([
        jcam.flat_cam_c2w(cams[0])[None, :3, 3],
        jax.vmap(jcam.flat_cam_c2w)(cams)[:, :3, 3],
    ], axis=0)
    ray_d = rng.normal(size=(R, 3)).astype(np.float32)
    vc = j_embed(ray_d / np.linalg.norm(ray_d, axis=-1, keepdims=True))
    return {"params": params, "gnt": gnt, "cams": cams,
            "proj": np.asarray(jax.vmap(jcam.flat_cam_projection)(cams)),
            "centers": np.asarray(centers), "vc": np.asarray(vc)}


def _bf16(a):
    """``a`` rounded to bf16, as float32 (the same bits on both sides)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _data(setup, s, seed, behind=False):
    """The rig's operands at S samples: bf16 features, points, their ray-diff
    and point codes, raw quad rows and offsets, and a mask [V, R, S] = in
    bounds & in front & not dynamic, ray 0 dynamic in every view (its tokens
    fall back to un-masked attention) and 30 % random dynamic taps."""
    rng = np.random.default_rng(seed)
    if behind:
        pts = np.full((R, s, 3), -50.0, np.float32)
    else:
        pts = (rng.normal(0, 1.2, (R, s, 3)) + [0, 0, 2.5]).astype(np.float32)
    uv, _z, front = jax.vmap(lambda c: jcam.project_points(jnp.asarray(pts), c))(
        setup["cams"])
    inbound = np.asarray(jcam.pixel_inbound(uv, float(H), float(W)) & front)
    dyn = rng.uniform(size=(V, R, s)) < 0.3
    dyn[:, 0] = True
    ctr = setup["centers"]
    rd = np.stack([np.asarray(jcam.ray_diff_features(
        jnp.asarray(pts), jnp.asarray(np.eye(4)).at[:3, 3].set(ctr[0]),
        jnp.asarray(np.eye(4)).at[:3, 3].set(ctr[i + 1]))) for i in range(V)])
    return {
        "rgb_feat": _bf16(rng.normal(size=(V, R, s, C))),
        "rows": _bf16(rng.normal(size=(V, R, s, 4 * C))),
        "frac": rng.uniform(-0.6, 1.6, (V, R, s, 2)).astype(np.float32),
        "pts": pts,
        "mask": (inbound & ~dyn).astype(np.float32),
        "inbound": inbound,
        "ray_diff": rd.astype(np.float32),
        "pts_code": np.asarray(j_embed(jnp.asarray(pts))),
    }


def _call(setup, d, flags):
    """(positional, keyword) arguments of gnt_fused_apply_mono3 for the mode
    ``flags``, as numpy arrays (features and rows to go in bf16)."""
    fold_mask = flags.get("fold_mask", False)
    feats = d["rows"] if flags.get("fold_lerp") else d["rgb_feat"]
    if flags.get("pre_packed"):
        feats = np.concatenate([feats, d["mask"][..., None]], axis=-1)
    mask = None if fold_mask or flags.get("pre_packed") else d["mask"][..., None]
    fold_rd = flags.get("fold_ray_diff", False)
    args = (feats, None if fold_rd else d["ray_diff"], mask,
            None if flags.get("fold_pos_code") else d["pts_code"], setup["vc"])
    kw = dict(views_outer=True, separate_mask=flags.get("separate_mask", False),
              fold_pos_code=flags.get("fold_pos_code", False),
              fold_lerp=flags.get("fold_lerp", False))
    if fold_rd:
        kw.update(pts=d["pts"], cam_centers=setup["centers"])
    if flags.get("fold_lerp"):
        kw["frac"] = d["frac"]
    if fold_mask:
        kw.update(fold_mask_hw=(float(H), float(W)), proj_mats=setup["proj"])
    return args, kw


def _to_jax(args, kw):
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    return jargs, {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()}


def _to_torch(args, kw):
    def tt(a):
        return None if a is None else torch.from_numpy(np.array(a, np.float32))

    targs = [tt(a) for a in args]
    targs[0] = targs[0].to(torch.bfloat16)
    return targs, {k: tt(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _jax(setup, args, kw):
    jargs, jkw = _to_jax(args, kw)
    ref = j_apply(setup["params"], *jargs, ray_block=8, interpret=True, **jkw)
    return {k: np.asarray(v) for k, v in ref.items()}


def _both(setup, args, kw):
    targs, tkw = _to_torch(args, kw)
    return k2.gnt_fused_apply_mono3_plain(setup["gnt"], *targs, **tkw), _jax(setup, args, kw)


def _check(got, ref, spread=True):
    np.testing.assert_allclose(got["rgb"].numpy(), ref["rgb"], atol=0.02, rtol=0.02)
    np.testing.assert_allclose(got["weights"].numpy(), ref["weights"], atol=0.01)
    np.testing.assert_allclose(got["inbound_cnt_raw"].numpy(),
                               ref["inbound_cnt_raw"], atol=0.01)
    if spread:  # the weights bound rejects uniform or reordered weights
        w, s = ref["weights"], ref["weights"].shape[-1]
        eo = np.concatenate([np.arange(0, s, 2), np.arange(1, s, 2)])
        for wrong in (np.full_like(w, 1.0 / s), w[:, ::-1], w[:, eo]):
            assert np.abs(wrong - w).max() > 0.01


@pytest.mark.parametrize("mode,s", [
    ("unfolded", 23), ("pre_packed", 16), ("separate_mask", 16),
    ("fold_ray_diff", 23), ("fold_ray_diff+fold_pos_code", 16),
    ("fold_mask+fold_ray_diff", 16),
    ("fold_lerp+separate_mask+fold_ray_diff+fold_pos_code", 23),
    ("fold_lerp+fold_mask+fold_ray_diff+fold_pos_code", 16),
])
def test_plain_matches_jax_mono3_mode(setup, mode, s):
    """A mix of valid, out-of-bounds and dynamic views (with fold_mask: of
    valid and out-of-bounds ones), ray 0 all dynamic where a mask is read."""
    d = _data(setup, s, seed=60 + s)
    flags = MODES[mode]
    valid = d["inbound"] if flags.get("fold_mask") else d["mask"]
    assert 0.1 < valid.mean() < 0.9
    if not flags.get("fold_mask"):
        assert (valid.sum(0)[0] == 0).all() and not (valid.sum(0) == 0).all()
    args, kw = _call(setup, d, flags)
    targs, tkw = _to_torch(args, kw)
    assert k2.mono3_operands(*targs, **tkw).mode == mode
    got, ref = _both(setup, args, kw)
    assert tuple(got["weights"].shape) == (R, s)
    _check(got, ref)


@pytest.mark.parametrize("mode", ["unfolded", "fold_mask+fold_ray_diff"])
def test_plain_matches_jax_mono3_all_invalid(setup, mode):
    """Points behind every camera: no view valid anywhere, the un-masked
    fallback everywhere, a zero count."""
    d = _data(setup, 16, seed=7, behind=True)
    assert d["mask"].sum() == 0 and d["inbound"].sum() == 0
    got, ref = _both(setup, *_call(setup, d, MODES[mode]))
    for key in ("rgb", "weights", "inbound_cnt_raw"):
        assert torch.isfinite(got[key]).all()
    assert float(got["inbound_cnt_raw"].abs().max()) == 0.0
    _check(got, ref, spread=False)  # samples all at one place: near uniform


def test_raw_quad_sampler_matches_jax():
    """Rows bit-equal to JAX's quad-map rows, offsets within 1e-6, masks
    equal, on one fused map (JAX's, in bf16) with taps near and past every
    border."""
    rng = np.random.default_rng(4)
    v, h, w, f = 3, 24, 32, 8
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
    pts = (rng.normal(0, 1.5, (20, 9, 3)) + [0, 0, 2.0]).astype(np.float32)
    ref = jproj.epipolar_sample_quad_raw(
        pts, tgt, src, jproj.build_quad_maps(rgbs, feats, None, dtype=jnp.bfloat16))
    fused = np.array(jproj.build_fused_maps(rgbs, feats, None, dtype=jnp.bfloat16)
                     .astype(jnp.float32))
    got = tproj.epipolar_sample_quad_raw(
        torch.from_numpy(pts), tcam.flat_cam_projection(torch.from_numpy(src)),
        torch.from_numpy(fused).to(torch.bfloat16))
    assert got["rows"].dtype == torch.bfloat16
    assert tuple(got["rows"].shape) == (v, 20, 9, 4 * (3 + f))
    np.testing.assert_array_equal(got["rows"].float().numpy(),
                                  np.asarray(ref["rows"].astype(jnp.float32)))
    # the two projections sum in another order: offsets agree to 1e-6 of the
    # pixel coordinate they come from (x = frac + sx, sx <= W-2)
    got_f, ref_f = got["frac"].numpy(), np.asarray(ref["frac"])
    scale = np.maximum(1.0, np.abs(ref_f) + max(h, w))
    assert (np.abs(got_f - ref_f) <= 1e-6 * scale).all()
    inb = np.asarray(ref["mask_inbound"][..., 0]) != 0
    assert 0.2 < inb.mean() < 0.95  # taps in and out of the image
    np.testing.assert_array_equal(got["mask_inbound"].numpy(), inb)
    np.testing.assert_array_equal(got["mask"].numpy(), inb)
    assert not got["mask_invalid"].any()


# keyword changes from a valid fold_lerp + fold_mask call that each make a
# combination the JAX package refuses
REFUSED = {
    "fold_mask_with_mask": dict(mask=True),
    "fold_mask_with_separate_mask": dict(separate_mask=True),
    "fold_mask_with_ray_diff": dict(ray_diff=True),
    "fold_mask_without_proj": dict(proj_mats=None),
    "fold_lerp_without_mask_source": dict(fold_mask_hw=None, proj_mats=None, mask=True),
    "fold_lerp_views_inner": dict(views_outer=False),
    "fold_lerp_without_frac": dict(frac=None),
    "separate_mask_without_mask": dict(fold_mask_hw=None, proj_mats=None,
                                       separate_mask=True),
    "fold_pos_code_with_ray_diff": dict(fold_mask_hw=None, proj_mats=None, mask=True,
                                        separate_mask=True, ray_diff=True),
    "ray_diff_fold_without_pts": dict(pts=None),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_what_jax_refuses(setup, case):
    d = _data(setup, 16, seed=3)
    args, kw = _call(setup, d, MODES["fold_lerp+fold_mask+fold_ray_diff+fold_pos_code"])
    args = list(args)
    change = dict(REFUSED[case])
    if change.pop("mask", False):
        args[2] = d["mask"][..., None]
    if change.pop("ray_diff", False):
        args[1] = d["ray_diff"]
    kw.update(change)
    with pytest.raises((ValueError, AssertionError)):  # JAX asserts on the last
        _jax(setup, args, kw)
    targs, tkw = _to_torch(args, kw)
    with pytest.raises(ValueError):
        k2.gnt_fused_apply_mono3(setup["gnt"], *targs, **tkw)


def test_wrapper_cpu_runs_plain_without_counting(setup):
    d = _data(setup, 16, seed=5)
    targs, kw = _to_torch(*_call(setup, d, MODES["unfolded"]))
    before = dict(k2.gnt_fused_apply_mono3.launches)
    got = k2.gnt_fused_apply_mono3(setup["gnt"], *targs, **kw)
    ref = k2.gnt_fused_apply_mono3_plain(setup["gnt"], *targs, **kw)
    assert dict(k2.gnt_fused_apply_mono3.launches) == before
    for key in ref:
        assert torch.equal(got[key], ref[key])
    # views inner ([R, S, V, *]) is the same function, and the mask's dtype
    # and trailing axis do not matter: nonzero is valid
    inner = lambda a: a.permute(1, 2, 0, 3)  # noqa: E731
    alt = k2.gnt_fused_apply_mono3(setup["gnt"], inner(targs[0]), inner(targs[1]),
                                   inner(targs[2]).to(torch.uint8), *targs[3:],
                                   views_outer=False)
    for key in ref:
        assert torch.equal(alt[key], ref[key])
    meta = [None if a is None else a.to("meta") for a in targs]
    with pytest.raises(ValueError):
        k2.gnt_fused_apply_mono3(setup["gnt"], *meta)
