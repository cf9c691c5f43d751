"""The patch sampler and K1's ``patch_rows`` mode: the port against the JAX
package, at both ray-block geometries (2x2 rays on 4x4-pixel rows, 4x2 on
6x4).

Sampler (``build_patch_maps``, ``epipolar_sample_patch_raw``,
``patch_clamp_fraction``, ``patch_ray_perm``): the maps are fed features at
full resolution, so both sides' fused maps are the same bf16 values (the
align-corners upsample is then the identity) and rows can be held
bit-equal. Both sides project in float32 in another order, so a tap's
``floor`` can flip where its x or y lies within float32 rounding of an
integer (as F5 guards the dyn-mask threshold): anchors are held equal, and
rows bit-equal and coefficients within one bf16 ulp, at every (view, block,
sample) whose taps all lie farther than EPS px from an integer, in JAX's
coordinates. EPS is 100x the largest projection difference the two sides
show on these rigs (asserted).

K1's patch_rows mode: the port's plain version (float32 combine, then the
float32 network) against ``gnt_fused_apply_mono4(patch_rows=...)`` (Pallas,
interpret mode, bf16), with K1's bounds (rgb atol/rtol 0.02, weights 0.01,
count 0.01, as test_torch_port_kernel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.core import cameras as jcam
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.kernels.gnt_fused_mono4 import gnt_fused_apply_mono4
from pgdvs_tpu.models.gnt import projector as jproj
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu.models.gnt.network import sinusoidal_embed as j_embed
from pgdvs_tpu.renderers.static_gnt import patch_ray_perm as j_patch_ray_perm
from pgdvs_tpu_torch.core import cameras
from pgdvs_tpu_torch.kernels import gnt_fused_patch as kp
from pgdvs_tpu_torch.models.gnt import projector as tproj
from pgdvs_tpu_torch.models.gnt.network import GNT
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict
from pgdvs_tpu_torch.renderers.static_gnt import patch_ray_perm

EPS = 1e-3
H, W, V, F = 24, 32, 3, 32


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _bf16_values(x):
    """x rounded to bf16, as float32 (the same numbers on both sides)."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def scene():
    """The contract scene's cameras and source images, full-resolution
    bf16-valued features, and two point sets in 4x2-ray-block order: the
    target's rays at 9 depths (a rig), and points scattered at random, which
    spread every block far past its footprint and out of reach."""
    data = make_contract_data(h=H, w=W, n_spatial=V, n_frames=6)
    rng = np.random.default_rng(8)
    feats = _bf16_values(rng.uniform(-1, 1, (V, H, W, F)).astype(np.float32))
    tgt = data["flat_cam_tgt"]
    rays_o, rays_d, _uv, _hw = jcam.get_rays(H, W, jcam.flat_cam_intrinsics(tgt),
                                             jcam.flat_cam_c2w(tgt))
    perm = np.asarray(j_patch_ray_perm(H * W, H, W, 4, 2)[0])
    z = np.linspace(1.5, 9.0, 9, dtype=np.float32)
    z = z + rng.uniform(0, 0.3, (H * W, 9)).astype(np.float32)
    rig = (np.asarray(rays_o)[perm][:, None] + z[..., None] * np.asarray(rays_d)[perm][:, None])
    scatter = np.stack([rng.uniform(-2.5, 2.5, (64, 9)), rng.uniform(-2, 2, (64, 9)),
                        rng.uniform(1.5, 8, (64, 9))], -1)
    return {"data": data, "feats": feats, "pts": {"rig": rig.astype(np.float32),
                                                  "scatter": scatter.astype(np.float32)}}


def _maps(scene, block):
    blk, foot = tproj.PATCH_BLOCKS[block]
    assert jproj.PATCH_BLOCKS[block] == (blk, foot)
    rgbs = scene["data"]["rgb_src_spatial"]
    jm = jproj.build_patch_maps(jnp.asarray(rgbs), jnp.asarray(scene["feats"]),
                                dtype=jnp.bfloat16, foot=foot, block=blk)
    tm = tproj.build_patch_maps(_t(rgbs), _t(scene["feats"]), foot=foot, block=blk)
    return jm, tm


@pytest.mark.parametrize("block", ["2x2", "4x2"])
def test_patch_maps_equal_jax(scene, block):
    jm, tm = _maps(scene, block)
    assert tm.vhw == jm.vhw and tm.foot == jm.foot and tm.block == jm.block
    assert tm.flat.dtype == torch.bfloat16
    np.testing.assert_array_equal(tm.flat.float().numpy(),
                                  np.asarray(jm.flat.astype(jnp.float32)))


@pytest.mark.parametrize("by,bx", [(2, 2), (4, 2)])
def test_patch_ray_perm_equals_jax(by, bx):
    perm, inv = patch_ray_perm(H * W, H, W, by, bx)
    jperm, jinv = j_patch_ray_perm(H * W, H, W, by, bx)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def _sampled(scene, block, which):
    jm, tm = _maps(scene, block)
    pts = scene["pts"][which]
    cams = scene["data"]["flat_cam_src_spatial"]
    tgt = scene["data"]["flat_cam_tgt"]
    proj = cameras.flat_cam_projection(_t(cams))
    jg = [np.asarray(a) for a in jproj._patch_gather(jnp.asarray(pts), jnp.asarray(cams), jm)]
    tg = [a.numpy() if a.dtype != torch.bfloat16 else a.float().numpy()
          for a in tproj._patch_gather(_t(pts), proj, tm)]
    jraw = jproj.epipolar_sample_patch_raw(jnp.asarray(pts), jnp.asarray(tgt),
                                           jnp.asarray(cams), jm)
    traw = tproj.epipolar_sample_patch_raw(_t(pts), proj, tm)
    jfrac = float(jproj.patch_clamp_fraction(jnp.asarray(pts), jnp.asarray(cams), jm))
    tfrac = float(tproj.patch_clamp_fraction(_t(pts), proj, tm))
    return jg, tg, jraw, traw, jfrac, tfrac, tm


@pytest.mark.parametrize("which", ["rig", "scatter"])
@pytest.mark.parametrize("block", ["2x2", "4x2"])
def test_patch_sampler_matches_jax(scene, block, which):
    jg, tg, jraw, traw, jfrac, tfrac, tm = _sampled(scene, block, which)
    _rows_j, x, y, _sx, _sy, ax_j, ay_j = jg
    _rows_t, xt, yt, _sxt, _syt, ax_t, ay_t = tg
    v, b, s = ax_j.shape
    nb = tm.block[0] * tm.block[1]
    inside = (np.abs(x) < 1e4) & (np.abs(y) < 1e4)
    assert np.abs(xt - x)[inside].max() * 100 < EPS
    assert np.abs(yt - y)[inside].max() * 100 < EPS

    def near(c):
        return np.abs(c - np.round(c)) <= EPS

    # (view, block, sample) cells whose taps all lie clear of an integer
    clear = ~(near(x) | near(y)).reshape(v, b, nb, s).any(axis=2)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ax_t[clear], ax_j[clear])
    np.testing.assert_array_equal(ay_t[clear], ay_j[clear])

    rows_j = np.asarray(jraw["rows"].astype(jnp.float32))
    rows_t = traw["rows"].float().numpy()
    assert traw["rows"].dtype == torch.bfloat16 and rows_t.shape == rows_j.shape
    np.testing.assert_array_equal(rows_t[clear], rows_j[clear])

    coef_j = np.asarray(jraw["coef"].astype(jnp.float32))
    coef_t = traw["coef"].float().numpy()
    assert traw["coef"].dtype == torch.bfloat16 and coef_t.shape == coef_j.shape
    n_pos = coef_j.shape[-1]
    cell = np.broadcast_to(clear[:, :, None, :, None], (v, b, nb, s, n_pos))
    cell = cell.reshape(v, b * nb // 4, 4, s, n_pos)
    big = np.maximum(np.abs(coef_j), np.abs(coef_t))
    ulp = np.where(big > 0, 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7), 0.0)
    assert np.all((np.abs(coef_t - coef_j) <= ulp)[cell])
    # every in-reach tap's coefficients sum to its bilinear weight sum (<= 1)
    assert coef_t.sum(-1).max() <= 1.0 + 2 ** -6

    assert abs(tfrac - jfrac) <= 1e-6
    if which == "scatter":
        assert tfrac > 0.1  # the border clamp is exercised
    else:
        assert tfrac < 0.05


def test_patch_gather_refuses_ragged_rays(scene):
    _jm, tm = _maps(scene, "4x2")
    proj = cameras.flat_cam_projection(_t(scene["data"]["flat_cam_src_spatial"]))
    with pytest.raises(ValueError, match="rays % 8"):
        tproj.epipolar_sample_patch_raw(_t(scene["pts"]["rig"][:12]), proj, tm)


# ------------------------------------------------------- K1 patch_rows mode

KH, KW = 20, 28


@pytest.fixture(scope="module")
def net():
    """The JAX GNT's flax weights and the port's GNT carrying them, and the
    camera rig of tests/test_gnt_fused.py's mono4 checks."""
    rng = np.random.default_rng(0)
    r, s, v, f = 16, 32, 5, 32
    gnt_j = JGNT(netwidth=64, depth=8, in_feat_ch=f, dtype="bfloat16", ret_view_std=False)
    params = gnt_j.init(
        jax.random.PRNGKey(0), rng.normal(size=(r, s, v, 3 + f)).astype(np.float32),
        rng.normal(size=(r, s, v, 4)).astype(np.float32),
        np.ones((r, s, v, 1), np.float32), rng.normal(size=(r, s, 3)).astype(np.float32),
        rng.normal(size=(r, 3)).astype(np.float32))
    gnt = GNT().eval()
    gnt.load_state_dict(gnt_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 25.0
    k[0, 2], k[1, 2] = KW / 2, KH / 2
    cams = []
    for i in range(v):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * i - 0.3, 0.1 * i, -0.2 * i]
        cams.append(np.asarray(jcam.make_flat_cam(KH, KW, k, c2w), np.float32))
    cams = jnp.asarray(np.stack(cams))
    centers = jnp.concatenate([jcam.flat_cam_c2w(cams[0])[None, :3, 3],
                               jax.vmap(jcam.flat_cam_c2w)(cams)[:, :3, 3]], axis=0)
    return {"params": params, "gnt": gnt, "v": v, "r": r, "fc": 3 + f,
            "projs": np.asarray(jax.vmap(jcam.flat_cam_projection)(cams)),
            "centers": np.asarray(centers)}


def _patch_operands(net, block_rays, n_pos, s, seed):
    """Random patch rows and Dirichlet coefficients (non-negative, summing
    to 1 per tap, like bilinear weights) in bf16, points in front of the
    rig, and the view code."""
    rng = np.random.default_rng(seed)
    v, r, fc = net["v"], net["r"], net["fc"]
    rows = _bf16_values(rng.normal(0, 0.5, (v, r // block_rays, s, n_pos * fc)))
    coef = _bf16_values(rng.dirichlet(np.ones(n_pos), (v, r // 4, 4, s)))
    pts = (rng.normal(0, 1.2, (r, s, 3)) + [0, 0, 2.5]).astype(np.float32)
    ray_d = rng.normal(size=(r, 3)).astype(np.float32)
    vc = np.asarray(j_embed(ray_d / np.linalg.norm(ray_d, axis=-1, keepdims=True)))
    return rows, coef, pts, vc


@pytest.mark.parametrize("block_rays,n_pos,s", [(4, 16, 32), (8, 24, 32), (8, 24, 23)])
def test_patch_plain_matches_jax_mono4_patch_rows(net, block_rays, n_pos, s):
    """2x2 and 4x2 row blocks, and an odd sample count (which mono4 pads
    and the port does not)."""
    rows, coef, pts, vc = _patch_operands(net, block_rays, n_pos, s, seed=block_rays + s)
    ref = gnt_fused_apply_mono4(
        net["params"], None, jnp.asarray(pts), jnp.asarray(vc), jnp.asarray(net["centers"]),
        jnp.asarray(net["projs"]), (KH, KW), ray_block=8, interpret=True,
        patch_rows=jnp.asarray(rows).astype(jnp.bfloat16),
        patch_coef=jnp.asarray(coef).astype(jnp.bfloat16))
    before = kp.gnt_fused_mono4_patch.launches
    got = kp.gnt_fused_mono4_patch(
        net["gnt"], _t(rows).to(torch.bfloat16), _t(coef).to(torch.bfloat16), _t(pts),
        _t(vc), _t(net["centers"]), _t(net["projs"]), (KH, KW))
    assert kp.gnt_fused_mono4_patch.launches == before  # the CPU runs the plain version
    assert tuple(got["weights"].shape) == (net["r"], s)
    valid_frac = float(np.mean(np.asarray(ref["inbound_cnt_raw"])))
    assert 0.05 < valid_frac < 0.95  # a mix of valid and invalid views
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]), atol=0.02, rtol=0.02)
    np.testing.assert_allclose(got["weights"].numpy(), np.asarray(ref["weights"]), atol=0.01)
    np.testing.assert_allclose(got["inbound_cnt_raw"].numpy(),
                               np.asarray(ref["inbound_cnt_raw"]), atol=0.01)


def test_patch_combine_is_the_stencil_sum(net):
    """The plain combine: ray r reads its block's row, r // 4 and r % 4
    pick its coefficients."""
    rows, coef, _pts, _vc = _patch_operands(net, 8, 24, 5, seed=3)
    got = kp.patch_combine(_t(rows), _t(coef)).numpy()
    v, r, fc = net["v"], net["r"], net["fc"]
    ref = np.zeros((v, r, 5, fc), np.float64)
    for ray in range(r):
        row = rows[:, ray // 8].reshape(v, 5, 24, fc)
        ref[:, ray] = np.einsum("vspc,vsp->vsc", row, coef[:, ray // 4, ray % 4])
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_patch_wrapper_refuses_bad_geometry(net):
    rows, coef, pts, vc = _patch_operands(net, 8, 24, 4, seed=1)
    args = (_t(pts), _t(vc), _t(net["centers"]), _t(net["projs"]), (KH, KW))
    with pytest.raises(ValueError, match="patch geometry"):  # 8-ray rows, 16 positions
        kp.gnt_fused_mono4_patch(net["gnt"], _t(rows), _t(coef[..., :16]), *args)
    with pytest.raises(ValueError, match="coef"):
        kp.gnt_fused_mono4_patch(net["gnt"], _t(rows), _t(coef[:, :, :2]), *args)
    meta = torch.empty(rows.shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kp.gnt_fused_mono4_patch(net["gnt"], meta, _t(coef), *args)
