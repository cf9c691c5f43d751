"""The track branch of the port against the JAX package's, on the CPU, from
the same numpy inputs.

  * the KNN's cross-set mode (invalid queries and candidates, fewer valid
    candidates than K) and an external ``dist_thres``: the same means and
    masks at 1e-5 relative;
  * ``build_track_stack`` and ``select_queries`` on the synthetic scene's
    track sources (``k_track=2``) with fractional mask values, so the mask
    order has ties (both sorts are stable): equal;
  * ``compute_track_pointcloud`` on given tracks and visibles whose frames
    lie equally far from the target time (the lower index is taken first,
    as ``jax.lax.top_k`` takes it): masks equal, points and colours 1e-5;
  * ``render_dynamic`` with the track branch (``render_with_track``) and
    ``render_novel_view`` on the track bundle with Lucas-Kanade on a 24x32
    synthetic scene with ``k_track=2`` (the exact preset; JAX's float32
    flax network, ``use_pallas_gnt=False``): every mask equal, rgb 1e-5
    (the dynamic layer) and the static layer at the bounds
    tests/test_torch_port_default.py holds the `default` bundle to.

Point radius 0.1 NDC (1.2 pixels at 24x32) so the clouds cover pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.synthetic import make_contract_data
from pgdvs_tpu.kernels.knn import knn_mean_sq_dist as j_knn
from pgdvs_tpu.kernels.knn import statistical_outlier_mask as j_outlier
from pgdvs_tpu.models.tracking import LucasKanadeTracker as JLucasKanadeTracker
from pgdvs_tpu.renderers import dynamic_track as jdt
from pgdvs_tpu.renderers.compose import render_novel_view as j_render_novel_view
from pgdvs_tpu.renderers.dynamic import render_dynamic as j_render_dynamic
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.core import cameras
from pgdvs_tpu_torch.core.geometry import unproject_depth
from pgdvs_tpu_torch.kernels.knn import knn_mean_sq_dist, statistical_outlier_mask
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.models.tracking import LucasKanadeTracker
from pgdvs_tpu_torch.renderers import dynamic_track as tdt
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.dynamic import render_dynamic
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models
from test_torch_port_lk import one_thread

BUNDLE = "st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir"
H, W, V, S = 24, 32, 3, 16
RADIUS = 0.1
TOL = dict(rtol=1e-5, atol=1e-5)
STATIC_TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02, "dyn_cnt": 0.02}


def _t(x):
    return torch.from_numpy(np.array(x))


def _tdata(data):
    return {k: _t(v) for k, v in data.items() if isinstance(v, np.ndarray)}


def _jdata(data):
    return {k: jnp.asarray(v) for k, v in data.items() if k != "misc"}


@pytest.fixture(scope="module")
def data():
    return make_contract_data(h=H, w=W, n_spatial=V, n_frames=8, k_track=2)


def _cfgs(preset="fast", **over):
    ours = resolve_benchmark(BUNDLE, preset)[0].replace(dyn_render_pcl_pt_radius=RADIUS, **over)
    ref = j_resolve_benchmark(BUNDLE, preset)[0].replace(dyn_render_pcl_pt_radius=RADIUS,
                                                         knn_tile=256, **over)
    return ours, ref


# ------------------------------------------------------------------ KNN

@pytest.mark.parametrize("n_cand_valid", [400, 7])
def test_knn_cross_set_matches_jax(n_cand_valid):
    """Queries against a second cloud, a fifth of the queries invalid; the
    candidates padded with invalid rows (7 valid: fewer than K = 11, so
    the missing neighbours count 1e30 in both)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    valid = rng.random(300) > 0.2
    cands = rng.normal(size=(500, 3)).astype(np.float32)
    cand_valid = np.zeros(500, bool)
    cand_valid[rng.choice(500, n_cand_valid, replace=False)] = True
    got = knn_mean_sq_dist(_t(pts), _t(valid), k=11, tile=128, candidates=_t(cands),
                           cand_valid=_t(cand_valid), exclude_self=False).numpy()
    ref = np.asarray(j_knn(jnp.asarray(pts), jnp.asarray(valid), k=11, tile=128,
                           candidates=jnp.asarray(cands), cand_valid=jnp.asarray(cand_valid),
                           exclude_self=False))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert (got[~valid] == 1e30).all()
    assert (got[valid] < 1e29).all() == (n_cand_valid >= 11)


def test_knn_same_set_refuses_keeping_self():
    with pytest.raises(ValueError, match="excludes self"):
        knn_mean_sq_dist(torch.zeros(4, 3), k=2, exclude_self=False)


def test_outlier_mask_external_threshold_matches_jax():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(size=(200, 3)), 8 + rng.normal(size=(5, 3))]).astype(
        np.float32)
    valid = rng.random(205) > 0.1
    thres = np.float32(0.9)
    keep, t = statistical_outlier_mask(_t(pts), _t(valid), k=6, dist_thres=torch.tensor(thres))
    ref_keep, ref_t = j_outlier(jnp.asarray(pts), jnp.asarray(valid), k=6,
                                dist_thres=jnp.asarray(thres))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    assert float(t) == float(ref_t) == thres
    assert 0 < keep.sum() < valid.sum()


# ------------------------------------------------- stack and queries

def _fractional_masks(data):
    """Mask values 0, 0.5 and 1: the mask order ties within each value."""
    d = dict(data)
    rng = np.random.default_rng(2)
    for side in ("fwd", "bwd"):
        m = d[f"dyn_mask_src_track_{side}"]
        d[f"dyn_mask_src_track_{side}"] = (m * rng.choice([0.5, 1.0], m.shape)).astype(m.dtype)
    return d


@pytest.mark.parametrize("q_cap", [H * W, 40])
def test_stack_and_queries_match_jax(data, q_cap):
    d = _fractional_masks(data)
    stack = tdt.build_track_stack(_tdata(d))
    ref = jdt.build_track_stack(_jdata(d))
    assert stack["idx_temporal"] == ref["idx_temporal"] and stack["k"] == ref["k"] == 2
    for key in ("rgbs", "masks", "depths", "cams", "times", "real_track"):
        np.testing.assert_array_equal(stack[key].numpy(), np.asarray(ref[key]), err_msg=key)
    queries, valid = tdt.select_queries(stack, q_cap)
    ref_q, ref_v = jdt.select_queries(ref, q_cap)
    np.testing.assert_array_equal(queries.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_v))
    assert 0 < valid.sum() < valid.numel()


def test_stack_real_track_from_n_actual(data):
    d = dict(data, n_actual_src_track_fwd=np.array([1]), n_actual_src_track_bwd=np.array([0]))
    got = tdt.build_track_stack(_tdata(d))["real_track"].numpy()
    ref = np.asarray(jdt.build_track_stack(_jdata(d))["real_track"])
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [True, False, False, False, False, False]


# ------------------------------------------------- the lifted cloud

def test_compute_track_pointcloud_matches_jax(data):
    """Random tracks over the frames; visibilities chosen so that many
    queries qualify; track times 0, 1, 2, 3, 4, 5 against a target of 2.5,
    so frames 2 and 3 (and 1 and 4, 0 and 5) tie on distance. The base
    cloud is temporal frame 0 lifted by its depth; K = 5 and a threshold of
    0.2 make both filters drop points."""
    d = dict(data)
    d["time_src_track_fwd"] = np.array([0.0, 1.0], np.float32)
    d["time_src_temporal"] = np.array([2.0, 3.0], np.float32)
    d["time_src_track_bwd"] = np.array([4.0, 5.0], np.float32)
    d["time_tgt"] = np.array([2.5], np.float32)
    rng = np.random.default_rng(3)
    n = 400
    tracks = np.stack([rng.uniform(0, W - 1, (n, 6)), rng.uniform(0, H - 1, (n, 6))],
                      axis=-1).astype(np.float32)
    vis = rng.random((n, 6)) > 0.35
    vis[: n // 2, 2:4] = False  # half the queries occluded in the temporal pair
    q_valid = rng.random(n) > 0.1
    cam = _t(data["flat_cam_src_temporal"][0])
    base = unproject_depth(_t(data["depth_src_temporal"][0][..., 0]),
                           cameras.flat_cam_intrinsics(cam),
                           cameras.flat_cam_c2w(cam)).reshape(-1, 3).numpy()[::3]
    base_cols = rng.uniform(size=base.shape).astype(np.float32)
    base_valid = rng.random(base.shape[0]) > 0.1
    thres = np.float32(0.2)
    cfg, cfg_j = _cfgs(dyn_pcl_outlier_knn=5)
    stats = {}
    got = tdt.compute_track_pointcloud(
        tdt.build_track_stack(_tdata(d)), _t(tracks), _t(vis), _t(q_valid),
        _t(d["time_tgt"])[0], _t(base), _t(base_cols), _t(base_valid), torch.tensor(thres), cfg,
        stats=stats)
    ref = jdt.compute_track_pointcloud(
        jdt.build_track_stack(_jdata(d)), jnp.asarray(tracks), jnp.asarray(vis),
        jnp.asarray(q_valid), jnp.asarray(d["time_tgt"])[0], jnp.asarray(base),
        jnp.asarray(base_cols), jnp.asarray(base_valid), jnp.asarray(thres), cfg_j)
    keep = got[2].numpy()
    np.testing.assert_array_equal(keep, np.asarray(ref[2]))
    assert 0 < stats["kept_self_filter"] < stats["kept_base_filter"] <= stats["lifted"]
    assert stats["kept_self_filter"] == keep.sum()
    np.testing.assert_allclose(got[0].numpy()[keep], np.asarray(ref[0])[keep], **TOL)
    np.testing.assert_allclose(got[1].numpy()[keep], np.asarray(ref[1])[keep], **TOL)
    # the tie order: frames 1 and 4 both 1.5 from the target -> 1 first
    time_diff = np.abs(np.array([0, 1, 2, 3, 4, 5]) - 2.5)
    top2 = tdt.nearest_two(_t(vis), _t(np.array([0, 1, 2, 3, 4, 5], np.float32)),
                           torch.tensor(2.5)).numpy()
    for i in np.flatnonzero(vis[:, 1] & vis[:, 4] & ~vis[:, 2] & ~vis[:, 3])[:5]:
        assert top2[i].tolist() == [1, 4], (i, time_diff)


# ------------------------------------------------- the branch end to end

def _compare(got, ref, keys):
    for k in keys:
        r = np.asarray(ref[k])
        if k.endswith("mask"):
            np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), r, **TOL, err_msg=k)


def test_render_dynamic_with_track_matches_jax(data, novel_views):
    """render_dynamic with LK on its own: the splat layer, the track layer
    (render_with_track) and their composite against JAX's dynamic keys of
    the bundle's render (the same layer: no stride); the tracker saw only
    the valid query slots."""
    _, ref = novel_views
    cfg, _ = _cfgs()
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                         data["rgb_src_temporal"][0].shape, jnp.float32))
    seen = []

    def tracker(frames, queries, query_valid=None):
        seen.append(queries.shape[0])
        return LucasKanadeTracker()(frames, queries, query_valid)

    with one_thread():
        got = render_dynamic(_tdata(data), cfg, noise=_t(noise), tracker=tracker)
    got = {f"render_dyn_{k}": v for k, v in got.items() if k != "pcl"}
    _compare(got, ref, [k for k in ref if k.startswith("render_dyn")])
    stack = tdt.build_track_stack(_tdata(data))
    assert seen == [int(tdt.select_queries(stack, H * W)[1].sum())] and 0 < seen[0] < 6 * H * W
    # the track layer fills pixels the splat leaves uncovered
    mask, closest = got["render_dyn_mask"].numpy(), got["render_dyn_temporal_closest_mask"]
    assert (mask > closest.numpy()).any()
    assert 0 < got["render_dyn_temporal_track_mask"].numpy().mean() < 1


def test_no_tgt_without_tracker_skips_the_branch(data):
    cfg, cfg_j = _cfgs()
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
    got = render_dynamic(_tdata(data), cfg, noise=_t(noise))
    ref = j_render_dynamic(_jdata(data), cfg_j, key)
    _compare(got, ref, ("mask", "temporal_track_mask", "rgb", "temporal_track_rgb"))
    assert not got["temporal_track_mask"].any()


@pytest.fixture(scope="module")
def novel_views(data):
    models = make_gnt_models(dtype="float32")
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=V)
    key = jax.random.PRNGKey(1)
    cfg, cfg_j = _cfgs("exact", n_coarse_samples_per_ray=S, ray_tile=256)
    jd = _jdata(data)
    ref = jax.jit(lambda p: j_render_novel_view(
        models, p, jd, cfg_j.replace(use_pallas_gnt=False), key,
        tracker=JLucasKanadeTracker()))(params)
    fnet, gnt = init_gnt_models(device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
    gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
    noise = np.asarray(jax.random.normal(key, data["rgb_src_temporal"][0].shape, jnp.float32))
    with one_thread():
        got = render_novel_view((fnet, gnt), _tdata(data), cfg, noise=_t(noise),
                                tracker=LucasKanadeTracker())
    return got, jax.tree_util.tree_map(np.asarray, ref)


def test_render_novel_view_track_bundle_matches_jax(novel_views):
    got, ref = novel_views
    assert sorted(got) == sorted(ref)
    dyn = [k for k in ref if k.startswith("render_dyn")]
    _compare(got, ref, dyn)
    assert got["render_dyn_temporal_track_mask"].any()
    for key, bound in STATIC_TOL.items():
        err = np.abs(got[f"static_coarse_{key}"].numpy() - ref[f"static_coarse_{key}"]).max()
        assert err <= bound, (key, err)
    m = got["render_dyn_mask"].numpy()
    for key in ("combined_rgb", "combined_rgb_dyn"):
        np.testing.assert_allclose(got[key].numpy() * m, ref[key] * m, **TOL, err_msg=key)
    np.testing.assert_array_less(np.abs(got["combined_rgb"].numpy() - ref["combined_rgb"]),
                                 STATIC_TOL["rgb"] + 1e-6)
