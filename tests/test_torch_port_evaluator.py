"""The port's evaluation engine and DyCheck metrics against the JAX package's.

On numpy-seeded images and masks: ``metrics.dycheck``'s mPSNR / mSSIM /
mLPIPS against JAX's at 1e-5 relative, with holed, all-ones and no masks;
``compute_nvidia_metrics`` and ``resize_gt_to_render`` bit for bit (the
same numpy and torch host arithmetic), ``compute_dycheck_metrics`` at 1e-5;
the NaN guard. Then ``Evaluator.run`` on a tiny NVIDIA-layout scene (the
reader scene of ``chip_smoke.write_reader_scene`` at 24x32, 3 frames of the
mono video, 2 sources each) against JAX's ``Evaluator`` on the same scene,
its first 2 items, with the `default` bundle on the fast preset (quad
sampling; JAX runs mono3 in bf16, Pallas in interpret mode, the port its
plain float32 network on the CPU), the JAX item's noise handed to the
port's render. Checked: equal count and
metric keys; per item, the port's metrics equal to JAX's
``compute_nvidia_metrics`` of the port's render; the renders within the
`default` bounds of tests/test_torch_port_default.py; the pickles' schema
and join ids; the PNGs decoding, with PIL, to the truncated uint8 of the
render; striding and ``max_items``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import chip_smoke
from pgdvs_tpu.configs.benchmarks import resolve_benchmark as j_resolve_benchmark
from pgdvs_tpu.data.nvidia_eval import NvidiaEvalDataset as JNvidiaEvalDataset
from pgdvs_tpu.engines import evaluator as jev
from pgdvs_tpu.metrics import dycheck as jdm
from pgdvs_tpu.metrics.lpips_jax import lpips_distance as j_lpips_distance
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset
from pgdvs_tpu_torch.engines import evaluator as tev
from pgdvs_tpu_torch.metrics import dycheck as tdm
from pgdvs_tpu_torch.metrics.lpips import LPIPS, lpips_params_from_jax
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models
from test_torch_port_lpips import jax_lpips_params

RTOL = 1e-5
# the `default` bundle's bounds (tests/test_torch_port_default.py)
TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02, "dyn_cnt": 0.02}
H, W = 24, 32
SCENE_FRAMES = 3
S = 8
# items of the run held against JAX's (the striding cases run all three)
RUN_ITEMS = 2


def _images(h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    holed = (rng.uniform(size=(h, w, 1)) > 0.3).astype(np.float32)
    holed[h // 3: h // 2, w // 4: w // 2] = 0.0
    return a, b, {"holed": holed, "ones": np.ones((h, w, 1), np.float32), "none": None}


@pytest.fixture(scope="module")
def lpips_pair():
    params = jax_lpips_params(seed=3)
    net = LPIPS()
    net.load_state_dict(lpips_params_from_jax(params))
    return {k: jnp.asarray(v) for k, v in params.items()}, net.eval()


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("mask", ["holed", "ones", "none"])
@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_dycheck_psnr_ssim_match_jax(metric, mask):
    a, b, masks = _images()
    m = masks[mask]
    got = float(getattr(tdm, f"compute_{metric}")(_t(a), _t(b), _t(m)))
    ref = float(getattr(jdm, f"compute_{metric}")(_j(a), _j(b), _j(m)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("mask", ["holed", "ones", "none"])
def test_dycheck_lpips_matches_jax(lpips_pair, mask):
    a, b, masks = _images(40, 56)
    m = masks[mask]
    jp, net = lpips_pair
    got = float(tdm.compute_lpips(net, _t(a), _t(b), _t(m)))
    ref = float(jdm.compute_lpips(jp, _j(a), _j(b), _j(m)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_masked_mean_floors_an_empty_mask():
    x = torch.ones(4, 5, 3)
    assert float(tdm.masked_mean(x, torch.zeros(4, 5, 1))) == 0.0


def _pred_gt_dyn(h=H, w=W, seed=1):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.05, 1.05, (h, w, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    dyn = np.zeros((h, w, 1), np.float32)
    dyn[h // 4: 3 * h // 4, w // 3: 2 * w // 3] = 1.0
    return pred, gt, dyn


@pytest.mark.parametrize("dyn_ndim", [2, 3])
def test_compute_nvidia_metrics_bit_equal(dyn_ndim):
    pred, gt, dyn = _pred_gt_dyn()
    dyn = dyn[..., 0] if dyn_ndim == 2 else dyn
    got = tev.compute_nvidia_metrics(pred, gt, dyn)
    ref = jev.compute_nvidia_metrics(pred, gt, dyn)
    assert got == ref


def test_compute_nvidia_metrics_ssim_equals_three_calls():
    """The SSIM map computed once gives each region's masked_ssim bit for
    bit."""
    from pgdvs_tpu_torch.metrics.psnr_ssim import masked_ssim, quantize_uint8

    pred, gt, dyn = _pred_gt_dyn()
    got = tev.compute_nvidia_metrics(pred, gt, dyn)
    p, g = quantize_uint8(np.clip(pred, 0, 1)), quantize_uint8(gt)
    d3 = np.repeat(dyn.astype(np.float64), 3, -1)
    for region, m in (("full", np.ones_like(d3)), ("dyn", d3), ("static", 1.0 - d3)):
        assert got[f"ssim_{region}"] == masked_ssim(p, g, m)


def test_compute_nvidia_metrics_with_lpips(lpips_pair):
    pred, gt, dyn = _pred_gt_dyn(48, 64)
    jp, net = lpips_pair
    got = tev.compute_nvidia_metrics(
        pred, gt, dyn, lpips_fn=lambda a, b, m: tev.lpips_on_host_arrays(net, a, b, m))
    ref = jev.compute_nvidia_metrics(
        pred, gt, dyn, lpips_fn=lambda a, b, m: j_lpips_distance(jp, a, b, mask=m))
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k.startswith("lpips"):
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL)
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("lpips", [False, True])
def test_compute_dycheck_metrics_matches_jax(lpips_pair, lpips):
    """On an image and a noisy copy of it, as a render and its GT are (mSSIM
    of two independent images is a mean near 0 of terms near 1, where float32
    summation order alone moves it by 1e-5 of its value)."""
    gt, pred, masks = _images(40, 56)
    covis = masks["holed"][..., 0]
    jp, net = lpips_pair
    got = tev.compute_dycheck_metrics(pred, gt, covis, lpips_net=net if lpips else None)
    ref = jev.compute_dycheck_metrics(pred, gt, covis, lpips_params=jp if lpips else None)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL)


@pytest.mark.parametrize("hw,render_hw,mask_ndim", [
    ((24, 32), (12, 16), 3), ((25, 33), (13, 17), 2), ((24, 32), (24, 32), 3),
    ((30, 41), (10, 14), 3)])
def test_resize_gt_to_render_bit_equal(hw, render_hw, mask_ndim):
    rng = np.random.default_rng(4)
    gt = rng.integers(0, 256, hw + (3,)).astype(np.float64) / 255.0
    mask = (rng.uniform(size=hw + (1,)) > 0.6).astype(np.float32)
    mask = mask[..., 0] if mask_ndim == 2 else mask
    got_rgb, got_m = tev.resize_gt_to_render(gt, mask, render_hw)
    ref_rgb, ref_m = jev.resize_gt_to_render(gt, mask, render_hw)
    assert got_rgb.dtype == ref_rgb.dtype and np.array_equal(got_rgb, ref_rgb)
    assert np.asarray(got_m).dtype == np.asarray(ref_m).dtype
    assert np.array_equal(got_m, ref_m)


# ------------------------------------------------------------------ engine


def _write_scene(root):
    chip_smoke.write_reader_scene(root, raw_hw=(H, W), eval_hw=(H, W),
                                  n_frames=SCENE_FRAMES, items=(),
                                  flow_frames=((0, SCENE_FRAMES),))
    return root


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    models = make_gnt_models()
    params = init_gnt_params(jax.random.PRNGKey(0), *models, n_src=2)
    fnet, gnt = init_gnt_models(device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    fnet.load_state_dict(resunet_state_dict(np_params["feature_net"]))
    gnt.load_state_dict(gnt_state_dict(np_params["gnt"]))
    cfg_j = j_resolve_benchmark("default")[0].replace(
        n_coarse_samples_per_ray=S, ray_tile=256, knn_tile=256)
    cfg = resolve_benchmark("default")[0].replace(n_coarse_samples_per_ray=S, ray_tile=256)
    return {"j": (models, params, cfg_j), "t": ((fnet, gnt), cfg)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = _write_scene(tmp_path_factory.mktemp("scene"))
    kw = dict(scene_ids=[chip_smoke.READER_SCENE], tgt_height=H, n_src_views_spatial=2)
    return NvidiaEvalDataset(root, **kw), JNvidiaEvalDataset(root, **kw)


def _port_evaluator(engines, out_dir=None, renders=None):
    """The port's Evaluator; its renders take the JAX item's noise (drawn
    from PRNGKey(seed), the seed read from the generator) and are kept in
    ``renders`` by item seed."""
    models, cfg = engines["t"]
    ev = tev.Evaluator(models, cfg, out_dir=out_dir, save_vis=True)
    real = tev.render_novel_view

    def render(models, data, cfg, generator=None, static_mode="gnt"):
        seed = generator.initial_seed()
        noise = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                           tuple(data["rgb_src_temporal"][0].shape),
                                           jnp.float32))
        out = real(models, data, cfg, static_mode=static_mode, noise=torch.from_numpy(noise))
        if renders is not None:
            renders[seed] = {k: v.numpy() for k, v in out.items()}
        return out

    return ev, render


@pytest.fixture(scope="module")
def runs(engines, scene, tmp_path_factory):
    t_ds, j_ds = scene
    out_t, out_j = tmp_path_factory.mktemp("out_t"), tmp_path_factory.mktemp("out_j")
    renders_t, renders_j = {}, {}
    ev, render = _port_evaluator(engines, out_t, renders_t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tev, "render_novel_view", render)
        res_t = ev.run(t_ds, max_items=RUN_ITEMS)
    models, params, cfg_j = engines["j"]
    jev_ = jev.Evaluator(models, params, cfg_j, out_dir=str(out_j), save_vis=True)
    real = jev_._render

    def keep(p, data, key):
        out = real(p, data, key)
        renders_j[len(renders_j)] = jax.tree_util.tree_map(np.asarray, out)
        return out

    jev_._render = keep
    res_j = jev_.run(j_ds, max_items=RUN_ITEMS)
    return {"t": (res_t, out_t, renders_t), "j": (res_j, out_j, renders_j), "ds": t_ds}


def test_run_count_and_keys_match_jax(runs):
    res_t, res_j = runs["t"][0], runs["j"][0]
    assert res_t["count"] == res_j["count"] == RUN_ITEMS
    assert sorted(res_t["mean"]) == sorted(res_j["mean"])
    assert sorted(res_t["sum"]) == sorted(res_t["mean"])


def test_run_metrics_are_jax_metrics_of_the_port_render(runs):
    res_t, out_t, renders = runs["t"]
    for seed, out in renders.items():
        rec = pickle.loads((out_t / f"{seed:06d}.pkl").read_bytes())
        misc = runs["ds"][seed]["misc"]
        ref = jev.compute_nvidia_metrics(out["combined_rgb"], runs["ds"][seed]["rgb_tgt"],
                                         misc["tgt_dyn_mask"])
        for k, v in ref.items():
            assert rec[k] == v, (seed, k)
    means = {k: np.mean([pickle.loads((out_t / f"{s:06d}.pkl").read_bytes())[k]
                         for s in renders]) for k in res_t["mean"]}
    for k, v in means.items():
        np.testing.assert_allclose(res_t["mean"][k], v, rtol=1e-12)


@pytest.mark.parametrize("key", ["combined_rgb", "static_coarse_rgb", "static_coarse_depth",
                                 "static_coarse_inbound_cnt", "static_coarse_dyn_cnt"])
def test_run_renders_match_jax(runs, key):
    tol = next(t for name, t in TOL.items() if key.endswith(name))
    got, ref = runs["t"][2], runs["j"][2]
    assert sorted(got) == sorted(ref)
    for i in ref:
        np.testing.assert_allclose(got[i][key], ref[i][key], atol=tol)


def test_pickles_carry_the_join_ids(runs):
    out_t, out_j = runs["t"][1], runs["j"][1]
    names = sorted(p.name for p in out_t.glob("*.pkl"))
    assert names == sorted(p.name for p in out_j.glob("*.pkl"))
    for name in names:
        got = pickle.loads((out_t / name).read_bytes())
        ref = pickle.loads((out_j / name).read_bytes())
        assert sorted(got) == sorted(ref)
        for k in ("scene_id", "tgt_frame_id", "tgt_cam_id"):
            assert got[k] == ref[k]
    summary_keys = set(runs["t"][0]["mean"])
    assert not summary_keys & {"scene_id", "tgt_frame_id", "tgt_cam_id"}


def test_pngs_decode_to_the_truncated_render(runs):
    out_t, renders = runs["t"][1], runs["t"][2]
    for seed, out in renders.items():
        with PIL.Image.open(out_t / f"{seed:06d}_combined.png") as im:
            got = np.asarray(im)
        want = (np.clip(out["combined_rgb"], 0.0, 1.0) * 255).astype(np.uint8)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("index,count,max_items,want", [
    (1, 2, -1, [1]), (0, 2, -1, [0, 2]), (0, 2, 1, [0]), (0, 1, 2, [0, 1]), (2, 3, -1, [2]),
    (0, 1, 0, [])])
def test_run_strides_and_caps_items(engines, scene, index, count, max_items, want):
    renders = {}
    ev, render = _port_evaluator(engines, renders=renders)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tev, "render_novel_view", render)
        res = ev.run(scene[0], process_index=index, process_count=count, max_items=max_items)
    assert sorted(renders) == want
    assert res["count"] == len(want)


def test_run_over_an_iterable_strides_items(engines, scene):
    renders = {}
    ev, render = _port_evaluator(engines, renders=renders)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tev, "render_novel_view", render)
        res = ev.run(iter(scene[0]), process_index=0, process_count=2)
    assert sorted(renders) == [0, 2] and res["count"] == 2


def test_nan_guard_zero_fills_as_jax(engines, scene):
    item = scene[0][0]
    pred = np.array(item["rgb_tgt"])
    pred[:3, :4] = np.nan
    pred[5, 6] = np.inf
    pred[7, 8] = -np.inf
    models, cfg = engines["t"]
    got = tev.Evaluator(models, cfg)._score(pred.copy(), item, "x", 0.5)
    jmodels, params, cfg_j = engines["j"]
    ref = jev.Evaluator(jmodels, params, cfg_j)._score(pred.copy(), item, "x", 0.5)
    assert got.metrics == ref.metrics
    assert all(np.isfinite(v) for v in got.metrics.values())


def test_evaluator_refuses_what_stays_outside(engines):
    models, cfg = engines["t"]
    with pytest.raises(ValueError, match="static_mode"):
        tev.Evaluator(models, cfg, static_mode="geo")
    with pytest.raises(ValueError, match="dyn_render_type"):
        tev.Evaluator(models, cfg.replace(dyn_render_type="pcl"))
