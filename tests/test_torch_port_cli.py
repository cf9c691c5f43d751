"""The port's CLI (``python -m pgdvs_tpu_torch.run``), in-process with
``--device cpu``, on a tiny NVIDIA-layout scene (``chip_smoke.
write_reader_scene`` at 24x32, 3 frames, default directory names): ``eval``
(fast preset, patch sampling) and ``benchmark --benchmark-type default``
write pickles, PNGs and a ``summary.json`` of the evaluator's schema;
``build_render_config`` equals the JAX CLI's field by field for the same
argv (presets, overrides, a restored base); an unknown field exits; the
pure-geometry bundle, ``eval --static-mode geo``, and the point / mesh
dynamic layers run (``--max-items 1``) and their summaries match the JAX
CLI's (``run.py``) on the same scene, with one reference checkpoint for both
where a GNT renders (the exact preset; JAX's float32 flax network,
``use_pallas_gnt=false``, against the port's float32 network on the CPU);
what the port does not carry raises, naming its ROADMAP item; ``--device
cuda`` without a card raises."""

import argparse
import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from pgdvs_tpu_torch import run as trun
from pgdvs_tpu_torch.renderers.config import RenderConfig

H, W = 24, 32
REGIONS = ("full", "dyn", "static")


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_scene")
    chip_smoke.write_reader_scene(root, raw_hw=(H, W), eval_hw=(H, W), n_frames=3, items=(),
                                  flow_frames=((0, 3),))
    return root


def _argv(cmd, root, out, *extra):
    return [cmd, "--device", "cpu", "--data-root", str(root),
            "--scene-ids", chip_smoke.READER_SCENE,
            "--dataset-arg", f"tgt_height={H}", "n_src_views_spatial=2",
            "--out-dir", str(out), "--render-cfg", "n_coarse_samples_per_ray=8",
            "ray_tile=256", *extra]


def _check_outputs(out, result, n, vis=True):
    summary = json.loads((out / "summary.json").read_text())
    assert summary == json.loads(json.dumps(result))
    assert sorted(summary) == ["count", "mean", "sum"] and summary["count"] == n
    keys = sorted([f"{m}_{r}" for m in ("psnr", "ssim") for r in REGIONS] + ["render_wall_s"])
    assert sorted(summary["mean"]) == sorted(summary["sum"]) == keys
    recs = [pickle.loads((out / f"{i:06d}.pkl").read_bytes()) for i in range(n)]
    for k in keys:
        np.testing.assert_allclose(summary["mean"][k], np.mean([r[k] for r in recs]),
                                   rtol=1e-12)
    for i, rec in enumerate(recs):
        assert (rec["scene_id"], rec["tgt_frame_id"], rec["tgt_cam_id"]) == (
            chip_smoke.READER_SCENE, i, i)
        assert (out / f"{i:06d}_combined.png").is_file() == vis


def test_eval_subcommand(scene_root, tmp_path):
    out = tmp_path / "eval"
    result = trun.main(_argv("eval", scene_root, out, "--max-items", "2", "--save-vis"))
    _check_outputs(out, result, 2)


def test_eval_without_save_vis_strided(scene_root, tmp_path):
    out = tmp_path / "eval"
    result = trun.main(_argv("eval", scene_root, out, "--process-index", "1",
                             "--process-count", "2"))
    assert result["count"] == 1
    assert [p.name for p in sorted(out.iterdir())] == ["000001.pkl", "summary.json"]


@pytest.mark.parametrize("preset", ["fast", "exact"])
def test_benchmark_default(scene_root, tmp_path, preset):
    out = tmp_path / "bm"
    result = trun.main(_argv("benchmark", scene_root, out, "--benchmark-type", "default",
                             "--perf-preset", preset, "--max-items", "1"))
    _check_outputs(out, result, 1)


def _jax_cli():
    """The JAX CLI module (the repository's run.py)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "pgdvs_jax_cli", pathlib.Path(chip_smoke.__file__).parent / "run.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:  # undo the env default it sets on import
        mp.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        spec.loader.exec_module(mod)
    return mod


def _jax_build_render_config():
    return _jax_cli().build_render_config


@pytest.mark.parametrize("preset", ["fast", "exact"])
@pytest.mark.parametrize("render_cfg,base", [
    (None, None),
    (["n_coarse_samples_per_ray=8", "ray_tile=512"], None),
    (["gnt_use_dyn_mask=true", "epipolar_mode=quad_i8", "softsplat_metric_abs_alpha=50"], None),
    (["epipolar_mode=exact", "dyn_pcl_remove_outlier=1", "pure_gnt=no"], None),
    (["render_stride=2"], {"n_fine_samples_per_ray": 64, "gnt_use_dyn_mask": True,
                           "knn_tile": 512}),
])
def test_build_render_config_matches_jax(preset, render_cfg, base):
    args = argparse.Namespace(perf_preset=preset, render_cfg=render_cfg)
    got = trun.build_render_config(args, base=base)
    ref = _jax_build_render_config()(args, base=base)
    for f in dataclasses.fields(RenderConfig):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference GNT checkpoint of the port's random models (seed 0),
    which both CLIs load."""
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    path = tmp_path_factory.mktemp("ckpt") / "gnt" / "model_720000.pth"
    chip_smoke.save_reference_checkpoint(init_gnt_models(seed=0, device="cpu"), path)
    return path


# (argv after the subcommand, whether a GNT renders); the GNT cases on the
# exact preset, where both sides run a float32 network
CLI_RUNS = {
    "eval_geo": (["eval", "--static-mode", "geo", "--dataset", "nvidia_eval_pure_geo"], False),
    "eval_mesh": (["eval", "--render-cfg", "dyn_render_type=mesh", "--perf-preset", "exact"],
                  True),
    "benchmark_st_cvd_dy_cvd": (["benchmark", "--benchmark-type", "st_cvd_dy_cvd"], False),
    "benchmark_render_point": (["benchmark", "--benchmark-type",
                                "st_gnt_masked_attn_dy_cvd_pcl_clean_render_point",
                                "--perf-preset", "exact"], True),
}
# summary means, port against JAX: the geo runs render within 1e-5 of JAX
# (tests/test_torch_port_geo.py); where a GNT renders, the port's float32
# network against JAX's flax float32 network moves about 2.5 % of the
# quantised values by one uint8 level (59 of 2304 on the point bundle),
# which moves PSNR by ~1e-3 dB and SSIM by ~1.5e-4
CLI_TOL = {False: dict(rtol=1e-5, atol=0.0), True: dict(rtol=0.0, atol=5e-3)}


def _split_render_cfg(argv):
    """(argv without --render-cfg, its K=V pairs)."""
    if "--render-cfg" not in argv:
        return list(argv), []
    i = argv.index("--render-cfg")
    return argv[:i] + argv[i + 2:], [argv[i + 1]]


def _run_both_clis(root, ckpt, tmp_path, argv, gnt, jax_flags=()):
    """``argv`` (a subcommand and its flags) through the port's CLI and the
    JAX CLI over one item of the scene at ``root``; the port's outputs
    checked, its summary means held against the JAX CLI's. The JAX
    benchmark subcommand takes no --dataset-arg, so the bundle's dataset
    arguments carry the tiny scene's there."""
    import pgdvs_tpu.configs.benchmarks as jbench

    argv, render_cfg = _split_render_cfg(argv)
    common = ["--data-root", str(root), "--scene-ids", chip_smoke.READER_SCENE,
              "--dataset-arg", f"tgt_height={H}", "n_src_views_spatial=2", "--max-items", "1",
              "--gnt-ckpt", str(ckpt)]
    knobs = ["n_coarse_samples_per_ray=8", "ray_tile=256", "st_render_pcl_pt_radius=0.1",
             "dyn_render_pcl_pt_radius=0.1", *render_cfg]
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    res_t = trun.main([*argv, *common, "--device", "cpu", "--out-dir", str(out_t),
                       "--render-cfg", *knobs])
    _check_outputs(out_t, res_t, 1, vis=argv[0] == "benchmark")
    jcli = _jax_cli()
    with pytest.MonkeyPatch.context() as mp:
        if argv[0] == "benchmark":
            name = argv[argv.index("--benchmark-type") + 1]
            spec = jbench.BENCHMARK_TYPES[name]
            mp.setitem(jbench.BENCHMARK_TYPES, name, {**spec, "dataset_args": {
                **spec.get("dataset_args", {}), "tgt_height": H, "n_src_views_spatial": 2}})
        jcli.main([*argv, *common, *jax_flags, "--gnt-dtype", "float32", "--out-dir", str(out_j),
                   "--render-cfg", *knobs, "use_pallas_gnt=false", "knn_tile=256"])
    res_j = json.loads((out_j / "summary.json").read_text())
    assert res_t["count"] == res_j["count"] == 1
    assert sorted(res_t["mean"]) == sorted(res_j["mean"])
    for key, v in res_j["mean"].items():
        if key != "render_wall_s":
            np.testing.assert_allclose(res_t["mean"][key], v, **CLI_TOL[gnt], err_msg=key)


@pytest.mark.parametrize("case", sorted(CLI_RUNS))
def test_branch_bundles_match_the_jax_cli(scene_root, ckpt, tmp_path, case):
    """The refusals of the geo, mesh, point and st_cvd_dy_cvd cases before
    the point-cloud slice, now runs of one item each: the port's outputs
    (pickle, PNG, summary) and its summary means against the JAX CLI's on
    the same scene."""
    _run_both_clis(scene_root, ckpt, tmp_path, *CLI_RUNS[case])


TRACK_BUNDLES = ("st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir",
                 "st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir_raw_res")
# a TAPIR small enough for the CPU: 2 mixer blocks 16 wide, one PIPs
# iteration, the 256x256 working size of the "tapir" bundle cut to 32x32
TAPIR_KW = dict(num_pips_iter=1, num_mixer_blocks=2, mixer_hidden_dim=16)
TAPIR_RES = (32, 32)
JAX_CHUNK = 256


def _small_haiku_ckpt(hid=TAPIR_KW["mixer_hidden_dim"], blocks=TAPIR_KW["num_mixer_blocks"]):
    """A haiku TAPIR checkpoint in the released layout (tests/test_tapir.py
    builds the full-size one), mixer ``blocks`` deep and ``hid`` wide, its
    kernels normal with variance 1 / fan_in, norm scales 1 and offsets 0."""
    rng = np.random.default_rng(0)
    ckpt = {}

    def conv(path, shape, bias=False, depthwise=False):
        fan_in = shape[0] if depthwise else int(np.prod(shape[:-1]))
        ckpt[path] = {"w": (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)}
        if bias:
            ckpt[path]["b"] = np.zeros(shape[-1] * (shape[1] if depthwise else 1), np.float32)

    def norm(path, c, offset=True):
        ckpt[path] = {"scale": np.ones(c, np.float32)}
        if offset:
            ckpt[path]["offset"] = np.zeros(c, np.float32)

    conv("tapir/~/resnet/~/initial_conv", (7, 7, 3, 64))
    cin = 64
    for g, ch in enumerate((64, 128, 256, 256)):
        for b in range(2):
            base = f"tapir/~/resnet/~/block_group_{g}/~/block_{b}"
            c0 = cin if b == 0 else ch
            norm(f"{base}/~/instancenorm_0", c0)
            conv(f"{base}/~/conv_0", (3, 3, c0, ch))
            norm(f"{base}/~/instancenorm_1", ch)
            conv(f"{base}/~/conv_1", (3, 3, ch, ch))
            if b == 0:
                conv(f"{base}/~/shortcut_conv", (1, 1, c0, ch))
        cin = ch
    conv("tapir/~/cost_volume_regression_1", (3, 3, 1, 16), bias=True)
    conv("tapir/~/cost_volume_regression_2", (3, 3, 16, 1), bias=True)
    conv("tapir/~/cost_volume_occlusion_1", (3, 3, 16, 32), bias=True)
    conv("tapir/~/cost_volume_occlusion_2", (32, 16), bias=True)
    conv("tapir/~/occlusion_out", (16, 2), bias=True)
    conv("tapir/~/pips_mlp_mixer/linear", (4 + 384 + 98, hid), bias=True)
    for i in range(blocks):
        base = f"tapir/~/pips_mlp_mixer/{'block' if i == 0 else f'block_{i}'}"
        norm(f"{base}/layer_norm", hid, offset=False)
        conv(f"{base}/mlp1_up", (3, hid, 4), bias=True, depthwise=True)
        conv(f"{base}/mlp1_up_1", (3, hid * 4, 1), bias=True, depthwise=True)
        norm(f"{base}/layer_norm_1", hid, offset=False)
        conv(f"{base}/mlp2_up", (hid, hid * 4), bias=True)
        conv(f"{base}/mlp2_down", (hid * 4, hid), bias=True)
    norm("tapir/~/pips_mlp_mixer/layer_norm", hid, offset=False)
    conv("tapir/~/pips_mlp_mixer/linear_1", (hid, 388), bias=True)
    return ckpt


@pytest.fixture(scope="module")
def track_scene(tmp_path_factory):
    """An 8-frame scene: the first item's target frame 0 has five real
    backward track frames (the reader's default of five per side)."""
    root = tmp_path_factory.mktemp("cli_track_scene")
    chip_smoke.write_reader_scene(root, raw_hw=(H, W), eval_hw=(H, W), n_frames=8, items=(),
                                  flow_frames=((0, 8),))
    return root


@pytest.mark.parametrize("bundle", TRACK_BUNDLES)
def test_track_bundles_match_the_jax_cli(track_scene, ckpt, tmp_path, monkeypatch, bundle):
    """The refusal of the tapir bundle before the track slice, now a run of
    each tapir bundle (the exact preset, one item) against the JAX CLI: each
    CLI's ``make_tracker`` is handed the small TAPIR above, both loaded from
    one haiku checkpoint by their own loaders, so the CLIs' wiring (tracker
    built on --device and passed through the Evaluator to every render) is
    what is compared; JAX's tracks its query slots in chunks, on one of
    the tests' eight host devices (a mesh of eight would render eight
    copies). The port's tracker saw valid queries."""
    import pgdvs_tpu.configs.benchmarks as jbench
    import pgdvs_tpu.models.tracking.tapir as jtapir
    import pgdvs_tpu_torch.configs.benchmarks as tbench
    import pgdvs_tpu_torch.models.tracking.tapir as ttapir
    from pgdvs_tpu.models.tracking.tapir_port import remap_haiku_params as j_remap
    from pgdvs_tpu_torch.models.tracking.tapir_port import remap_haiku_params
    from test_torch_port_lk import one_thread

    ckpt_tapir = _small_haiku_ckpt()
    j_params = {"params": j_remap(ckpt_tapir)}
    model = ttapir.Tapir(**TAPIR_KW)
    model.load_state_dict(remap_haiku_params(ckpt_tapir))
    seen = []

    def port_tracker(name, device=None):
        tracker = ttapir.TapirTracker(model.eval(), keep_raw_res=name.endswith("raw_res"))

        def track(frames, queries, query_valid=None):
            seen.append(queries.shape[0])
            return tracker(frames, queries, query_valid)

        return track

    def jax_tracker(name):
        """JAX's TapirTracker over chunks of JAX_CHUNK query slots
        (``lax.map``): its one call over all 12 * 24 * 32 slots takes
        tens of GB."""
        import jax

        tracker = jtapir.TapirTracker(params=j_params, model=jtapir.Tapir(**TAPIR_KW),
                                      keep_raw_res=name.endswith("raw_res"))

        def track(frames, queries, query_valid):
            n = queries.shape[0]
            assert n % JAX_CHUNK == 0
            tracks, vis = jax.lax.map(
                lambda qv: tracker(frames, qv[0], qv[1]),
                (queries.reshape(-1, JAX_CHUNK, 3), query_valid.reshape(-1, JAX_CHUNK)))
            return tracks.reshape(n, -1, 2), vis.reshape(n, -1)

        return track

    monkeypatch.setattr(jtapir, "INITIAL_RES", TAPIR_RES)
    monkeypatch.setattr(ttapir, "INITIAL_RES", TAPIR_RES)
    monkeypatch.setattr(jbench, "make_tracker", jax_tracker)
    monkeypatch.setattr(tbench, "make_tracker", port_tracker)
    with one_thread():
        _run_both_clis(track_scene, ckpt, tmp_path,
                       ["benchmark", "--benchmark-type", bundle, "--perf-preset", "exact"],
                       True, jax_flags=["--devices", "1"])
    assert seen and seen[0] > 0


@pytest.mark.parametrize("field", ["bogus=1", "knn_tile=256"])
def test_unknown_render_cfg_field_exits(field):
    args = argparse.Namespace(perf_preset="fast", render_cfg=[field])
    with pytest.raises(SystemExit, match="unknown render_cfg field"):
        trun.build_render_config(args)


@pytest.mark.parametrize("extra,exc,match", [
    (["eval", "--static-mode", "mesh"], SystemExit, None),
    (["eval", "--render-cfg", "dyn_render_type=splat"], ValueError, "dyn_render_type"),
    (["eval", "--static-mode", "geo"], ValueError, "nvidia_eval_pure_geo"),
    (["benchmark", "--benchmark-type", "st_gnt_masked_attn_dy_cvd_pcl_clean_track_cotracker"],
     ValueError, "ROADMAP.md.*track"),
    (["benchmark", "--render-cfg", "dyn_render_track_temporal=always"], ValueError,
     "dyn_render_track_temporal"),
    (["eval", "--dataset", "nvidia_eval_zip"], ValueError, "unknown dataset"),
    (["benchmark", "--render-cfg", "bogus=2"], SystemExit, "unknown render_cfg field"),
])
def test_out_of_port_bundles_raise(tmp_path, extra, exc, match):
    """What the port does not carry (the CoTracker bundle, since the track
    branch landed; the tapir bundles run below), and what is not a mode or a
    reader at all. The refusals of the vis and DyCheck entry points before
    their slice are runs in test_torch_port_vis.py and
    test_torch_port_dycheck.py."""
    with pytest.raises(exc, match=match):
        trun.main([*extra, "--device", "cpu", "--data-root", str(tmp_path)])


@pytest.mark.parametrize("cmd", ["train", "bench"])
def test_subcommands_not_ported_exit(cmd, capsys):
    with pytest.raises(SystemExit):
        trun.main([cmd])
    assert "invalid choice" in capsys.readouterr().err


def test_device_cuda_without_a_card_raises(tmp_path):
    """The CLI runs on the card by default and does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["eval", "--data-root", str(tmp_path)])

