"""The port's CLI (``python -m pgdvs_tpu_torch.run``), in-process with
``--device cpu``, on a tiny NVIDIA-layout scene (``chip_smoke.
write_reader_scene`` at 24x32, 3 frames, default directory names): ``eval``
(fast preset, patch sampling) and ``benchmark --benchmark-type default``
write pickles, PNGs and a ``summary.json`` of the evaluator's schema;
``build_render_config`` equals the JAX CLI's field by field for the same
argv (presets, overrides, a restored base); an unknown field exits; what
the port does not carry raises, naming its ROADMAP item; ``--device cuda``
without a card raises."""

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


def _jax_build_render_config():
    """The JAX CLI's build_render_config (the repository's run.py)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "pgdvs_jax_cli", pathlib.Path(chip_smoke.__file__).parent / "run.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:  # undo the env default it sets on import
        mp.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        spec.loader.exec_module(mod)
    return mod.build_render_config


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


@pytest.mark.parametrize("field", ["bogus=1", "knn_tile=256"])
def test_unknown_render_cfg_field_exits(field):
    args = argparse.Namespace(perf_preset="fast", render_cfg=[field])
    with pytest.raises(SystemExit, match="unknown render_cfg field"):
        trun.build_render_config(args)


@pytest.mark.parametrize("extra,exc,match", [
    (["eval", "--static-mode", "geo"], ValueError, "static_mode"),
    (["eval", "--dataset", "nvidia_vis"], ValueError, "ROADMAP.md"),
    (["eval", "--render-cfg", "dyn_render_type=mesh"], ValueError, "dyn_render_type"),
    (["benchmark", "--benchmark-type", "st_cvd_dy_cvd"], ValueError, "static_mode"),
    (["benchmark", "--benchmark-type", "st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir"],
     ValueError, "ROADMAP.md.*track"),
    (["benchmark", "--benchmark-type", "visualize_nvidia_max_disp_32"], ValueError,
     "ROADMAP.md.*visualization"),
    (["benchmark", "--benchmark-type", "st_gnt_masked_attn_dy_cvd_pcl_clean_render_point"],
     ValueError, "dyn_render_type"),
    (["benchmark", "--dataset-family", "dycheck_iphone"], ValueError, "dycheck_iphone_eval"),
    (["benchmark", "--render-cfg", "bogus=2"], SystemExit, "unknown render_cfg field"),
])
def test_out_of_port_bundles_raise(tmp_path, extra, exc, match):
    with pytest.raises(exc, match=match):
        trun.main([*extra, "--device", "cpu", "--data-root", str(tmp_path)])


@pytest.mark.parametrize("cmd", ["vis", "train", "bench"])
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

