"""The check against faults that the timed path's own faults do not reach:
outlier decisions the program gets wrong, decisions the harness cannot
read, and a reader that assembles the wrong target."""

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
# one thread per test process: the tests run in several workers at once
torch.set_num_threads(1)

from perfbench.harness.bench import load_json, run_cell  # noqa: E402

BENCH = load_json(ROOT / "BENCHMARK.json")
SMALL = {"config": {"hw": [24, 32], "n_spatial": 3, "n_coarse_samples": 8},
         "traffic": {"n_frames": 6, "n_targets": 2, "rays_checked_per_view": 64}}
SMALL_LOOP = {"config": {"hw": [96, 128], "n_spatial": 3, "n_coarse_samples": 8},
              "traffic": {"n_frames": 6, "raw_hw": [192, 256], "rays_checked_per_view": 64,
                          "check_every": 1}}


def test_wrong_outlier_decisions_fail(monkeypatch):
    """The program drops a sixth of the points it keeps: the decisions differ
    from the rule off the ties, and the dynamic layer from the reference's."""
    from pgdvs_tpu_torch.renderers import dynamic

    orig = dynamic.statistical_outlier_mask

    def drops_some(*a, **kw):
        keep, thres = orig(*a, **kw)
        kept = torch.nonzero(keep, as_tuple=True)[0]
        keep = keep.clone()
        keep[kept[::6]] = False
        return keep, thres

    monkeypatch.setattr(dynamic, "statistical_outlier_mask", drops_some)
    r = run_cell(BENCH, "default_fast.nvidia", 31, 0.1, False, device="cpu", overrides=SMALL)
    assert not r["correct"]
    assert r["checks"]["dyn_rule"]["value"] > 0.1
    assert r["checks"]["dyn_rgb"]["value"] > r["checks"]["dyn_rgb"]["limit"]


def test_uncaptured_decisions_raise(monkeypatch):
    """Outlier removal on, and the program's means and decisions not read
    where it looks them up: the check refuses rather than passing."""
    from perfbench.harness import check

    monkeypatch.setattr(check, "capture_outlier_decisions", lambda drv: ())
    with pytest.raises(RuntimeError, match="not captured"):
        run_cell(BENCH, "default_fast.nvidia", 31, 0.1, False, device="cpu", overrides=SMALL)


@pytest.mark.parametrize("fault", ["target_frame", "target_mask", "target_time",
                                   "source_rows"])
def test_reader_faults_fail(monkeypatch, fault):
    """The reader assembles another frame as the target, flips the target's
    evaluation mask at one pixel, gives the target the next frame's time, or
    blanks the bottom twentieth of one source: the loop cell is not correct."""
    from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset

    orig = NvidiaEvalDataset.__getitem__

    def faulty(self, i):
        item = orig(self, i)
        if fault == "target_frame":
            item["rgb_tgt"] = item["rgb_src_temporal"][0].copy()
        elif fault == "target_mask":
            m = item["misc"]["tgt_dyn_mask"].copy()
            m[0, 0] = 1.0 - m[0, 0]
            item["misc"] = {**item["misc"], "tgt_dyn_mask": m}
        elif fault == "target_time":
            item["time_tgt"] = item["time_tgt"] + 1.0
        else:
            rgb = item["rgb_src_spatial"].copy()
            rgb[0, -rgb.shape[1] // 20:] = 0.0
            item["rgb_src_spatial"] = rgb
        return item

    monkeypatch.setattr(NvidiaEvalDataset, "__getitem__", faulty)
    r = run_cell(BENCH, "default_fast.nvidia_loop", 2 ** 31 + 17, 0.1, False, device="cpu",
                 overrides=SMALL_LOOP)
    assert not r["correct"], r["checks"]


def test_tie_reach_covers_own_and_landing_pixels():
    """A point's decision reaches its own pixel and the four around where it
    lands in the target view, and nothing else."""
    from perfbench.reference import render

    h, w = 6, 8
    cam = np.concatenate([[h, w], np.eye(4).ravel(), np.eye(4).ravel()]).astype(np.float32)
    cam[2], cam[7], cam[4], cam[8] = 4.0, 4.0, 3.5, 2.5  # fx, fy, cx, cy
    data = {"rgb_src_temporal": torch.zeros((2, h, w, 3)),
            "flat_cam_tgt": torch.from_numpy(cam)}
    points = torch.ones((h * w, 3))
    points[:, 0], points[:, 1] = 0.3, 0.2  # lands at (4.7, 3.3)
    which = torch.zeros(h * w, dtype=torch.bool)
    which[0] = True
    reach = render.splat_reach(data, points, which).reshape(h, w)
    want = torch.zeros((h, w), dtype=torch.bool)
    want[0, 0] = True
    want[3:5, 4:6] = True
    assert torch.equal(reach, want)
