"""Each cell's harness at a CPU size: the port's CPU path held against the
reference at the cell's limits, the control (the reference one precision
step down, in the program's place) failing them, each fault of the timed
path failing them, and the result line's keys."""

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
# one thread per test process: the tests run in several workers at once
torch.set_num_threads(1)

from perfbench.harness.bench import load_json, metrics_of, run_cell  # noqa: E402

BENCH = load_json(ROOT / "BENCHMARK.json")
SMALL = {"config": {"hw": [24, 32], "n_spatial": 3, "n_coarse_samples": 8},
         "traffic": {"n_frames": 6, "n_targets": 2, "rays_checked_per_view": 64}}
# the raw frames at twice the evaluation size, as at full size; at 96x128 the
# JPEG frames' error reads as at 288x550 (1/255 at the 90th percentile), at
# smaller sizes the textures put more of it in each pixel
SMALL_LOOP = {"config": {"hw": [96, 128], "n_spatial": 3, "n_coarse_samples": 8},
              "traffic": {"n_frames": 6, "raw_hw": [192, 256], "rays_checked_per_view": 64,
                          "check_every": 1}}
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(cell):
    return SMALL_LOOP if cell.endswith("_loop") else SMALL


def limits(cell):
    return load_json(ROOT / "perfbench" / "limits" / f"{cell}.json")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_cpu(cell, trace):
    r = run_cell(BENCH, cell, 2 ** 31 + 17, 0.1, bool(trace), device="cpu",
                 overrides=small(cell))
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == set(limits(cell)) | {"views_checked"}
    if trace:  # on the CPU only the launch count has something to read
        assert set(r["metrics"]) <= {m["name"] for m in BENCH["per_layer"]}
    else:  # no peak memory off the card
        e2e = {m["name"] for m in metrics_of(BENCH, cell, "end_to_end")}
        assert set(r["metrics"]) == e2e - {"peak_mem_gib"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The control's numbers: at least one over its limit."""
    from perfbench.tools.readings import readings

    rows = readings(cell, [5], fault=None, device="cpu", overrides=small(cell), views=2)
    ctl = rows[0]["control"]
    assert any(ctl[k] > v for k, v in limits(cell).items()), ctl


@pytest.mark.parametrize("fault", ["alter_answer", "half_sources"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(cell, fault):
    r = run_cell(BENCH, cell, 99, 0.1, False, device="cpu", overrides=small(cell), fault=fault)
    assert not r["correct"], r["checks"]


def test_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""
