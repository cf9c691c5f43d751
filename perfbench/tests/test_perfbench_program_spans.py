"""The readers of the program's own spans and counters
(``harness/program_spans.py``): nothing read, and nothing installed, where
the program has no registry; on the CPU, in a traced run of each kind of
cell, the host-only metrics read and the device ones read nothing, and the
registry is off again after the run."""

import pathlib
import sys
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)

from perfbench.harness import program_spans  # noqa: E402
from perfbench.harness.bench import load_json, reader, run_cell  # noqa: E402

BENCH = load_json(ROOT / "BENCHMARK.json")
READERS = ["host_issue_ms", "syncs_per_view", "knn_ms", "softsplat_ms", "h2d_ms",
           "prefetch_ready_pct"]
HOST_ONLY = {"default_fast.nvidia": {"host_issue_ms", "syncs_per_view"},
             "default_fast.nvidia_loop": {"prefetch_ready_pct"}}
SMALL = {"default_fast.nvidia": {
    "config": {"hw": [24, 32], "n_spatial": 3, "n_coarse_samples": 8},
    "traffic": {"n_frames": 6, "n_targets": 2, "rays_checked_per_view": 64}},
    "default_fast.nvidia_loop": {
    "config": {"hw": [48, 64], "n_spatial": 3, "n_coarse_samples": 8},
    "traffic": {"n_frames": 6, "raw_hw": [96, 128], "rays_checked_per_view": 64,
                "items_checked": 1}}}


class Driver:
    def __init__(self):
        self.windows = 0

    def window(self, seconds, on_start):
        on_start()
        self.windows += 1
        return 1, seconds

    def release(self):
        pass


class Ctx:
    def sync(self):
        pass


def test_registry_less_program_reads_nothing(monkeypatch):
    stand_in = types.ModuleType("pgdvs_tpu_torch.utils.tracing")
    stand_in.profile_trace = lambda log_dir: None  # the registry-less module's one function
    monkeypatch.setitem(sys.modules, "pgdvs_tpu_torch.utils.tracing", stand_in)
    ctx, drv = Ctx(), Driver()
    window = drv.window
    for name in READERS:
        reader(name).install(ctx, drv)
    assert drv.window == window
    assert drv.window(1.0, lambda: None) == (1, 1.0)
    assert [reader(name).read(ctx) for name in READERS] == [None] * len(READERS)


@pytest.mark.parametrize("cell", sorted(HOST_ONLY))
def test_traced_cpu_run_reads_the_host_only_metrics(cell):
    from pgdvs_tpu_torch.utils import tracing

    r = run_cell(BENCH, cell, 2 ** 31 + 23, 0.1, True, device="cpu", overrides=SMALL[cell])
    got = set(r["metrics"]) & set(READERS)
    assert got == HOST_ONLY[cell], r["metrics"]
    if cell == "default_fast.nvidia":
        assert r["metrics"]["syncs_per_view"]["value"] == 7.0
        assert r["metrics"]["host_issue_ms"]["value"] > 0.0
    else:
        assert 0.0 <= r["metrics"]["prefetch_ready_pct"]["value"] <= 100.0
    assert not tracing.enabled()
