"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import math
import pathlib
import re
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fit_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "perfbench" / "metrics" / f"{metric['name']}.py").is_file()
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_unique_names():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and LINE.match(cfg["why"]) and LINE.match(cfg["source"])
    assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["reduced"] == cfg["reduced"] == [] and data["source"] == cfg["source"]
    # what the harness finds by the names the file gives
    assert (ROOT / "perfbench" / "reference" / "samplers" / f"{data['sampler']}.py").is_file()
    assert (ROOT / "perfbench" / "costs" / f"{data['gnt_kernel_cost']}.py").is_file()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=CELLS)
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and LINE.match(cell["why"])
    assert cell["chips"] == 1
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "perfbench" / "drivers" / f"{traffic['driver']}.py").is_file()
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    limits = json.loads((ROOT / "perfbench" / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(math.isfinite(v) and v >= 0 for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    """setup_s, one more end-to-end metric and a per-layer metric; each
    per-layer metric's `moves` reported in each of its cells."""
    from perfbench.harness.bench import metrics_of

    e2e = {m["name"] for m in metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = metrics_of(BENCH, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e


def test_pairs_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))

