"""On the card: a short run of each cell at its own sizes is correct, and
the control fails at least one limit. Skips without a card."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness.bench import load_json, run_cell  # noqa: E402

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_correct(card, cell):
    r = run_cell(BENCH, cell, 424242, 8.0, False, device=card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert all(m["value"] > 0 for m in r["metrics"].values()) and len(r["metrics"]) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    from perfbench.tools.readings import readings

    limits = load_json(ROOT / "perfbench" / "limits" / f"{cell}.json")
    row = readings(cell, [434343], device=card, views=2)[0]
    assert all(row["program"][k] <= v for k, v in limits.items()), row
    assert any(row["control"][k] > v for k, v in limits.items()), row
