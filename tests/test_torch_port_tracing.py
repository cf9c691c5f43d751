"""The port's ``utils/tracing.py`` against the JAX package's.

``StageTimer`` and ``MetricLogger`` on one clock (``time.time`` replaced by
the same counter in both modules): equal ``summary()`` dicts (keys,
rounding, counts), equal JSONL records, the TensorBoard mirror where
``torch.utils.tensorboard`` imports; the port's ``sync`` waits on a tree of
tensors. ``profile_trace`` writes a Chrome trace of the enclosed torch ops
on the CPU."""

import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.utils import tracing as jtracing
from pgdvs_tpu_torch.utils import tracing


def _drive(timer, sync):
    for name in ("load", "render", "render", "score", "render"):
        with timer.stage(name, sync=sync if name == "render" else None):
            pass
    return timer.summary()


def test_stage_timer_summary_equals_jax(monkeypatch):
    for module in (tracing, jtracing):
        counter = itertools.count()
        monkeypatch.setattr(module.time, "time",
                            lambda c=counter: 1000.0 + 0.1234567 * next(c))
    got = _drive(tracing.StageTimer(), {"x": torch.ones(2), "y": [torch.zeros(1), 3]})
    want = _drive(jtracing.StageTimer(), {"x": jnp.ones(2)})
    assert got == want
    assert got["render"] == {"total_s": 0.3704, "count": 3, "mean_s": 0.1235}


def test_stage_timer_records_a_raising_stage():
    timer = tracing.StageTimer()
    with pytest.raises(RuntimeError):
        with timer.stage("boom", sync=torch.ones(1)):
            raise RuntimeError("inside")
    assert timer.summary()["boom"]["count"] == 1


def test_synchronize_walks_trees_of_cpu_tensors():
    tracing.synchronize({"a": [torch.ones(1), (torch.zeros(2), "text")], "b": None})


@pytest.mark.parametrize("use_tensorboard", [False, True])
def test_metric_logger_records_equal_jax(tmp_path, monkeypatch, use_tensorboard):
    for module in (tracing, jtracing):
        monkeypatch.setattr(module.time, "time", lambda: 1234.5)
    logs = {}
    for name, module in (("t", tracing), ("j", jtracing)):
        log = module.MetricLogger(tmp_path / name, use_tensorboard=use_tensorboard)
        log.log(1, loss=0.25, lr=5e-4)
        log.log(2, loss=np.float32(0.125).item(), note="text")
        log.close()
        logs[name] = (tmp_path / name / "metrics.jsonl").read_text()
    assert logs["t"] == logs["j"]
    recs = [json.loads(line) for line in logs["t"].splitlines()]
    assert recs == [{"step": 1, "time": 1234.5, "loss": 0.25, "lr": 5e-4},
                    {"step": 2, "time": 1234.5, "loss": 0.125, "note": "text"}]
    if use_tensorboard:
        try:
            import torch.utils.tensorboard  # noqa: F401
        except ImportError:
            assert not (tmp_path / "t" / "tb").exists()
        else:
            assert any((tmp_path / "t" / "tb").iterdir())


def test_metric_logger_appends(tmp_path):
    for step in (1, 2):
        log = tracing.MetricLogger(tmp_path, use_tensorboard=False)
        log.log(step, loss=1.0 / step)
        log.close()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tracing.profile_trace(tmp_path / "trace") as prof:
        y = (x @ x).relu().sum()
    assert torch.isfinite(y)
    trace = json.loads((tmp_path / "trace" / tracing.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
    assert any("mm" in e.key for e in prof.key_averages())
