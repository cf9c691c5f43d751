"""Tracing, profiling and metric logging (torch).

The port's counterpart of ``pgdvs_tpu.utils.tracing``:

  * ``profile_trace``: a ``torch.profiler`` trace of the enclosed block, with
    CUDA activity where a card is present, written as a Chrome trace into
    ``log_dir`` (open it in chrome://tracing or Perfetto);
  * ``StageTimer``: wall time per named stage, the device of ``sync``
    synchronised before the clock stops;
  * ``MetricLogger``: an append-only JSONL stream of ``{step, time,
    scalars}`` records, mirrored to TensorBoard where
    ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir):
    """Profile the enclosed block (CPU, and CUDA where a card is present)
    and write its Chrome trace to ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` the caller may read after the
    block."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def synchronize(tree) -> None:
    """Wait for the CUDA devices that hold a tensor of ``tree`` (a tensor,
    or dicts / lists / tuples of them); nothing for CPU tensors."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulate wall time per named stage (device-synced at stage end)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.time()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / max(self.counts[name], 1), 4),
            }
            for name in self.totals
        }


class MetricLogger:
    """JSONL metric stream + optional TensorBoard mirror."""

    def __init__(self, log_dir, use_tensorboard: bool = True):
        self.dir = pathlib.Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.dir / "tb"))
            except ImportError:
                pass

    def log(self, step: int, **scalars):
        rec = {"step": step, "time": time.time(), **scalars}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
