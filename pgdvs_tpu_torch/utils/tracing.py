"""The port's spans and counters, and ``torch.profiler`` traces.

One registry per process, off until ``enable()``:

  * ``span(name, device=False, stream=None, root_id=None)``: a context
    manager. Off, it returns one shared no-op object after a single check
    of a module global: no allocation, no clock, no event. On, it reads
    the host clock (``time.perf_counter_ns``) first on entry and last on
    exit, so its host time holds its own cost, and takes its parent from
    the thread's stack of open spans. A span given a
    ``root_id`` is a root (``view``, ``eval.item``): every span opened
    under it carries that id. On the main thread, the one that issues the
    device work, the span also opens ``torch.profiler.record_function``
    under its name (the root's id in its args), so inside a profiler
    session it sits on the device trace's clock around the kernels it
    launched; spans of other threads (the reader's workers) keep to the
    host clock. ``device``, the torch.device the work runs on, adds on a
    card a pair of CUDA timing events on ``stream`` (default: the current
    one), recorded without a synchronisation; a pair is folded into the
    totals once its end has completed, so memory stays bounded. On the
    CPU the device time is None.
  * ``count(name, n=1)``: a counter.
  * ``summary()``: per span name its count, host ms, device ms, self host
    ms (its time less the part its direct children cover) and parents;
    the counters; per root name its count, the spans opened under it and
    the last ``ROOT_RECORDS`` (id, host ms, device ms) records.
    ``write_summary(path)`` writes it as JSON; nothing else is written.
  * ``reset()`` forgets everything recorded; spans open across it are not
    recorded when they close.
  * ``profile_trace(log_dir)``: a ``torch.profiler`` Chrome trace of the
    enclosed block.

``always=True`` records a span or a counter while the registry is off:
for what runs once per process (``kernels/_build.load_library``).
"""

from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import threading
import time

import torch

TRACE_FILE = "trace.json"
SUMMARY_FILE = "spans.json"
ROOT_RECORDS = 4096
FOLD_AT = 512  # pending event pairs that trigger a fold

_enabled = False
_generation = 0
_lock = threading.Lock()
_local = threading.local()
_spans: dict = {}
_counters: collections.Counter = collections.Counter()
_roots: dict = {}
_pending: list = []  # (start event, end event, [dicts whose device_ms it adds to])


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Forget every span, counter and root record."""
    global _generation
    with _lock:
        _generation += 1
        _spans.clear()
        _counters.clear()
        _roots.clear()
        _pending.clear()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str, device=None, stream=None, root_id=None, always: bool = False):
    """A span of ``name`` (see the module's note); the shared no-op while
    the registry is off."""
    if not (_enabled or always):
        return NO_SPAN
    return _Span(name, device, stream, root_id)


def count(name: str, n: int = 1, always: bool = False) -> None:
    if _enabled or always:
        with _lock:
            _counters[name] += n


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "device", "stream", "root_id", "parent", "roots", "t0",
                 "children_ns", "events", "profiled", "generation")

    def __init__(self, name, device, stream, root_id):
        self.name, self.device, self.stream, self.root_id = name, device, stream, root_id

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        roots = self.parent.roots if self.parent is not None else ()
        if self.root_id is not None:
            roots = roots + (self,)
        self.roots = roots
        self.children_ns = 0
        self.generation = _generation
        self.profiled = None
        if threading.current_thread() is threading.main_thread():
            args = str(roots[-1].root_id) if roots else None
            self.profiled = torch.profiler.record_function(self.name, args)
            self.profiled.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.profiled is not None:
            self.profiled.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        dur = t1 - self.t0
        if self.parent is not None:
            self.parent.children_ns += dur
        if self.generation == _generation:
            _record(self, dur)
        return False


def _totals(table, name):
    t = table.get(name)
    if t is None:
        t = table[name] = {"count": 0, "host_ns": 0, "self_ns": 0, "device_ms": None,
                           "parents": collections.Counter()}
    return t


def _record(s: _Span, dur: int) -> None:
    with _lock:
        if s.generation != _generation:
            return
        t = _totals(_spans, s.name)
        t["count"] += 1
        t["host_ns"] += dur
        t["self_ns"] += dur - s.children_ns
        t["parents"][s.parent.name if s.parent is not None else None] += 1
        targets = [t]
        for r in s.roots:
            if r is s or r.generation != _generation:
                continue
            root = _root(r.name)
            w = _totals(root["within"], s.name)
            w["count"] += 1
            w["host_ns"] += dur
            targets.append(w)
        if s.root_id is not None:
            root = _root(s.name)
            root["count"] += 1
            rec = {"id": s.root_id, "host_ms": dur * 1e-6, "device_ms": None}
            root["records"].append(rec)
            targets.append(rec)
        if s.events is not None:
            _pending.append((s.events[0], s.events[1], targets))
            if len(_pending) >= FOLD_AT:
                _fold()


def _root(name):
    r = _roots.get(name)
    if r is None:
        r = _roots[name] = {"count": 0, "within": {},
                            "records": collections.deque(maxlen=ROOT_RECORDS)}
    return r


def _fold() -> None:
    """Add the device time of every completed event pair (under the lock)."""
    keep = []
    for start, end, targets in _pending:
        if end.query():
            ms = start.elapsed_time(end)
            for t in targets:
                t["device_ms"] = (t["device_ms"] or 0.0) + ms
        else:
            keep.append((start, end, targets))
    _pending[:] = keep


def _ms(t):
    out = {"count": t["count"], "host_ms": t["host_ns"] * 1e-6, "device_ms": t["device_ms"]}
    if "self_ns" in t and t["parents"]:
        out["self_host_ms"] = t["self_ns"] * 1e-6
        out["parent"] = t["parents"].most_common(1)[0][0]
        out["parents"] = dict(t["parents"])
    return out


def summary() -> dict:
    """{"spans": {name: {count, host_ms, device_ms, self_host_ms, parent,
    parents}}, "counters": {name: n}, "roots": {name: {count, within:
    {name: {count, host_ms, device_ms}}, records: [[id, host_ms,
    device_ms]]}}}; device times of event pairs still running are left
    out (synchronise first to have them all)."""
    with _lock:
        _fold()
        return {
            "spans": {k: _ms(v) for k, v in _spans.items()},
            "counters": dict(_counters),
            "roots": {k: {"count": r["count"],
                          "within": {n: _ms(w) for n, w in r["within"].items()},
                          "records": [[x["id"], x["host_ms"], x["device_ms"]]
                                      for x in r["records"]]}
                      for k, r in _roots.items()},
        }


def write_summary(path) -> None:
    """``summary()`` as JSON at ``path``, after a synchronise of the card
    (so every event pair is folded)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    path.write_text(json.dumps(summary(), indent=1, default=str))


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
