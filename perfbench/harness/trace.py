"""The profiled views of a traced run: device busy time, idle gaps, kernels.

``torch.profiler`` (CPU and CUDA activities) over a few views after the
window. The device is busy where any kernel or copy runs (the union of
their intervals); the window is the profiled span, from the first view's
start on the host to the end of the last device operation, on the
profiler's clock. Each of the longest idle gaps is labelled with the
innermost host operation running at its middle.
"""

from __future__ import annotations

import collections

import torch

VIEW = "perfbench.view"
NAME_CHARS = 160  # kernel names cut to this length in the breakdown


def _device_events(events):
    """(start, end, name) of the kernels, copies and sets on the device; the
    device-side mirrors of host annotations left out."""
    return [(e.time_range.start, e.time_range.end, e.name[:NAME_CHARS]) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != VIEW]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile_views(run, n_views, top=10):
    """Profile ``n_views`` views: ``run(n_views, start, view)`` renders them,
    calling ``start()`` just before the first profiled view and wrapping each
    in ``view()`` (a context). Returns None without device events, else a
    dict: busy_s and window_s (the profiled span on the profiler's clock),
    device_ops [[name, seconds]] (most time first) and idle_gaps [[host op,
    seconds]] (longest first), at most ``top`` each."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    started = []

    def start():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.start()
        started.append(True)

    try:
        run(n_views, start, lambda: record_function(VIEW))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        if started:
            prof.stop()
    events = prof.events()
    dev = _device_events(events)
    if not dev:
        return None
    views = [e for e in events if e.name == VIEW and e.device_type != torch.autograd.DeviceType.CUDA]
    lo = min(e.time_range.start for e in views)
    hi = max(max(e.time_range.end for e in views), max(d[1] for d in dev))
    busy = _union([(max(s, lo), min(e, hi)) for s, e, _ in dev if e > lo and s < hi])
    per_name = collections.Counter()
    for s, e, name in dev:
        per_name[name] += (e - s) * 1e-6
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:top]
    host_ops = [(e.time_range.start, e.time_range.end, e.name) for e in events
                if e.device_type == torch.autograd.DeviceType.CPU and e.name != VIEW
                and not e.name.startswith("Activity Buffer")]
    idle = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        running = [op for op in host_ops if op[0] <= mid <= op[1]]
        label = min(running, key=lambda op: op[1] - op[0])[2] if running else "no host op"
        idle.append([label, (e - s) * 1e-6])
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "device_ops": [[n, s] for n, s in per_name.most_common(top)],
        "idle_gaps": idle,
    }
