"""One run of one cell: set-up, the timed window, the traced views, the check.

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json`` (whose
``driver`` names the loop in ``drivers/<driver>.py``), each metric's reader
in ``metrics/<metric>.py``, its limits in ``limits/<workload>.json``.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench, cell, kind):
    """The ``kind`` ("end_to_end" / "per_layer") metrics that ``cell``
    reports: those listing it, and those with no workloads key."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(metric_name):
    return importlib.import_module(f"perfbench.metrics.{metric_name}")


class Ctx:
    """What a run knows; the metric readers read it."""

    def __init__(self, bench, cell, seed, device, t_start, overrides=None):
        self.cell = cell_spec(bench, cell)
        over = overrides or {}
        self.config = {**load_json(PERFBENCH / "configs" / f"{self.cell['config']}.json"),
                       **over.get("config", {})}
        self.traffic = {**load_json(PERFBENCH / "traffic" / f"{self.cell['traffic']}.json"),
                        **over.get("traffic", {})}
        self.limits = load_json(PERFBENCH / "limits" / f"{cell}.json")
        self.seed = seed
        self.device = torch.device(device)
        self.t_start = t_start
        self.views = 0
        self.window_s = None
        self.setup_s = None
        self.peak_window_bytes = None
        self.peak_bytes = None
        self.spans = None
        self.profile = None
        self.launches = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def kernel_launches(cfg):
    """Launches so far of the configuration's GNT kernel entry: the
    ``launches`` count (a number, or one per mode) of ``gnt_kernel_entry`` in
    ``gnt_kernel_module``."""
    kernel = importlib.import_module(cfg["gnt_kernel_module"])
    n = getattr(kernel, cfg["gnt_kernel_entry"]).launches
    return n if isinstance(n, int) else sum(n.values())


def run_cell(bench, cell, seed, seconds, trace, device="cuda", t_start=None, overrides=None,
             fault=None):
    """Run one cell once; returns the result dict (without the printing)."""
    from perfbench.drivers import driver
    from perfbench.harness.check import failed_views

    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Ctx(bench, cell, seed, device, t_start, overrides)
    drv = driver(ctx.traffic["driver"])(ctx, fault=fault)
    drv.setup()
    per_layer = metrics_of(bench, cell, "per_layer") if trace else []
    if trace:
        from perfbench.harness.spans import Spans

        ctx.spans = Spans(ctx.device)
        for m in per_layer:
            install = getattr(reader(m["name"]), "install", None)
            if install is not None:
                install(ctx, drv)
    launches0 = []

    def on_start():
        """The window's start: set-up ends, the peak and the counts restart."""
        if ctx.device.type == "cuda":
            ctx.peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        if ctx.spans is not None:
            ctx.spans.clear()
        launches0.append(kernel_launches(ctx.config))
        ctx.setup_s = time.perf_counter() - ctx.t_start

    ctx.views, ctx.window_s = drv.window(seconds, on_start)
    ctx.launches = kernel_launches(ctx.config) - launches0[0]
    if ctx.device.type == "cuda":
        ctx.peak_window_bytes = torch.cuda.max_memory_allocated(ctx.device)
        ctx.peak_bytes = max(ctx.peak_bytes, ctx.peak_window_bytes)
    if trace:
        from perfbench.harness.trace import profile_views

        ctx.spans.restore()  # the spans cover the window's views only
        ctx.profile = profile_views(drv.profile, int(ctx.traffic["profile_views"]))
    metrics = {}
    for m in (per_layer if trace else metrics_of(bench, cell, "end_to_end")):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    checks = drv.check()
    limits = ctx.limits
    failed = failed_views(checks["per_view"], limits)
    worst = checks["worst"]
    correct = bool(checks["views"] > 0 and failed == 0
                   and all(worst[k] <= limits[k] for k in limits))
    result = {
        "correct": correct,
        "attempted": ctx.views,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(ctx),
    }
    if trace and ctx.profile is not None:
        result["device"]["busy_s"] = ctx.profile["busy_s"]
        result["device"]["window_s"] = ctx.profile["window_s"]
        result["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                               "idle_gaps": ctx.profile["idle_gaps"]}
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    result["checks"]["views_checked"] = {"value": checks["views"], "limit": 1}
    return result


def device_info(ctx):
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
            "count": 1, "memory_peak_bytes": int(ctx.peak_bytes)}
