"""Share of the profiled views in which no kernel or copy ran on the
device, %: 1 - busy / window from ``torch.profiler`` (``harness/trace.py``)."""


def read(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
