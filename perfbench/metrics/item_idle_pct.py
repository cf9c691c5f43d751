"""Share of the profiled items of the evaluation loop in which no kernel or
copy ran on the device, %: as ``device_idle_pct``, over whole items (read,
render, copy back, score), so the host's share shows."""

from perfbench.metrics.device_idle_pct import read  # noqa: F401
