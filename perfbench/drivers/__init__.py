"""The loops that drive the program, one module per traffic ``driver``,
each defining ``Driver(ctx, fault=None)`` with:

* ``setup()``: the program from the configuration, the traffic, warm-up;
* ``window(seconds, on_start)``: the timed views; returns (completed, seconds);
* ``n_distinct()`` and ``view(i)``: distinct views one by one (the readings);
* ``profile(n, start, view)``: n more views under the profiler;
* ``release()``: the program's state freed;
* ``check(control=False)``: {"views", "per_view", "worst"[, "control"]}.

``in_memory``: ``render_novel_view`` over views held on the device;
``eval_loop``: ``Evaluator.run`` over a scene written in the NVIDIA layout.
"""

import importlib


def driver(name):
    """The ``Driver`` class of ``perfbench/drivers/<name>.py``."""
    return importlib.import_module(f"perfbench.drivers.{name}").Driver
