"""The reference's epipolar samplers, one module per configuration
``sampler``: ``prepare(src, feats, masks)`` once per view, then
``sample(prepared, x, y)`` per ray chunk, giving the sources' rgb and
features [V, n, S, 3 + F] and their interpolated dynamic mask [V, n, S] at
pixel positions x, y [V, n, S] of the full-size image (integer centres)."""

import importlib


def sampler(name):
    """The module ``perfbench/reference/samplers/<name>.py``."""
    try:
        return importlib.import_module(f"perfbench.reference.samplers.{name}")
    except ModuleNotFoundError as err:
        raise ValueError(f"no reference sampler {name!r}") from err
