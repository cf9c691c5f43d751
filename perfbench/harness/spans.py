"""Spans the benchmark records around the program's layers, from outside.

A span wraps the attribute that a caller looks up (a module-level function
of the program, or a method on one of the benchmark's own objects) or
hooks a module's forward. Device spans record a pair of CUDA events on the
current stream (no synchronisation; read once the window has closed), host
spans the host clock. Installed only in a traced run; ``restore`` puts
every attribute back.
"""

from __future__ import annotations

import functools
import importlib
import time

import torch


class Spans:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device_pairs = {}   # name -> [(start event, end event)]
        self.host_s = {}         # name -> [seconds]
        self._restore = []

    def _events(self):
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def _timed(self, name, fn, on_device):
        if on_device and self.cuda:
            pairs = self.device_pairs.setdefault(name, [])

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                start, end = self._events()
                start.record()
                out = fn(*a, **kw)
                end.record()
                pairs.append((start, end))
                return out
        else:
            times = self.host_s.setdefault(name, [])

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                times.append(time.perf_counter() - t0)
                return out
        return wrapper

    def wrap(self, owner, attr, name, on_device=True):
        """Time every call of ``owner.attr`` (owner: an object, or a module
        path) as span ``name``; a second wrap of the same name is a no-op."""
        if name in self.device_pairs or name in self.host_s:
            return
        if isinstance(owner, str):
            owner = importlib.import_module(owner)
        had = attr in vars(owner) if not isinstance(owner, type) else True
        old = getattr(owner, attr)
        setattr(owner, attr, self._timed(name, old, on_device))
        self._restore.append((owner, attr, old, had))

    def wrap_generator(self, module, attr, name):
        """Host time spent in each ``next()`` of the generators that
        ``module.attr`` returns: how long the caller waits for an item."""
        if name in self.host_s:
            return
        mod = importlib.import_module(module)
        old = getattr(mod, attr)
        times = self.host_s.setdefault(name, [])

        @functools.wraps(old)
        def wrapper(*a, **kw):
            it = old(*a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                times.append(time.perf_counter() - t0)
                yield item

        setattr(mod, attr, wrapper)
        self._restore.append((mod, attr, old, True))

    def hook(self, module: torch.nn.Module, name):
        """A device span around every forward of ``module``."""
        if name in self.device_pairs or not self.cuda:
            return
        pairs = self.device_pairs.setdefault(name, [])
        pending = []

        def pre(_m, _inp):
            start, end = self._events()
            start.record()
            pending.append((start, end))

        def post(_m, _inp, _out):
            start, end = pending.pop()
            end.record()
            pairs.append((start, end))

        handles = (module.register_forward_pre_hook(pre), module.register_forward_hook(post))
        self._restore.append((handles, None, None, None))

    def clear(self):
        """Forget what was recorded (the spans stay installed)."""
        for pairs in self.device_pairs.values():
            pairs.clear()
        for times in self.host_s.values():
            times.clear()

    def device_ms(self, name):
        """Summed milliseconds of a device span (after a synchronize), or
        None where it never ran."""
        pairs = self.device_pairs.get(name)
        if not pairs:
            return None
        return float(sum(a.elapsed_time(b) for a, b in pairs))

    def host_ms(self, name):
        times = self.host_s.get(name)
        return float(sum(times) * 1e3) if times else None

    def count(self, name):
        return len(self.host_s.get(name) or self.device_pairs.get(name) or ())

    def restore(self):
        for owner, attr, old, had in reversed(self._restore):
            if attr is None:
                for h in owner:
                    h.remove()
            elif had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._restore.clear()
