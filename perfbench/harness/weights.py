"""Weights made on the device from the seed, in a few large calls.

One uniform draw covers every tensor of a module's state dict: matrices
and convolution kernels (and their biases) scaled to +-1/sqrt(fan_in), as
torch's default initialisers draw them; norm layers at weight 1, bias 0.
The same state dict loads into the program's module and into the
reference's, so both sides hold the same weights.
"""

from __future__ import annotations

import math

import torch


def seeded_state(shapes, seed: int, device) -> dict:
    """{name: tensor} for ``shapes`` ({name: torch.Size}, a module's state
    dict order) from one ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    total = sum(s.numel() for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at, fan = {}, 0, 1
    for name, shape in shapes.items():
        n = shape.numel()
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            fan = math.prod(shape[1:])
        if len(shape) == 1 and _is_norm(name, shapes):
            out[name] = (torch.ones if leaf == "weight" else torch.zeros)(shape, device=device)
        else:
            out[name] = flat[at:at + n].reshape(shape) / math.sqrt(fan)
        at += n
    return out


def _is_norm(name: str, shapes) -> bool:
    """A 1-d parameter with no matrix of the same layer: a norm's."""
    layer = name.rsplit(".", 1)[0]
    return not any(k.startswith(layer + ".") and len(s) >= 2 for k, s in shapes.items())


def load_seeded(modules, seed: int, device):
    """Fill each module in ``modules`` with a state drawn from ``seed`` + its
    index; returns the state dicts (for the reference)."""
    states = []
    for i, m in enumerate(modules):
        shapes = {k: v.shape for k, v in m.state_dict().items()}
        sd = seeded_state(shapes, seed + 7919 * i, device)
        m.load_state_dict(sd)
        states.append(sd)
    return states
