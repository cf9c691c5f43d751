"""Carry flax tracker parameters into the port's trackers.

Input is the flax param tree of ``pgdvs_tpu.models.tracking.tapir.Tapir``
or ``pgdvs_tpu.models.tracking.cotracker.CoTrackerModel`` given as nested
dicts of numpy arrays (``{"params": ...}`` or bare); output is a torch
state dict for the port's ``tapir.Tapir`` (``tapir_state_dict``) or
``cotracker.CoTrackerModel`` (``cotracker_state_dict``):

  * Conv kernel HWIO -> Conv2d weight OIHW;
  * the mixer's grouped 1-D conv kernels [k, 1, C*4] -> Conv1d weight
    [C*4, 1, k] (both order the output channels c * 4 + m);
  * Dense kernel [in, out] -> Linear weight [out, in];
  * GroupNorm / LayerNorm scale -> weight, bias -> bias;
  * the flax names of the heads (``cost_volume_regression_1`` ...) ->
    the module attributes (``cost_hid1`` ...), ``pips_mlp_mixer`` ->
    ``mixer``; a GroupNorm's ``GroupNorm_0`` scope is dropped.
"""

from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np
import torch

HEADS = {
    "cost_volume_regression_1": "cost_hid1",
    "cost_volume_regression_2": "cost_hid2",
    "cost_volume_occlusion_1": "cost_hid3",
    "cost_volume_occlusion_2": "cost_hid4",
    "occlusion_out": "occ_out",
    "pips_mlp_mixer": "mixer",
}


def kernel_to_torch(arr) -> torch.Tensor:
    """A flax / haiku kernel as the torch module's weight, by rank."""
    a = np.asarray(arr, dtype=np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 3:
        a = a.transpose(2, 1, 0)
    elif a.ndim == 2:
        a = a.T
    else:
        raise ValueError(f"no torch layout for a kernel of shape {a.shape}")
    return torch.from_numpy(np.ascontiguousarray(a))


def _vector(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32).reshape(-1))


def flax_state_dict(flax_params, module_name: Callable, what: str) -> Dict[str, torch.Tensor]:
    """Walk a flax param tree; ``module_name(path)`` names a leaf's torch
    module from its flax scopes."""
    tree = flax_params["params"] if "params" in flax_params else flax_params
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if not isinstance(node, dict):
            name = module_name(path[:-1])
            leaf = path[-1]
            if leaf == "kernel":
                sd[f"{name}.weight"] = kernel_to_torch(node)
            elif leaf == "scale":
                sd[f"{name}.weight"] = _vector(node)
            elif leaf == "bias":
                sd[f"{name}.bias"] = _vector(node)
            else:
                raise KeyError(f"unknown flax {what} leaf {'/'.join(path)}")
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(tree, ())
    return sd


def tapir_state_dict(flax_params) -> Dict[str, torch.Tensor]:
    """flax Tapir params -> the port's Tapir state dict."""
    return flax_state_dict(
        flax_params, lambda path: ".".join(HEADS.get(p, p) for p in path if p != "GroupNorm_0"),
        "TAPIR")


COTRACKER_SCOPES = (
    (r"layer(\d+)_(\d+)", r"layer\1.\2"),
    (r"time_(\d+)", r"time_blocks.\1"),
    (r"space_(\d+)", r"space_blocks.\1"),
    (r"mlp_(fc\d)", r"mlp.\1"),
    (r"downsample", "downsample.0"),
    (r"delta_norm", "norm"),
    (r"(ffeat_updater|vis_predictor)", r"\1.0"),
)


def _cotracker_scope(p: str) -> str:
    for pat, rep in COTRACKER_SCOPES:
        if re.fullmatch(pat, p):
            return re.sub(pat, rep, p)
    return p


def cotracker_state_dict(flax_params) -> Dict[str, torch.Tensor]:
    """flax CoTrackerModel params -> the port's CoTrackerModel state dict
    (the reference's key layout)."""
    return flax_state_dict(
        flax_params, lambda path: ".".join(_cotracker_scope(p) for p in path if p != "conv"),
        "CoTracker")
