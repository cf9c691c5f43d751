"""Carry flax TAPIR parameters into the port's ``Tapir``.

Input is the flax param tree of ``pgdvs_tpu.models.tracking.tapir.Tapir``
given as nested dicts of numpy arrays (``{"params": ...}`` or bare); output
is a torch state dict for ``pgdvs_tpu_torch.models.tracking.tapir.Tapir``:

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

from typing import Dict

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


def tapir_state_dict(flax_params) -> Dict[str, torch.Tensor]:
    """flax Tapir params -> the port's Tapir state dict."""
    tree = flax_params["params"] if "params" in flax_params else flax_params
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if not isinstance(node, dict):
            mods = [HEADS.get(p, p) for p in path[:-1] if p != "GroupNorm_0"]
            name = ".".join(mods)
            leaf = path[-1]
            if leaf == "kernel":
                sd[f"{name}.weight"] = kernel_to_torch(node)
            elif leaf == "scale":
                sd[f"{name}.weight"] = _vector(node)
            elif leaf == "bias":
                sd[f"{name}.bias"] = _vector(node)
            else:
                raise KeyError(f"unknown flax TAPIR leaf {'/'.join(path)}")
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(tree, ())
    return sd
