"""Load the released haiku TAPIR checkpoint into the port's ``Tapir``.

The port's own copy of ``pgdvs_tpu.models.tracking.tapir_port``: the
deepmind checkpoint (``$PGDVS_CKPT_DIR/tapnet/tapir_checkpoint_panning.npy``,
never downloaded) is a flat ``{haiku_module_path: {param: array}}`` dict with
paths like ``tapir/~/resnet/~/block_group_0/~/block_0/conv_0``; each path is
mapped straight onto the port's module names and each array into its torch
layout:

  * Conv2D ``w`` [kh, kw, in, out] -> OIHW;
  * Linear ``w`` [in, out] -> [out, in];
  * DepthwiseConv1D ``w`` [k, C, mult] -> [C * mult, 1, k] (output channel
    c * mult + m, as torch's grouped Conv1d orders them);
  * ``scale`` / ``offset`` -> weight / bias.

Entries that match no module raise ValueError listing every one.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from pgdvs_tpu_torch.models.tracking.params_from_jax import HEADS, _vector, kernel_to_torch

MIXER_LAYERS = ("layer_norm", "layer_norm_1", "mlp1_up", "mlp1_up_1", "mlp2_up", "mlp2_down")
RESNET_LAYERS = ("conv_0", "conv_1", "shortcut_conv", "instancenorm_0", "instancenorm_1")


def _norm_path(path: str) -> str:
    return "/".join(p for p in path.split("/") if p not in ("~", "tapir"))


def _map_path(path: str) -> Optional[str]:
    """A normalized haiku path -> the port's module name, or None."""
    parts = path.split("/")
    if parts[0] == "resnet":
        if parts[-1] == "initial_conv":
            return "resnet.initial_conv"
        g = next((p for p in parts if p.startswith("block_group_")), None)
        b = next((p for p in parts if p.startswith("block_") and "group" not in p), None)
        if g is None or b is None or parts[-1] not in RESNET_LAYERS:
            return None
        return f"resnet.group_{int(g.split('_')[-1])}_block_{int(b.split('_')[-1])}.{parts[-1]}"
    if parts[-1] in HEADS and parts[-1] != "pips_mlp_mixer":
        return HEADS[parts[-1]]
    if parts[0] == "pips_mlp_mixer":
        if len(parts) == 2 and parts[1] in ("linear", "linear_1", "layer_norm"):
            return f"mixer.{parts[1]}"
        blk = parts[1]
        if blk == "block":
            blk = "block_0"
        elif blk.startswith("block_"):
            blk = f"block_{int(blk.split('_')[-1])}"
        else:
            return None
        if parts[-1] in MIXER_LAYERS:
            return f"mixer.{blk}.{parts[-1]}"
    return None


def remap_haiku_params(ckpt: Dict[str, dict]) -> Dict[str, torch.Tensor]:
    """haiku ``{path: {param: array}}`` -> the port's Tapir state dict."""
    sd: Dict[str, torch.Tensor] = {}
    unmatched = []
    for raw_path, vals in ckpt.items():
        dest = _map_path(_norm_path(raw_path))
        if dest is None:
            unmatched.append(raw_path)
            continue
        for pname, arr in vals.items():
            arr = np.asarray(arr)
            if pname == "w":
                if dest.rsplit(".", 1)[-1].startswith("mlp1_up"):
                    arr = arr.reshape(arr.shape[0], 1, -1)
                sd[f"{dest}.weight"] = kernel_to_torch(arr)
            elif pname in ("b", "offset"):
                sd[f"{dest}.bias"] = _vector(arr)
            elif pname == "scale":
                sd[f"{dest}.weight"] = _vector(arr)
            else:
                unmatched.append(f"{raw_path}:{pname}")
    if unmatched:
        raise ValueError("unmatched TAPIR checkpoint entries (format drift?):\n"
                         + "\n".join(sorted(unmatched)))
    return sd


def load_tapir_checkpoint(path: Optional[str] = None) -> Optional[Dict[str, torch.Tensor]]:
    """The checkpoint at ``path`` (default under ``$PGDVS_CKPT_DIR``) as a
    state dict, or None when the file is not there."""
    path = path or os.path.join(os.environ.get("PGDVS_CKPT_DIR", ""), "tapnet",
                                "tapir_checkpoint_panning.npy")
    if not os.path.isfile(path):
        return None
    ckpt = np.load(path, allow_pickle=True).item()
    if "params" in ckpt:
        ckpt = ckpt["params"]
    return remap_haiku_params(ckpt)
