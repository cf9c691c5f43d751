"""Load princeton-vl RAFT checkpoints (``raft-things.pth``) into the port's
``raft.RAFT``.

The port's own copy of ``pgdvs_tpu.models.flow.raft_port``'s search: the
file is ``$PGDVS_CKPT_DIR/raft/models/raft-things.pth`` unless a path is
given, and a missing file gives None. The checkpoint is a torch state dict
with a DataParallel ``module.`` prefix whose names are the port's module
names already (``raft.RAFT`` is named after them): the loader strips the
prefix, drops BatchNorm's ``num_batches_tracked`` counters and the context
encoder's ``norm3`` entries (princeton-vl registers that norm twice, as
``norm3`` and as ``downsample.1``; the values are one tensor), and loads
the rest strictly. ``raft_params_from_jax`` is the inverse of the JAX
package's ``port_raft``: flax params to such a state dict (for the tests).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from pgdvs_tpu_torch.models.flow.raft import RAFT, RAFTFlow


def _checkpoint_path(path: Optional[str]) -> str:
    return path or os.path.join(os.environ.get("PGDVS_CKPT_DIR", ""), "raft", "models",
                                "raft-things.pth")


def raft_state_dict(sd) -> Dict[str, torch.Tensor]:
    """A princeton-vl state dict (``module.``-prefixed or not) -> the keys
    ``RAFT.load_state_dict`` takes, float32 on the CPU."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if ".norm3." in k and k.replace(".norm3.", ".downsample.1.") in sd:
            continue
        out[k] = torch.as_tensor(np.asarray(v)).float()
    return out


def load_raft_checkpoint(path: Optional[str] = None, device="cuda") -> Optional[RAFT]:
    """RAFT with the checkpoint at ``path`` (default under
    ``$PGDVS_CKPT_DIR``) in eval mode on ``device``, or None when the file
    is not there."""
    path = _checkpoint_path(path)
    if not os.path.isfile(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = RAFT()
    model.load_state_dict(raft_state_dict(sd))
    return model.eval().to(device)


def make_raft_flow(ckpt_path: Optional[str] = None, iters: int = 32, device="cuda") -> RAFTFlow:
    """``RAFTFlow`` on ``device`` (default the card) with the released
    checkpoint; raises FileNotFoundError when it is not there (no
    random-weights fallback, as in the JAX package)."""
    model = load_raft_checkpoint(ckpt_path, device=device)
    if model is None:
        raise FileNotFoundError(
            "RAFT checkpoint not found; set PGDVS_CKPT_DIR with "
            "raft/models/raft-things.pth"
        )
    return RAFTFlow(model, iters=iters)


def _conv(p, name, sd):
    sd[f"{name}.weight"] = np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{name}.bias"] = np.asarray(p["conv"]["bias"])


def _bn(p, name, sd):
    for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
        sd[f"{name}.{dst}"] = np.asarray(p[src])


def _encoder(p, prefix, sd):
    _conv(p["conv1"], f"{prefix}.conv1", sd)
    _conv(p["conv2"], f"{prefix}.conv2", sd)
    if "norm1" in p:
        _bn(p["norm1"], f"{prefix}.norm1", sd)
    for li in (1, 2, 3):
        for bi in (0, 1):
            blk, t = p[f"layer{li}_{bi}"], f"{prefix}.layer{li}.{bi}"
            _conv(blk["conv1"], f"{t}.conv1", sd)
            _conv(blk["conv2"], f"{t}.conv2", sd)
            for name in ("norm1", "norm2"):
                if name in blk:
                    _bn(blk[name], f"{t}.{name}", sd)
            if "downsample" in blk:
                _conv(blk["downsample"], f"{t}.downsample.0", sd)
                if "norm3" in blk:
                    _bn(blk["norm3"], f"{t}.downsample.1", sd)


def raft_params_from_jax(flax_params) -> Dict[str, torch.Tensor]:
    """The JAX package's flax RAFT params (``{"params": ...}`` or the inner
    dict) -> the port's state dict: kernels [kh, kw, in, out] to
    [out, in, kh, kw], eval BatchNorm's scale / mean / var to weight /
    running_mean / running_var."""
    p = flax_params.get("params", flax_params)
    sd = {}
    _encoder(p["fnet"], "fnet", sd)
    _encoder(p["cnet"], "cnet", sd)
    ub = p["update_block"]
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _conv(ub["encoder"][name], f"update_block.encoder.{name}", sd)
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        _conv(ub["gru"][name], f"update_block.gru.{name}", sd)
    _conv(ub["flow_head_conv1"], "update_block.flow_head.conv1", sd)
    _conv(ub["flow_head_conv2"], "update_block.flow_head.conv2", sd)
    _conv(ub["mask_conv1"], "update_block.mask.0", sd)
    _conv(ub["mask_conv2"], "update_block.mask.2", sd)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
