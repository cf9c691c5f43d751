"""Checkpoint save / restore and experiment resume (torch).

The port's counterpart of ``pgdvs_tpu.engines.checkpoint``, the reference's
two mechanisms:
  * model checkpoints with module filtering (``modules_not_to_save``: the
    frozen submodules are never written): one ``state.pt`` per checkpoint
    directory, ``torch.save`` of ``{"params": {name: state dict},
    "opt_state": ...}``;
  * experiment resume: the run directory keeps the resolved configuration
    (``config.json``, the JAX package's schema) and the checkpoints named
    ``epoch_{E}-step_{S}``, the newest ``keep`` of them retained.
"""

from __future__ import annotations

import json
import logging
import pathlib
import re
import shutil
from typing import Optional, Sequence

import torch
from torch import nn

LOGGER = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"epoch_(\d+)-step_(\d+)")
STATE_FILE = "state.pt"


def _state(v):
    return v.state_dict() if isinstance(v, (nn.Module, torch.optim.Optimizer)) else v


def save_checkpoint(ckpt_dir, params: dict, opt_state=None, epoch: int = 0, step: int = 0,
                    modules_not_to_save: Sequence[str] = (), keep: int = -1):
    """Save params (+ optimizer state) under ``epoch_{E}-step_{S}/state.pt``.

    params: {name: module or state dict}; modules_not_to_save: names left
    out (the reference leaves out the frozen static / dynamic renderers);
    opt_state: an optimizer or its state dict; keep: retain only the newest
    N checkpoints (-1 = all). Returns the checkpoint directory.
    """
    ckpt_dir = pathlib.Path(ckpt_dir).absolute()
    path = ckpt_dir / f"epoch_{epoch}-step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    payload = {"params": {k: _state(v) for k, v in params.items()
                          if k not in modules_not_to_save}}
    if opt_state is not None:
        payload["opt_state"] = _state(opt_state)
    torch.save(payload, path / STATE_FILE)
    if keep > 0:
        clean_up_checkpoints(ckpt_dir, keep)
    return path


def list_checkpoints(ckpt_dir):
    """[(epoch, step, path)] of the checkpoint directories, oldest first."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    found = []
    for p in ckpt_dir.iterdir():
        m = _CKPT_RE.fullmatch(p.name)
        if m:
            found.append((int(m.group(1)), int(m.group(2)), p))
    return sorted(found)


def clean_up_checkpoints(ckpt_dir, keep: int):
    """Retention: keep the newest N (the reference's clean_up_ckpt)."""
    for _, _, p in list_checkpoints(ckpt_dir)[:-keep]:
        LOGGER.info("removing old checkpoint %s", p)
        shutil.rmtree(p)


def restore_checkpoint(ckpt_dir, template: Optional[dict] = None,
                       epoch: Optional[int] = None, map_location="cpu"):
    """Restore the newest checkpoint (or the newest of ``epoch``).

    template: optional {name: module}; each module whose name the
    checkpoint holds gets its state loaded. Returns (payload, (epoch, step)),
    or (None, None) when there is no checkpoint; FileNotFoundError when
    ``epoch`` has none.
    """
    found = list_checkpoints(ckpt_dir)
    if not found:
        return None, None
    if epoch is not None:
        found = [f for f in found if f[0] == epoch]
        if not found:
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} in {ckpt_dir}")
    e, s, path = found[-1]
    payload = torch.load(path / STATE_FILE, map_location=map_location, weights_only=True)
    for name, module in (template or {}).items():
        if name in payload["params"]:
            module.load_state_dict(payload["params"][name])
    return payload, (e, s)


def save_run_config(run_dir, cfg_dict: dict):
    """Persist the resolved run configuration (the reference saves
    all.yaml)."""
    run_dir = pathlib.Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "config.json", "w") as f:
        json.dump(cfg_dict, f, indent=2, default=str)


def load_run_config(run_dir):
    p = pathlib.Path(run_dir) / "config.json"
    if not p.exists():
        return None
    with open(p) as f:
        return json.load(f)
