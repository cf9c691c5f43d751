"""Load the reference GNT checkpoint into the port's modules.

The released checkpoint (``gnt/model_720000.pth``, the reference's
``download_ckpts.sh:21-23``) holds ``{"feature_net", "net_coarse"[,
"net_fine"], ...}`` torch state dicts. The port's ``ResUNet`` and ``GNT``
carry the reference's submodule names (``models/gnt/feature_net.py``,
``models/gnt/network.py``), except that ``GNT.q_fcs`` holds one entry per
even block: the port's ``q_fcs.{p}`` is the reference's ``q_fcs.{2p}``
(the odd entries are identities there, with no parameters). So loading is
a key check and ``load_state_dict``.

As the JAX package's ``load_gnt_checkpoint`` does, it reads
``feature_net`` and ``net_coarse`` and ignores everything else
(``net_fine``, optimizer and scheduler state, keys the modules do not
hold); a key the modules hold and the checkpoint lacks raises, naming it.
Location: a path, or ``$PGDVS_CKPT_DIR/gnt/model_720000.pth``; None when no
file is found, so that callers can use random weights.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

_Q_FC = re.compile(r"q_fcs\.(\d+)\.(.*)")


def reference_key(key: str) -> str:
    """The reference checkpoint's name of the port's parameter ``key``."""
    m = _Q_FC.fullmatch(key)
    return f"q_fcs.{2 * int(m.group(1))}.{m.group(2)}" if m else key


def port_state_dict(module: torch.nn.Module, ref_sd: Dict[str, torch.Tensor],
                    what: str) -> Dict[str, torch.Tensor]:
    """``module``'s state dict taken from the reference state dict
    ``ref_sd``; KeyError naming every key of ``what`` that it lacks."""
    keys = list(module.state_dict())
    missing = [reference_key(k) for k in keys if reference_key(k) not in ref_sd]
    if missing:
        raise KeyError(f"checkpoint {what!r} lacks {len(missing)} key(s): {missing}")
    return {k: ref_sd[reference_key(k)] for k in keys}


def load_gnt_checkpoint(path: Optional[str] = None, depth: int = 8, device="cuda"):
    """(feature_net, gnt) in eval mode on ``device`` with the checkpoint's
    weights, or None when the file is not there."""
    path = path or os.path.join(os.environ.get("PGDVS_CKPT_DIR", ""), "gnt",
                                "model_720000.pth")
    if not os.path.isfile(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    fnet, gnt = init_gnt_models(device="cpu", depth=depth)
    fnet.load_state_dict(port_state_dict(fnet, ckpt["feature_net"], "feature_net"))
    gnt.load_state_dict(port_state_dict(gnt, ckpt["net_coarse"], "net_coarse"))
    return fnet.to(device).eval(), gnt.to(device).eval()
