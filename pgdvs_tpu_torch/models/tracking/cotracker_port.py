"""Load the released CoTracker checkpoint into the port's ``CoTrackerModel``.

The port's own copy of ``pgdvs_tpu.models.tracking.cotracker_port``'s
loader: ``$PGDVS_CKPT_DIR/cotracker/cotracker_stride_4_wind_8.pth`` (the
reference's ``download_ckpts.sh``; never downloaded here) is a torch state
dict, possibly wrapped in a ``"model"`` entry, whose keys are the port's
module names already (``cotracker.CoTrackerModel`` is named after them), so
no array changes layout.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def load_cotracker_checkpoint(path: Optional[str] = None) -> Optional[Dict[str, torch.Tensor]]:
    """The checkpoint at ``path`` (default under ``$PGDVS_CKPT_DIR``) as a
    state dict on the CPU, or None when the file is not there."""
    path = path or os.path.join(os.environ.get("PGDVS_CKPT_DIR", ""), "cotracker",
                                "cotracker_stride_4_wind_8.pth")
    if not os.path.isfile(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd:
        sd = sd["model"]
    return {k: v.detach().float() for k, v in sd.items()}
