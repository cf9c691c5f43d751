"""Forward-backward flow cycle consistency (occlusion detection) in torch.

Counterpart of ``pgdvs_tpu.preprocess.flow_consistency`` (the reference's
``compute_occlusion``, ``pgdvs/preprocess/common.py:314-325``): chain the
forward flow with a bilinear lookup of the backward flow; the round-trip
coordinate error marks occluded pixels. This makes the ``coord_diff``
arrays the readers threshold into occlusion masks. Runs on the device of
its inputs.
"""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.core.interpolate import bilinear_sample


def flow_roundtrip(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor):
    """coord_diff [H, W, 2] (start minus round-trip coordinates) and its L2
    norm [H, W] for a pair of flows [H, W, 2] a->b and b->a.

    The backward flow is read at exactly the advected pixel with zero
    padding: the reference's ``bilinear_sampler`` normalises by (W-1, H-1)
    and samples ``align_corners=True``, which ``bilinear_sample`` is."""
    h, w = flow_fwd.shape[:2]
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow_fwd.dtype, device=flow_fwd.device),
        torch.arange(w, dtype=flow_fwd.dtype, device=flow_fwd.device),
        indexing="ij",
    )
    coords0 = torch.stack([gx, gy], dim=-1)
    coords1 = coords0 + flow_fwd
    coords2 = coords1 + bilinear_sample(flow_bwd, coords1[..., 0], coords1[..., 1])
    coord_diff = coords0 - coords2
    return coord_diff, torch.linalg.norm(coord_diff, dim=-1)


def occlusion_mask(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor, thresh: float = 1.0):
    """[H, W] bool: True where the round trip errs by more than thresh."""
    return flow_roundtrip(flow_fwd, flow_bwd)[1] > thresh
