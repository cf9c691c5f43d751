"""K2 — the fused GNT transformer forward with an explicit validity mask, as
a hand-written Hopper kernel.

Replaces the TPU kernel ``pgdvs_tpu/kernels/gnt_fused_mono3.py:
gnt_fused_apply_mono3`` in the mode the masked renderer runs it
(``separate_mask=True``, ray-diff and point code folded in, views outer):

    gnt_fused_mono3(params, rgb_feat [V, R, S, C] bf16, mask [V, R, S] (bool,
                    uint8 or float; nonzero = valid), pts [R, S, 3] f32,
                    view_code [R, 63], centers [V+1, 3] f32 (target first))
      -> {"rgb": [R, 3], "weights": [R, S] (true sample order),
          "inbound_cnt_raw": [R]}        all float32

The network is K1's (``kernels/gnt_fused.py``); only the source of validity
differs. The mask carries inbound & in-front & not-dynamic, so a view
whose tap lands on a dynamic object is left out of the view softmax; a
token whose views are all invalid attends to all of them un-masked (the
fallback of mono3, ``gnt_fused_mono3.py:312-320``). ``inbound_cnt_raw =
sum_s w_s * (#mask views at s) / V`` counts mask bits; with the dyn mask
on it is *not* the renderer's inbound count.

What bounds it on the H100: the same dense products as K1 (compute-bound
on the tensor cores), plus a V*R*S-byte mask read per call, small next to
the [V, R, S, 35] bf16 features. The design is K1's kernels
(``csrc/gnt_fused.cu``) with the validity source as a template parameter:
the mask bytes of a token's views load into the same per-token view bitmask
and count that K1 fills from the projection test, so the masked softmax,
its all-invalid fallback and the count need no other code.

Not carried from the TPU kernel: fold_lerp, fold_mask and the pre-packed
mask channel (operand layouts the masked renderer does not use), the
cross-block width-folded k/v/pos projections (a TPU lane-utilisation
trick), ray_block and the VMEM budget.

``gnt_fused_mono3`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.core.cameras import ray_diff_features
from pgdvs_tpu_torch.kernels.gnt_fused import Mono4Weights, launch
from pgdvs_tpu_torch.models.gnt.network import GNT


@torch.no_grad()
def gnt_fused_mono3_plain(gnt: GNT, rgb_feat, mask, pts, view_code, centers):
    """The same function in plain torch (float32): the ray-diff code from the
    camera centres, then the ``GNT`` module with the explicit mask."""
    v = rgb_feat.shape[0]
    valid = (mask != 0).float()                           # [V, R, S]
    pts = pts.float()
    centers = centers.float()
    rd = ray_diff_features(pts[None], centers[0], centers[1:, None, None, :])
    out = gnt.forward_codes(
        rgb_feat.float().permute(1, 2, 0, 3),
        rd.permute(1, 2, 0, 3),
        valid.permute(1, 2, 0)[..., None],
        pts,
        view_code.float(),
    )
    cnt = torch.sum(out["weights"] * valid.sum(0) / v, dim=-1)
    return {"rgb": out["rgb"], "weights": out["weights"], "inbound_cnt_raw": cnt}


def gnt_fused_mono3(params, rgb_feat, mask, pts, view_code, centers):
    """K2 on the card for CUDA tensors; the plain version for CPU tensors.

    params: the ``GNT`` module, or ``Mono4Weights`` packed for the device
    (K1 and K2 read the same packed weights).
    """
    gnt = params.gnt if isinstance(params, Mono4Weights) else params
    dev = rgb_feat.device
    if dev.type == "cpu":
        return gnt_fused_mono3_plain(gnt, rgb_feat, mask, pts, view_code, centers)
    if dev.type != "cuda":
        raise ValueError(f"gnt_fused_mono3: unsupported device {dev}")
    if mask.shape != rgb_feat.shape[:3] or mask.device != dev:
        raise ValueError("mask must be [V, R, S] on the operands' device")
    outs = launch("gnt_mono3_forward", params, (rgb_feat,), rgb_feat.shape, pts,
                  view_code, centers, (mask != 0).to(torch.uint8), (0.0, 0.0))
    gnt_fused_mono3.launches += 1
    return outs


gnt_fused_mono3.launches = 0
