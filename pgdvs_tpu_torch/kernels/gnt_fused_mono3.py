"""K2 — the fused GNT transformer forward of the JAX package's mono3 kernel,
as a hand-written Hopper kernel, in every operand mode.

Replaces the TPU kernel ``pgdvs_tpu/kernels/gnt_fused_mono3.py:
gnt_fused_apply_mono3``. Two wrappers, one network:

    gnt_fused_mono3(params, rgb_feat [V, R, S, C] bf16, mask [V, R, S] (bool,
                    uint8 or float; nonzero = valid), pts [R, S, 3] f32,
                    view_code [R, 63], centers [V+1, 3] f32 (target first))
        the masked renderer's mode (separate_mask, ray-diff and point code
        folded in, views outer);
    gnt_fused_apply_mono3(params, rgb_feat, ray_diff, mask, pts_code,
                          view_code, *, views_outer=True, pts=None,
                          cam_centers=None, separate_mask=False,
                          fold_pos_code=False, fold_lerp=False, frac=None,
                          fold_mask_hw=None, proj_mats=None)
        JAX's arguments, and its ValueErrors for the combinations it
        refuses, in every operand mode;
  both -> {"rgb": [R, 3], "weights": [R, S] (true sample order),
           "inbound_cnt_raw": [R]}        all float32

The operand modes of ``gnt_fused_apply_mono3`` (views outer [V, R, S, *], or
[R, S, V, *] with ``views_outer=False``, permuted here as JAX transposes
outside its kernel), one source per operand:
  features  rgb_feat [..., C] bf16; with ``mask=None`` and no fold_mask
            (pre-packed) [..., C+1], the validity channel trailing (read in
            place, row stride C+1); with ``fold_lerp`` raw quad rows
            [V, R, S, 4C] (``projector.epipolar_sample_quad_raw``) and
            ``frac`` [V, R, S, 2] f32, combined in the kernel's prologue;
  validity  ``mask`` [..., 1] or [...] (nonzero = valid), whether JAX would
            concatenate it to the features (the unfolded mode) or take it
            apart (``separate_mask``); the pre-packed channel; or, with
            ``fold_mask_hw=(H, W)`` and ``proj_mats`` [V, 3|4, 4], K1's
            projection test of ``pts``;
  ray-diff  ``ray_diff`` [..., 4], rounded to bf16 as JAX rounds its operand,
            or ``None``: made from ``pts`` and ``cam_centers`` [V+1, 3];
  q_fc code ``pts_code`` [R, S, 63] and ``view_code`` [R, 63], the [R, S, 126]
            bf16 operand JAX concatenates, or with ``fold_pos_code`` the
            point code made from ``pts`` and ``view_code`` read as f32.
``mode_name`` names the combination: "unfolded" (mask, ray-diff and point
code all read: what the JAX package's exact default runs), else the
"+"-joined folds. ``gnt_fused_apply_mono3.launches[mode]`` counts launches.

A token whose views are all invalid attends to all of them un-masked (the
fallback of mono3, ``gnt_fused_mono3.py:312-320``). ``inbound_cnt_raw =
sum_s w_s * (#valid views at s) / V`` counts validity bits; with the dyn
mask on it is *not* the renderer's inbound count.

What bounds it on the H100: the same dense products as K1 (compute-bound
on the tensor cores). The modes differ in bytes only: the unfolded mode
reads 8 B of ray-diff code per (view, token) and 252 B of q_fc code per
token; fold_lerp reads 4x the feature bytes. The design is K1's kernels
(``csrc/gnt_fused.cu``): the mask bytes load into the per-token view
bitmask K1 fills from its projection test, the read codes replace the made
ones where ``k_view`` builds its A tiles, and ``k_prologue``'s quad-rows
loader combines the four taps in f32 (the zero-pad bilinear weights from
frac) before K1's ``rgbfeat_fc``. The weights are K1's packed weights.

Not carried from the TPU kernel: the cross-block width-folded k/v/pos
projections (a TPU lane-utilisation trick), ray_block, interpret and the
VMEM budget.

The wrappers run the plain versions only for tensors on the CPU (without
counting); for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import torch

from pgdvs_tpu_torch.core.cameras import pixel_inbound, project_with, ray_diff_features
from pgdvs_tpu_torch.kernels.gnt_fused import (
    Mono4Weights, call_entry, forward_buffers, prepare_forward,
)
from pgdvs_tpu_torch.models.gnt.network import GNT, POSENC


def _masked(rgb_feat, mask, pts, view_code, centers) -> "Mono3Operands":
    """The masked renderer's mode in ``gnt_fused_apply_mono3``'s terms."""
    return mono3_operands(rgb_feat, None, mask, None, view_code, pts=pts,
                          cam_centers=centers, separate_mask=True, fold_pos_code=True)


def gnt_fused_mono3_plain(gnt: GNT, rgb_feat, mask, pts, view_code, centers):
    """The same function in plain torch (float32): the ray-diff code from the
    camera centres, then the ``GNT`` module with the explicit mask."""
    return _plain(gnt, _masked(rgb_feat, mask, pts, view_code, centers))


def gnt_fused_mono3(params, rgb_feat, mask, pts, view_code, centers):
    """K2 on the card for CUDA tensors; the plain version for CPU tensors.

    params: the ``GNT`` module, or ``Mono4Weights`` packed for the device
    (K1 and K2 read the same packed weights).
    """
    outs, launched = _run(params, _masked(rgb_feat, mask, pts, view_code, centers),
                           rgb_feat.device, "gnt_fused_mono3")
    gnt_fused_mono3.launches += launched
    return outs


gnt_fused_mono3.launches = 0


def mode_name(*, fold_lerp=False, fold_mask=False, separate_mask=False, pre_packed=False,
              fold_ray_diff=False, fold_pos_code=False) -> str:
    """The name of an operand mode: the "+"-joined folds and validity source
    (a mask that JAX concatenates to the features names none), or
    "unfolded" when every operand is read as it comes."""
    flags = (("fold_lerp", fold_lerp), ("fold_mask", fold_mask),
             ("separate_mask", separate_mask), ("pre_packed", pre_packed),
             ("fold_ray_diff", fold_ray_diff), ("fold_pos_code", fold_pos_code))
    return "+".join(name for name, on in flags if on) or "unfolded"


@dataclasses.dataclass
class Mono3Operands:
    """One call's operands, views outer, one source per operand (None: the
    operand is made in the kernel, or comes from another source)."""

    mode: str
    dims: Tuple[int, int, int, int]     # (V, R, S, C)
    feats: Optional[torch.Tensor]       # bf16 [V, R, S, C or C+1]
    rows: Optional[torch.Tensor]        # bf16 [V, R, S, 4C] (fold_lerp)
    frac: Optional[torch.Tensor]        # [V, R, S, 2] (fold_lerp)
    mask: Optional[torch.Tensor]        # uint8 [V, R, S], nonzero = valid
    proj: Optional[torch.Tensor]        # [V, 3, 4] (fold_mask)
    hw: Tuple[float, float]             # the map size proj is tested against
    ray_diff: Optional[torch.Tensor]    # bf16 [V, R, S, 4]
    pts_code: Optional[torch.Tensor]    # bf16 [R, S, 63]
    view_code: torch.Tensor             # [R, 63]
    pts: Optional[torch.Tensor]         # [R, S, 3]
    centers: Optional[torch.Tensor]     # [V+1, 3]


def mono3_operands(rgb_feat, ray_diff, mask, pts_code, view_code, *, views_outer=True,
                   pts=None, cam_centers=None, separate_mask=False, fold_pos_code=False,
                   fold_lerp=False, frac=None, fold_mask_hw=None,
                   proj_mats=None) -> Mono3Operands:
    """Check a call of ``gnt_fused_apply_mono3`` as the JAX package does
    (``gnt_fused_mono3.py:482-512``, ValueError for each combination it
    refuses) and the operands' shapes, and lay them out views outer."""
    fold_mask = fold_mask_hw is not None
    if fold_mask:
        if mask is not None or separate_mask:
            raise ValueError("fold_mask_hw excludes mask/separate_mask")
        if ray_diff is not None or proj_mats is None:
            raise ValueError("fold_mask_hw requires the fold_ray_diff path + proj_mats")
    pre_packed = mask is None and not fold_mask
    if fold_lerp and not ((separate_mask or fold_mask) and views_outer and frac is not None):
        raise ValueError("fold_lerp requires separate_mask|fold_mask + views_outer + frac")
    fold_ray_diff = ray_diff is None
    if fold_ray_diff and (pts is None or cam_centers is None):
        raise ValueError("ray_diff=None (the fold_ray_diff path) requires pts + cam_centers")
    if separate_mask and mask is None:
        raise ValueError("separate_mask requires an explicit mask input")
    if fold_pos_code and not fold_ray_diff:
        raise ValueError("fold_pos_code requires the fold_ray_diff path")
    if not fold_pos_code and pts_code is None:
        raise ValueError("pts_code is required unless fold_pos_code")

    def outer(x):  # [R, S, V, *] -> [V, R, S, *]
        return x if views_outer else x.permute(2, 0, 1, 3)

    feats = outer(rgb_feat)
    v, r, s, ch = feats.shape
    c = ch // 4 if fold_lerp else (ch - 1 if pre_packed else ch)
    if fold_lerp and ch != 4 * c:
        raise ValueError(f"fold_lerp rows have {ch} channels, not a multiple of 4")
    if pre_packed:
        mask = feats[..., c]
    elif mask is not None:
        if mask.ndim == 4:
            mask = outer(mask)[..., 0]
        elif not views_outer:
            mask = mask.permute(2, 0, 1)
        if mask.shape != (v, r, s):
            raise ValueError("mask must be [V, R, S(, 1)] (views outer) like rgb_feat")
    if ray_diff is not None:
        ray_diff = outer(ray_diff)
        if ray_diff.shape != (v, r, s, 4):
            raise ValueError("ray_diff must be [V, R, S, 4] (views outer) like rgb_feat")
        ray_diff = ray_diff.to(torch.bfloat16)
    if fold_lerp and frac.shape != (v, r, s, 2):
        raise ValueError("frac must be [V, R, S, 2]")
    if view_code.shape != (r, POSENC):
        raise ValueError("view_code must be [R, 63]")
    if pts_code is not None and not fold_pos_code:
        if pts_code.shape != (r, s, POSENC):
            raise ValueError("pts_code must be [R, S, 63]")
        pts_code = pts_code.to(torch.bfloat16)
    else:
        pts_code = None
    if pts is not None and pts.shape != (r, s, 3):
        raise ValueError("pts must be [R, S, 3]")
    if cam_centers is not None and cam_centers.shape != (v + 1, 3):
        raise ValueError("cam_centers must be [V+1, 3]")
    proj = None
    if fold_mask:
        if proj_mats.shape[0] != v or proj_mats.shape[-1] != 4:
            raise ValueError("proj_mats must be [V, 3|4, 4]")
        proj = proj_mats[:, :3, :].float()
    return Mono3Operands(
        mode=mode_name(fold_lerp=fold_lerp, fold_mask=fold_mask, separate_mask=separate_mask,
                       pre_packed=pre_packed, fold_ray_diff=fold_ray_diff,
                       fold_pos_code=fold_pos_code),
        dims=(v, r, s, c),
        feats=None if fold_lerp else feats,
        rows=feats if fold_lerp else None,
        frac=frac if fold_lerp else None,
        mask=None if fold_mask else (mask != 0).to(torch.uint8),
        proj=proj,
        hw=tuple(float(x) for x in fold_mask_hw) if fold_mask else (0.0, 0.0),
        ray_diff=ray_diff,
        pts_code=pts_code,
        view_code=view_code,
        pts=pts,
        centers=cam_centers,
    )


def quad_lerp(rows, frac):
    """Zero-pad bilinear combine of raw quad rows [..., 4C] (taps (y, x),
    (y, x+1), (y+1, x), (y+1, x+1)) at frac [..., 2] = (x - sx, y - sy), in
    float32: [..., C]."""
    c = rows.shape[-1] // 4
    f = frac.float()
    wx0, wx1 = (torch.clamp(1.0 - torch.abs(f[..., 0:1] - d), min=0.0) for d in (0.0, 1.0))
    wy0, wy1 = (torch.clamp(1.0 - torch.abs(f[..., 1:2] - d), min=0.0) for d in (0.0, 1.0))
    t = rows.float()
    return (t[..., :c] * (wx0 * wy0) + t[..., c:2 * c] * (wx1 * wy0)
            + t[..., 2 * c:3 * c] * (wx0 * wy1) + t[..., 3 * c:] * (wx1 * wy1))


@torch.no_grad()
def _plain(gnt: GNT, o: Mono3Operands):
    """Decode the operands into features, validity, ray-diff code and point
    + view code, then run the ``GNT`` module in float32."""
    v, _r, _s, c = o.dims
    feats = quad_lerp(o.rows, o.frac) if o.rows is not None else o.feats[..., :c].float()
    if o.mask is not None:
        valid = (o.mask != 0).float()                     # [V, R, S]
    else:
        uv, _z, front = project_with(o.proj[:, None, None], o.pts.float()[None])
        valid = (pixel_inbound(uv, *o.hw) & front).float()
    if o.ray_diff is not None:
        rd = o.ray_diff.float()
    else:
        ctr = o.centers.float()
        rd = ray_diff_features(o.pts.float()[None], ctr[0], ctr[1:, None, None, :])
    if o.pts_code is not None:  # the [R, S, 126] operand is bf16, view code too
        pts_code, view_code = o.pts_code.float(), o.view_code.to(torch.bfloat16).float()
    else:
        pts_code, view_code = None, o.view_code.float()
    out = gnt.forward_codes(
        feats.permute(1, 2, 0, 3),
        rd.permute(1, 2, 0, 3),
        valid.permute(1, 2, 0)[..., None],
        None if o.pts is None else o.pts.float(),
        view_code,
        pts_code=pts_code,
    )
    cnt = torch.sum(out["weights"] * valid.sum(0) / v, dim=-1)
    return dict(out, inbound_cnt_raw=cnt)  # with the GNT's view-std maps, if it makes them


def gnt_fused_apply_mono3_plain(gnt: GNT, rgb_feat, ray_diff, mask, pts_code, view_code,
                                **kw):
    """``gnt_fused_apply_mono3`` in plain torch (float32), on any device."""
    return _plain(gnt, mono3_operands(rgb_feat, ray_diff, mask, pts_code, view_code, **kw))


def _launch(params, o: Mono3Operands, dev):
    """Check, pack, allocate and launch the C entry ``gnt_mono3_forward``."""
    v, r, s, c = o.dims
    gnt = params.gnt if isinstance(params, Mono4Weights) else params
    if c != 3 + gnt.in_feat_ch:
        raise ValueError(f"features have {c} channels, GNT expects {3 + gnt.in_feat_ch}")
    data = o.rows if o.rows is not None else o.feats
    if data.dtype != torch.bfloat16:
        raise ValueError("the kernel's feature operands must be bfloat16")
    ops = {
        "feats": o.feats, "rows": o.rows,
        "frac": None if o.frac is None else o.frac.float(),
        "mask": o.mask, "proj": o.proj, "ray_diff": o.ray_diff,
        # JAX's [R, S, 126] operand: point code | view code, in bf16
        "pos": None if o.pts_code is None else torch.cat(
            [o.pts_code, o.view_code.to(torch.bfloat16)[:, None, :].expand(r, s, POSENC)],
            dim=-1),
        "pts": None if o.pts is None else o.pts.float(),
        "view_code": o.view_code.float(),
        "centers": None if o.centers is None else o.centers.float(),
    }
    for t in ops.values():
        if t is not None and t.device != dev:
            raise ValueError("all operands must be on the same device")
    # rows [V, R, S, C+1] are read in place in the pre-packed mode
    ops = {k: None if t is None else t.contiguous() for k, t in ops.items()}
    lib, packed = prepare_forward(params, dev, v)
    tail, _bufs, outs = forward_buffers(lib, v, r, s, dev)
    ptr = lambda k: 0 if ops[k] is None else ops[k].data_ptr()  # noqa: E731
    ld = ops["feats"].shape[-1] if ops["feats"] is not None else c
    call_entry(
        lib, "gnt_mono3_forward", lib.gnt_mono4_n_ptrs(), packed.tensors,
        (ptr("feats"), ld, ptr("rows"), ptr("frac"), ptr("mask"), ptr("proj"),
         ptr("ray_diff"), ptr("pos"), ptr("pts"), ptr("view_code"), ptr("centers"),
         v, r, s, c, packed.cp, *o.hw),
        tail, dev)
    return outs


def _run(params, o: Mono3Operands, dev, fn):
    """(outputs, whether the kernel launched): the plain version for the
    CPU, the kernel for CUDA, ValueError naming ``fn`` for other devices."""
    if dev.type == "cpu":
        return _plain(params.gnt if isinstance(params, Mono4Weights) else params, o), False
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    return _launch(params, o, dev), True


def gnt_fused_apply_mono3(params, rgb_feat, ray_diff, mask, pts_code, view_code, *,
                          views_outer=True, pts=None, cam_centers=None,
                          separate_mask=False, fold_pos_code=False, fold_lerp=False,
                          frac=None, fold_mask_hw=None, proj_mats=None):
    """K2 in the operand mode the arguments give (module docstring), on the
    card for CUDA tensors; the plain version for CPU tensors.

    params: the ``GNT`` module, or ``Mono4Weights`` packed for the device.
    """
    o = mono3_operands(rgb_feat, ray_diff, mask, pts_code, view_code,
                       views_outer=views_outer, pts=pts, cam_centers=cam_centers,
                       separate_mask=separate_mask, fold_pos_code=fold_pos_code,
                       fold_lerp=fold_lerp, frac=frac, fold_mask_hw=fold_mask_hw,
                       proj_mats=proj_mats)
    outs, launched = _run(params, o, rgb_feat.device, "gnt_fused_apply_mono3")
    if launched:
        gnt_fused_apply_mono3.launches[o.mode] += 1
    return outs


gnt_fused_apply_mono3.launches = collections.Counter()
