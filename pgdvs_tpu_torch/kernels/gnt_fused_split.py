"""K3a / K3b — the split GNT transformer, one hand-written Hopper kernel per
half-block.

Replaces the TPU kernels of ``pgdvs_tpu/kernels/gnt_fused.py``:
``_run_view`` (``_view_kernel``, K3a) and ``_run_ray`` (``_ray_kernel``,
K3b), with the host loop of ``gnt_fused_apply`` around them. They take the
ray-difference code, the validity mask and the point code as the exact
sampler materializes them. No render path calls them: the JAX package
reaches its split kernels only when asked (``pallas_kernel="split"``), and
the port renders the exact sampler on K2's unfolded mode as JAX's default
does; they are a direct call, held against their plain versions.

    gnt_split_view(q [R, S, 64] f32, h [V, R, S, 64] bf16,
                   ray_diff [V, R, S, 4], mask [V, R, S] (nonzero = valid),
                   blk) -> q [R, S, 64] f32                        (K3a)
    gnt_split_ray(q [R, S, 64] f32, blk) -> (q, weights [R, S] f32)  (K3b)
    gnt_fused_split(params, rgb_feat [V, R, S, C] bf16, ray_diff, mask,
                    pts_code [R, S, 63], view_code [R, 63])
      -> {"rgb": [R, 3], "weights": [R, S]}                  float32

K3a is one view-transformer block: LayerNorm, the per-channel view softmax
masked by ``mask`` (a token whose views are all invalid attends to all of
them, as JAX's bias of 0 / -1e30 does), out_fc and the feed-forward; no
q_fc, which runs between the kernels as in JAX (``gnt_fused.py:470-472``).
K3b is one ray-transformer block (4-head attention over the S samples of a
ray, out_fc, feed-forward) and writes the head-mean of the first query's
attention row at every launch. ``gnt_fused_split`` runs the prologue
(rgbfeat_fc, max over views), 4 x [view, q_fc, ray, view, ray] and the
epilogue (LayerNorm, mean over samples, rgb_fc) around them; prologue,
q_fc and epilogue are torch ops, as JAX leaves them to XLA.

What bounds them on the H100: K3a reads h [V, N, 64] bf16 and the
ray-diff code once per launch against ~1e5 FLOP per token, so it is bound
by bytes (the port's first such kernel); K3b, with all S samples of a ray
in attention, by operations. Both are K1's view / ray blocks
(``csrc/gnt_fused.cu``) with the validity source ``VSRC_SPLIT`` (mask and
ray-diff read from memory), q read from one buffer and written to another,
and no epilogue or count. Offline, only K1's exact-by-linearity weight
compositions are made (wk@wv, wk@wa0, wq@wa0, p1@wa0). q stays float32
between the kernels, where JAX round-trips it through bf16.

The wrappers run the plain version only for tensors on the CPU (without
counting); for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from pgdvs_tpu_torch.kernels.gnt_fused import (
    DEPTH, NW, call_entry, pack_ray_block, pack_view_block, ray_scratch, tensor_device,
)
from pgdvs_tpu_torch.models.gnt.network import GNT


@dataclasses.dataclass
class PackedBlock:
    """One half-block (a ``ViewTransformer`` or ``RayTransformer``) and its
    weights laid out for the kernel on one device."""

    module: nn.Module
    device: torch.device
    tensors: List[Optional[torch.Tensor]]


@dataclasses.dataclass
class SplitWeights:
    """The GNT laid out per half-block: ``view[b]`` and ``ray[b]``."""

    gnt: GNT
    device: torch.device
    view: List[PackedBlock]
    ray: List[PackedBlock]


def pack_split_weights(gnt: GNT, device) -> SplitWeights:
    """The counterpart of ``flatten_gnt_params``: every half-block's weights
    in the kernels' pointer order on ``device``."""
    if gnt.netwidth != NW or gnt.depth != DEPTH:
        raise ValueError("the kernels serve netwidth 64, depth 8 only")
    device = tensor_device(device)
    return SplitWeights(
        gnt, device,
        [PackedBlock(m, device, pack_view_block(m, None, device))
         for m in gnt.view_crosstrans],
        [PackedBlock(m, device, pack_ray_block(m, device)) for m in gnt.view_selftrans],
    )


def _module(blk) -> nn.Module:
    return blk.module if isinstance(blk, PackedBlock) else blk


@torch.no_grad()
def split_view_plain(q, h, ray_diff, mask, blk):
    """One view-transformer half-block in plain float32 torch (the
    ``ViewTransformer`` module, views outer): q [R, S, 64], h [V, R, S, 64],
    ray_diff [V, R, S, 4], mask [V, R, S] (nonzero = valid; a token whose
    views are all invalid attends to all of them) -> q [R, S, 64]."""
    return _module(blk)(
        q.float(),
        h.float().permute(1, 2, 0, 3),
        ray_diff.float().permute(1, 2, 0, 3),
        (mask != 0).float().permute(1, 2, 0)[..., None],
    )


@torch.no_grad()
def split_ray_plain(q, blk):
    """One ray-transformer half-block in plain float32 torch: q [R, S, 64]
    -> (q, w [R, S]), w the head-mean of the first query's attention row."""
    return _module(blk)(q.float())


def _require_packed(blk, dev, fn) -> PackedBlock:
    if not isinstance(blk, PackedBlock) or blk.device != dev:
        raise ValueError(f"{fn}: on CUDA, blk must be a PackedBlock for {dev} "
                         "(pack_split_weights)")
    return blk


def gnt_split_view(q, h, ray_diff, mask, blk):
    """K3a on the card for CUDA tensors; the plain version for CPU tensors.

    blk: the ``ViewTransformer`` module or its ``PackedBlock``; on CUDA the
    ``PackedBlock`` for the device. On CUDA, q must be float32 and h
    bfloat16.
    """
    dev = q.device
    if dev.type == "cpu":
        return split_view_plain(q, h, ray_diff, mask, blk)
    if dev.type != "cuda":
        raise ValueError(f"gnt_split_view: unsupported device {dev}")
    packed = _require_packed(blk, dev, "gnt_split_view")
    v, r, s, nw = h.shape
    if q.shape != (r, s, NW) or nw != NW or q.dtype != torch.float32:
        raise ValueError("q must be [R, S, 64] float32 and h [V, R, S, 64]")
    if h.dtype != torch.bfloat16:
        raise ValueError("h must be bfloat16")
    if ray_diff.shape != (v, r, s, 4) or mask.shape != (v, r, s):
        raise ValueError("ray_diff must be [V, R, S, 4] and mask [V, R, S]")
    for t in (h, ray_diff, mask):
        if t.device != dev:
            raise ValueError("all operands must be on the same device")
    from pgdvs_tpu_torch.kernels._build import load_library

    lib = load_library().lib
    if v > lib.gnt_mono4_max_views():
        raise ValueError(f"at most {lib.gnt_mono4_max_views()} views, got {v}")
    q_in = q.contiguous()
    hc = h.contiguous()
    rd = ray_diff.float().contiguous()
    m = mask.contiguous() if mask.dtype == torch.uint8 else (mask != 0).to(torch.uint8)
    q_out = torch.empty_like(q_in)
    call_entry(lib, "gnt_split_view_forward", lib.gnt_split_n_view_ptrs(), packed.tensors,
               (q_in.data_ptr(), q_out.data_ptr(), hc.data_ptr(), rd.data_ptr(),
                m.data_ptr(), v, r * s), (), dev)
    gnt_split_view.launches += 1
    return q_out


def gnt_split_ray(q, blk):
    """K3b on the card for CUDA tensors; the plain version for CPU tensors.

    blk: the ``RayTransformer`` module or its ``PackedBlock``; on CUDA the
    ``PackedBlock`` for the device. Returns (q [R, S, 64] f32, weights
    [R, S] f32).
    """
    dev = q.device
    if dev.type == "cpu":
        return split_ray_plain(q, blk)
    if dev.type != "cuda":
        raise ValueError(f"gnt_split_ray: unsupported device {dev}")
    packed = _require_packed(blk, dev, "gnt_split_ray")
    if q.ndim != 3 or q.shape[-1] != NW or q.dtype != torch.float32:
        raise ValueError("q must be [R, S, 64] float32")
    r, s, _ = q.shape
    from pgdvs_tpu_torch.kernels._build import load_library

    lib = load_library().lib
    q_in = q.contiguous()
    q_out = torch.empty_like(q_in)
    w = torch.empty((r, s), dtype=torch.float32, device=dev)
    kv, blocks = ray_scratch(lib, r, s, dev)
    call_entry(lib, "gnt_split_ray_forward", lib.gnt_split_n_ray_ptrs(), packed.tensors,
               (q_in.data_ptr(), q_out.data_ptr(), w.data_ptr(), kv.data_ptr(), r, s, blocks),
               (), dev)
    gnt_split_ray.launches += 1
    return q_out, w


gnt_split_view.launches = 0
gnt_split_ray.launches = 0


@torch.no_grad()
def _forward(gnt: GNT, views, rays, view_fn, ray_fn, rgb_feat, ray_diff, mask,
             pts_code, view_code):
    """The host loop of ``gnt_fused_apply`` (views outer) with the given
    half-block functions."""
    # prologue: h in bf16, the view kernel's operand (JAX's too); q = its
    # max over views
    h = gnt.rgbfeat_fc(rgb_feat.float()).to(torch.bfloat16)
    q = h.max(dim=0).values.float()
    mask = (mask != 0).to(torch.uint8)
    ray_diff = ray_diff.float().contiguous()
    vc = view_code.float()[:, None, :].expand(pts_code.shape[:-1] + (view_code.shape[-1],))
    w = None
    for b in range(gnt.depth):
        q = view_fn(q, h, ray_diff, mask, views[b])
        if b % 2 == 0:
            q = gnt.q_fcs[b // 2](torch.cat([q, pts_code.float(), vc], dim=-1))
        q, w = ray_fn(q, rays[b])
    return {"rgb": gnt.rgb_fc(gnt.norm(q).mean(dim=-2)), "weights": w}


def gnt_fused_split_plain(gnt: GNT, rgb_feat, ray_diff, mask, pts_code, view_code):
    """The whole split forward with the plain half-blocks, on any device."""
    return _forward(gnt, gnt.view_crosstrans, gnt.view_selftrans, split_view_plain,
                    split_ray_plain, rgb_feat, ray_diff, mask, pts_code, view_code)


def gnt_fused_split(params, rgb_feat, ray_diff, mask, pts_code, view_code):
    """The split forward: K3a / K3b on the card for CUDA tensors, the plain
    half-blocks for CPU tensors.

    params: the ``GNT`` module, or ``SplitWeights`` packed for the device.
    rgb_feat [V, R, S, C] bf16; ray_diff [V, R, S, 4]; mask [V, R, S]
    (nonzero = valid); pts_code [R, S, 63]; view_code [R, 63].
    """
    gnt = params.gnt if isinstance(params, SplitWeights) else params
    dev = rgb_feat.device
    if dev.type == "cpu":
        return gnt_fused_split_plain(gnt, rgb_feat, ray_diff, mask, pts_code, view_code)
    if dev.type != "cuda":
        raise ValueError(f"gnt_fused_split: unsupported device {dev}")
    if not isinstance(params, SplitWeights) or params.device != dev:
        params = pack_split_weights(gnt, dev)
    return _forward(gnt, params.view, params.ray, gnt_split_view, gnt_split_ray,
                    rgb_feat, ray_diff, mask, pts_code, view_code)
