"""K1 — the fused GNT transformer forward, as a hand-written Hopper kernel.

Replaces the TPU kernel ``pgdvs_tpu/kernels/gnt_fused_mono4.py:
gnt_fused_apply_mono4`` on its ``rgb_feat`` contract (its ``patch_rows``
contract: ``kernels/gnt_fused_patch.py``, on this module's launch path):

    gnt_fused_mono4(params, rgb_feat [V, R, S, C] bf16, pts [R, S, 3] f32,
                    view_code [R, 63], centers [V+1, 3] f32 (target first),
                    proj [V, 3|4, 4] f32 (K @ w2c), hw=(H, W))
      -> {"rgb": [R, 3], "weights": [R, S] (true sample order),
          "inbound_cnt_raw": [R]}        all float32

Inside the kernel, as in mono4's body: view validity (in front, inside
[0, W-1] x [0, H-1]), the ray-difference code, the 63-dim point embedding,
rgbfeat_fc + max-pool over views, 8 x [masked per-channel view softmax,
q_fc on even blocks, 4-head ray attention], LayerNorm + mean + rgb_fc, and
``inbound_cnt_raw = sum_s w_s * (#valid views at s) / V``. Any S; no
padding is asked of the caller.

What bounds it on the H100: about 1e4 FLOP per (view, ray, sample) token and
block, mostly the 64x64 value projection, plus S x S attention per head and
ray. The design (``csrc/gnt_fused.cu``) runs every dense layer as bf16
tensor-core tiles with f32 accumulation and keeps softmax and LayerNorm
statistics in f32. The view block streams views one at a time per warp
through a cp.async ring into an online per-channel softmax held in mma.sync
registers (a ray's [V, S, 64] token set never has to fit in shared memory);
the ray block streams a ray's samples in key tiles through ray attention
(an online softmax in mma.sync registers, K / V in a bf16 scratch slab per
resident block). Both run a persistent grid with the block's weights staged
once per block. Offline, only exact-by-linearity weight compositions are
made (wk@wv, wk@wa0, wq@wa0, p1@wa0).

Not carried from the TPU kernel: 128-lane sample-pair packing, the
log2(e)/exp2 fold, the LayerNorm selection matmul, the evens-then-odds ray
order, ray_block / precompute_kv and the VMEM budget.

``gnt_fused_mono4`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch

from pgdvs_tpu_torch.core.cameras import pixel_inbound, project_with, ray_diff_features
from pgdvs_tpu_torch.models.gnt.network import GNT, POSENC

NW, PH, DEPTH, HEADS = 64, 8, 8, 4


@dataclasses.dataclass
class Mono4Weights:
    """GNT weights packed for the kernel on one device (see the .cu order)."""

    gnt: GNT
    device: torch.device
    tensors: List[Optional[torch.Tensor]]
    cp: int  # rgb_feat channels padded to a multiple of 16


def _k(linear) -> torch.Tensor:
    """nn.Linear -> its [in, out] kernel in float32."""
    return linear.weight.detach().float().T


def _f32(x, device) -> torch.Tensor:
    return x.detach().to(device=device, dtype=torch.float32).contiguous()


def _b16(x, device) -> torch.Tensor:
    return _f32(x, device).to(torch.bfloat16).contiguous()


def tensor_device(device) -> torch.device:
    """``device`` as its tensors report it ("cuda" -> "cuda:N", the current
    card), so packed weights compare equal to the operands' device."""
    return torch.empty(0, device=device).device


@torch.no_grad()
def pack_view_block(vt, qf, device) -> List[Optional[torch.Tensor]]:
    """One view transformer ``vt`` and the q_fc MLP ``qf`` that follows it
    (None: the four q_fc pointers are null) in the kernel's 21-pointer
    order (``read_view`` in the .cu). Matrices in bf16, attn_fc[2] too (its
    input is rounded to bf16, as in the JAX kernels); biases, LayerNorm and
    pos_fc_0 in float32."""
    a = vt.attn
    dev0 = a.k_fc.weight.device
    wk, wa0 = _k(a.k_fc), _k(a.attn_fc[0])
    p0, p1, a0, a1 = a.pos_fc[0], a.pos_fc[2], a.attn_fc[0], a.attn_fc[2]
    wqa0 = torch.zeros(NW, 16, device=dev0)
    wqa0[:, :PH] = _k(a.q_fc) @ wa0
    wbig = torch.zeros(80, 80, device=dev0)  # rows [h | pos_in | 0], cols [val | a0 | 0]
    wbig[:NW, :NW] = wk @ _k(a.v_fc)
    wbig[:NW, NW:NW + PH] = wk @ wa0
    wbig[NW:NW + PH, :NW] = _k(p1)
    wbig[NW:NW + PH, NW:NW + PH] = _k(p1) @ wa0
    bbig = torch.cat([p1.bias.float(), p1.bias.float() @ wa0 + a0.bias.float()])
    f32, b16 = (lambda x: _f32(x, device)), (lambda x: _b16(x, device))
    out = [
        f32(vt.attn_norm.weight), f32(vt.attn_norm.bias), b16(wqa0),
        b16(wbig), f32(bbig), f32(_k(p0)), f32(p0.bias), b16(_k(a1)),
        f32(a1.bias), b16(_k(a.out_fc)), f32(a.out_fc.bias),
        f32(vt.ff_norm.weight), f32(vt.ff_norm.bias), b16(_k(vt.ff.fc1)),
        f32(vt.ff.fc1.bias), b16(_k(vt.ff.fc2)), f32(vt.ff.fc2.bias),
    ]
    if qf is None:
        return out + [None] * 4
    wq0 = torch.zeros(192, NW, device=dev0)  # rows [q (64) | pts code (63) | view code (63) | 0]
    wq0[:NW + 2 * POSENC] = _k(qf[0])
    return out + [b16(wq0), f32(qf[0].bias), b16(_k(qf[2])), f32(qf[2].bias)]


@torch.no_grad()
def pack_ray_block(rt, device) -> List[torch.Tensor]:
    """One ray transformer in the kernel's 11-pointer order (``read_ray`` in
    the .cu)."""
    ra = rt.attn
    rq, rk, rv = _k(ra.q_fc), _k(ra.k_fc), _k(ra.v_fc)
    # head-major columns: [q_h | k_h | v_h] for h = 0..3
    wqkv = torch.cat(
        [m[:, h * 16:(h + 1) * 16] for h in range(HEADS) for m in (rq, rk, rv)],
        dim=1,
    )
    f32, b16 = (lambda x: _f32(x, device)), (lambda x: _b16(x, device))
    return [
        f32(rt.attn_norm.weight), f32(rt.attn_norm.bias), b16(wqkv),
        b16(_k(ra.out_fc)), f32(ra.out_fc.bias), f32(rt.ff_norm.weight),
        f32(rt.ff_norm.bias), b16(_k(rt.ff.fc1)), f32(rt.ff.fc1.bias),
        b16(_k(rt.ff.fc2)), f32(rt.ff.fc2.bias),
    ]


@torch.no_grad()
def pack_mono4_weights(gnt: GNT, device) -> Mono4Weights:
    """Compose and lay out the GNT weights in the kernel's pointer order."""
    if gnt.netwidth != NW or gnt.depth != DEPTH:
        raise ValueError("the kernel serves netwidth 64, depth 8 only")
    device = tensor_device(device)
    c = 3 + gnt.in_feat_ch
    cp = -(-c // 16) * 16
    fc0, fc1 = gnt.rgbfeat_fc[0], gnt.rgbfeat_fc[2]
    w0 = torch.zeros(cp, NW, device=fc0.weight.device)
    w0[:c] = _k(fc0)
    out = [_b16(w0, device), _f32(fc0.bias, device), _b16(_k(fc1), device),
           _f32(fc1.bias, device)]
    for blk in range(DEPTH):
        qf = gnt.q_fcs[blk // 2] if blk % 2 == 0 else None
        out += pack_view_block(gnt.view_crosstrans[blk], qf, device)
        out += pack_ray_block(gnt.view_selftrans[blk], device)
    out += [_f32(t, device) for t in (gnt.norm.weight, gnt.norm.bias, _k(gnt.rgb_fc),
                                      gnt.rgb_fc.bias)]
    return Mono4Weights(gnt, device, out, cp)


@torch.no_grad()
def gnt_fused_mono4_plain(gnt: GNT, rgb_feat, pts, view_code, centers, proj,
                          hw: Tuple[float, float]):
    """The same function in plain torch (float32): folds from the camera
    helpers, then the ``GNT`` module."""
    v = rgb_feat.shape[0]
    pts = pts.float()
    p = proj.float()[:, None, None]                       # [V, 1, 1, 4, 4]
    uv, _z, front = project_with(p, pts[None])
    valid = (pixel_inbound(uv, float(hw[0]), float(hw[1])) & front).float()
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
    return dict(out, inbound_cnt_raw=cnt)  # with the GNT's view-std maps, if it makes them


def ray_scratch(lib, r, s, dev):
    """The ray kernel's K / V scratch on ``dev`` for R rays of S samples:
    one bf16 slab of ``gnt_ray_slab(S)`` elements per ray block the card
    holds at once (at most R): (tensor [blocks, slab], blocks)."""
    per_sm = lib.gnt_ray_blocks_per_sm()
    if per_sm < 1:
        raise RuntimeError(f"gnt_ray_blocks_per_sm failed: {per_sm}")
    blocks = min(r, per_sm * torch.cuda.get_device_properties(dev).multi_processor_count)
    return torch.empty((blocks, lib.gnt_ray_slab(s)), dtype=torch.bfloat16, device=dev), blocks


def call_entry(lib, entry, n_ptrs, weights, head, tail, dev):
    """Call the C entry point ``entry`` as ``entry(*head, weight pointer
    array, n_ptrs, *tail, stream)`` on ``dev``'s current stream. Raises if
    ``weights`` (packed tensors, None for a null pointer) are not the
    ``n_ptrs`` the kernel wants, or if the launch returns a cudaError."""
    if len(weights) != n_ptrs:
        raise RuntimeError(f"packed {len(weights)} weights, kernel wants {n_ptrs}")
    ptrs = (ctypes.c_uint64 * n_ptrs)(*[0 if t is None else t.data_ptr() for t in weights])
    err = getattr(lib, entry)(*head, ctypes.cast(ptrs, ctypes.c_void_p), n_ptrs, *tail,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def launch(entry, params, data, dims, pts, view_code, centers, validity, hw, extra=()):
    """Check, pack, allocate and launch one whole forward; the outputs dict.

    ``entry`` is the C entry point: ``gnt_mono4_forward`` (K1) with ``data
    = (rgb_feat [V, R, S, C],)``, or ``gnt_mono4_patch_forward`` (K1's
    patch_rows mode) with ``data = (rows, coef)`` and ``extra = (n_pos,
    block_rays)``. They share one argument list: the data pointers, pts,
    view_code, centers, ``validity`` (the projection rows [V, 3, 4] f32),
    V, R, S, C, the padded C, the extra ints, the map size ``hw`` K1 tests
    the projection against, the weights, scratch and outputs. Validates the
    operands common to all (bf16 data, pts [R, S, 3], view_code [R, 63],
    centers [V+1, 3], all on one CUDA device; ``dims`` = (V, R, S, C)),
    builds or loads the kernel library, checks the view limit and packs
    the weights for the device. Raises on any failure, the launch's
    included.
    """
    gnt = params.gnt if isinstance(params, Mono4Weights) else params
    dev = data[0].device
    v, r, s, c = dims
    if any(t.dtype != torch.bfloat16 for t in data):
        raise ValueError("the kernel's feature operands must be bfloat16")
    if c != 3 + gnt.in_feat_ch:
        raise ValueError(f"features have {c} channels, GNT expects {3 + gnt.in_feat_ch}")
    if pts.shape != (r, s, 3) or view_code.shape != (r, POSENC):
        raise ValueError("pts must be [R, S, 3] and view_code [R, 63]")
    if centers.shape != (v + 1, 3):
        raise ValueError("centers must be [V+1, 3]")
    for t in (*data, pts, view_code, centers, validity):
        if t.device != dev:
            raise ValueError("all operands must be on the same device")
    lib, packed = prepare_forward(params, dev, v)
    data = [aligned16(t) for t in data]
    pts32 = pts.float().contiguous()
    vc = view_code.float().contiguous()
    ctr = centers.float().contiguous()
    validity = validity.contiguous()
    tail, _bufs, outs = forward_buffers(lib, v, r, s, dev)
    call_entry(
        lib, entry, lib.gnt_mono4_n_ptrs(), packed.tensors,
        (*[t.data_ptr() for t in data], pts32.data_ptr(), vc.data_ptr(), ctr.data_ptr(),
         validity.data_ptr(), v, r, s, c, packed.cp, *extra, float(hw[0]), float(hw[1])),
        tail, dev)
    return outs


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied if its data does not start on a 16-byte
    boundary (the patch loader streams its operands in 16-byte chunks)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def prepare_forward(params, dev, v):
    """(library, ``Mono4Weights`` for ``dev``) for one whole forward of V
    views: builds or loads the kernels, raises past the view limit, packs
    the weights unless ``params`` already are for ``dev``."""
    from pgdvs_tpu_torch.kernels._build import load_library

    lib = load_library().lib
    if v > lib.gnt_mono4_max_views():
        raise ValueError(f"at most {lib.gnt_mono4_max_views()} views, got {v}")
    if isinstance(params, Mono4Weights) and params.device == dev:
        return lib, params
    gnt = params.gnt if isinstance(params, Mono4Weights) else params
    return lib, pack_mono4_weights(gnt, dev)


def forward_buffers(lib, v, r, s, dev):
    """The scratch (h [V, N, 64] bf16, q [N, 64] f32, the ray kernel's
    K / V slabs) and outputs of one whole forward: (the arguments the C
    entries take last: h, q, kv, kv's block count, rgb, weights, count;
    the tensors behind them, which the caller holds until the launch is
    enqueued; the outputs dict)."""
    n = r * s
    outs = {
        "rgb": torch.empty((r, 3), dtype=torch.float32, device=dev),
        "weights": torch.empty((r, s), dtype=torch.float32, device=dev),
        "inbound_cnt_raw": torch.empty((r,), dtype=torch.float32, device=dev),
    }
    kv, blocks = ray_scratch(lib, r, s, dev)
    bufs = (torch.empty((v, n, NW), dtype=torch.bfloat16, device=dev),
            torch.empty((n, NW), dtype=torch.float32, device=dev), kv, *outs.values())
    tail = [t.data_ptr() for t in bufs]
    return tail[:3] + [blocks] + tail[3:], bufs, outs


def check_proj(proj, v, dev):
    """Raise unless ``proj`` is [V, 3|4, 4] on ``dev``; its [V, 3, 4] rows
    in float32."""
    if proj.shape[0] != v or proj.shape[-1] != 4 or proj.device != dev:
        raise ValueError("proj must be [V, 3|4, 4] on the operands' device")
    return proj[:, :3, :].float()


def gnt_fused_mono4(params, rgb_feat, pts, view_code, centers, proj,
                    hw: Tuple[float, float]):
    """K1 on the card for CUDA tensors; the plain version for CPU tensors.

    params: the ``GNT`` module, or ``Mono4Weights`` packed for the device.
    """
    gnt = params.gnt if isinstance(params, Mono4Weights) else params
    dev = rgb_feat.device
    if dev.type == "cpu":
        return gnt_fused_mono4_plain(gnt, rgb_feat, pts, view_code, centers,
                                     proj, hw)
    if dev.type != "cuda":
        raise ValueError(f"gnt_fused_mono4: unsupported device {dev}")
    outs = launch("gnt_mono4_forward", params, (rgb_feat,), rgb_feat.shape, pts,
                  view_code, centers, check_proj(proj, rgb_feat.shape[0], dev), hw)
    gnt_fused_mono4.launches += 1
    return outs


gnt_fused_mono4.launches = 0
