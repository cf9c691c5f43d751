"""Rendering and training over a mesh of ranks (torch).

The port's counterpart of ``pgdvs_tpu.parallel.sharded``, one process per
GPU. Every rank of a mesh (``parallel.mesh.Mesh``) runs the same calls in
the same order; the collectives are those of ``parallel.mesh``.

  * ``sharded_render_rays``: one view, its rays split over every rank of the
    mesh, each rank rendering its share on the hand kernels, the shares
    gathered back on every rank;
  * ``make_sharded_eval_fn``: one whole view per rank (the reference's
    multi-GPU evaluation), the outputs gathered as a batch;
  * ``make_train_step``: the GNT fine-tuning step, views over ``dp`` and
    rays over ``rp``, the gradients summed over the mesh, then a
    ``torch.optim`` step on every rank.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Optional

import torch

from pgdvs_tpu_torch.core import cameras
from pgdvs_tpu_torch.kernels.gnt_fused import pack_mono4_weights
from pgdvs_tpu_torch.models.gnt.projector import PATCH_BLOCKS
from pgdvs_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce_sum, broadcast_
from pgdvs_tpu_torch.renderers.config import RenderConfig, check_slice
from pgdvs_tpu_torch.renderers.static_gnt import (
    PRESET_RAY_BLOCK,
    build_sampling_maps,
    patch_ray_perm,
    render_rays_plain,
    render_rays_tiled,
    resolve_epipolar_cfg,
)


def _pad_edge(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])]) if pad else x


@torch.no_grad()
def sharded_render_rays(mesh: Mesh, models, tgt_cam, src_cams, src_rgbs, image_hw,
                        depth_range, cfg: RenderConfig, src_invalid_masks=None):
    """Render one view with its rays split over every rank of ``mesh``.

    Every rank computes the features and the sampler's maps of the view,
    then renders one contiguous share of the rays (``render_rays_tiled``:
    the hand kernels on a card, their plain versions on the CPU). The rays
    are padded, each pad a copy of the last ray, so that every share is
    whole kernel ray blocks of 8 and, on patch, whole by x bx pixel blocks
    (the JAX package's padding); the pad is dropped after the gather. The
    sampler follows ``resolve_epipolar_cfg``, warning at each fallback as
    the single-rank render does.

    Returns, on every rank, the [rh, rw, ...] maps of ``render_rays_gnt``'s
    outputs (rgb, depth, weights, inbound_cnt, dyn_cnt, view_std,
    view_std_normalized), as ``render_image_gnt`` returns them before its
    masks.
    """
    check_slice(cfg)
    feature_net, gnt = models
    h, w = image_hw
    rays_o, rays_d, _uv, (rh, rw) = cameras.get_rays(
        h, w, cameras.flat_cam_intrinsics(tgt_cam), cameras.flat_cam_c2w(tgt_cam),
        stride=cfg.render_stride,
    )
    n_rays = rh * rw
    cfg, block = resolve_epipolar_cfg(cfg, gnt, rh, rw)
    maps = build_sampling_maps(cfg, src_rgbs, feature_net(src_rgbs), src_invalid_masks, block)
    if depth_range.ndim == 1:
        dr = depth_range.expand(n_rays, 2)
    else:
        dr = depth_range[::cfg.render_stride, ::cfg.render_stride].reshape(-1, 2)
    inv_perm, block_rays = None, 1
    if block is not None:
        by, bx = PATCH_BLOCKS[block][0]
        block_rays = by * bx
        perm, inv_perm = patch_ray_perm(n_rays, rh, rw, by, bx, device=rays_o.device)
        rays_o, rays_d, dr = rays_o[perm], rays_d[perm], dr[perm]
    quantum = mesh.size * math.lcm(PRESET_RAY_BLOCK, block_rays)
    pad = -(-n_rays // quantum) * quantum - n_rays
    share = (n_rays + pad) // mesh.size
    mine = slice(mesh.rank * share, (mesh.rank + 1) * share)
    rays_o, rays_d, dr = (_pad_edge(x, pad)[mine] for x in (rays_o, rays_d, dr))
    params = gnt
    if rays_o.device.type == "cuda" and not gnt.ret_view_std:
        params = pack_mono4_weights(gnt, rays_o.device)
    flat = render_rays_tiled(params, rays_o, rays_d, dr, tgt_cam, src_cams, maps, cfg)
    out = {}
    for k, v in flat.items():
        v = torch.cat(all_gather(v, mesh.group))[:n_rays]
        if inv_perm is not None:
            v = v[inv_perm]
        out[k] = v.reshape((rh, rw) + v.shape[1:])
    return out


def make_sharded_eval_fn(mesh: Mesh, models, cfg: RenderConfig, static_mode: str = "gnt",
                         tracker=None):
    """Data-parallel render of a batch of whole views, one per rank of
    ``mesh``: the reference's multi-GPU evaluation.

    Returns ``fn(data, seed, keys=None)``: this rank renders its own view
    (``data``: its contract as tensors on the rank's device; ``seed``: the
    noise of its render, a ``torch.Generator`` seeded with it, as
    ``Evaluator.eval_item`` seeds one) with ``render_novel_view``; the
    outputs named by ``keys`` (default: every tensor output) are gathered
    from every rank of the mesh, in mesh order, as a {key: [B, ...]} batch
    on every rank. Every rank's view has one render size.
    """
    from pgdvs_tpu_torch.renderers.compose import render_novel_view

    def fn(data, seed: int, keys=None):
        device = data["flat_cam_tgt"].device
        gen = torch.Generator(device=device).manual_seed(seed)
        out = render_novel_view(models, data, cfg, generator=gen, static_mode=static_mode,
                                tracker=tracker)
        if keys is None:
            keys = sorted(k for k, v in out.items() if torch.is_tensor(v))
        return {k: torch.stack(all_gather(out[k], mesh.group)) for k in keys}

    return fn


def make_train_step(mesh: Mesh, models, cfg: RenderConfig, optimizer,
                    n_rays_per_view: Optional[int] = None, dtype=torch.float32):
    """The GNT fine-tuning step over ``mesh``.

    ``step(batch) -> loss`` consumes a batch dict of B views (numpy arrays
    or tensors): rays_o / rays_d [B, R, 3], depth_range [B, R, 2], rgb_gt
    [B, R, 3], tgt_cam [B, 34], src_cams [B, V, 34], src_rgbs [B, V, H, W,
    3], B a multiple of ``dp`` and R of ``rp`` (R = ``n_rays_per_view``
    where given). The rank at (i, j) renders views [i B/dp, (i+1) B/dp) and,
    of each, rays [j R/rp, (j+1) R/rp), through the ResUNet and
    ``render_rays_plain`` under autograd.

    The loss is the JAX package's: the mean over views of the per-view mean
    squared photometric error (over R rays and 3 channels). Each rank
    back-propagates its share of that sum, scaled by 1 / (3 R B), so the
    sum of every rank's gradients is the gradient of the loss, the feature
    net's too (each rp rank of a view recomputes it and back-propagates
    only its own rays); the gradients are summed over the mesh (one
    all-reduce of every parameter's gradient, flattened), then
    ``optimizer`` (a ``torch.optim`` optimizer over both modules' parameters)
    steps on every rank. The gradients stay in ``.grad`` until the next
    step. Every rank starts from the mesh's first rank's parameters
    (broadcast here).

    ``dtype``: torch.float32; torch.bfloat16 to run the GNT under
    ``torch.autocast`` and sample in bf16 (the JAX package's bf16 GNT), the
    parameters, gradients and optimizer state float32 and the ResUNet
    float32, as the JAX package's feature net has no dtype; or
    torch.float64 for float64 models and batches (a reference for the
    float32 step). ``step`` returns the loss as a Python float, equal on
    every rank.
    """
    feature_net, gnt = models
    params = [p for m in models for p in m.parameters()]
    if mesh.group is not None:  # one broadcast of every parameter, flattened
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        broadcast_(flat, src=mesh.ranks[0], group=mesh.group)
        at = 0
        with torch.no_grad():
            for p in params:
                p.copy_(flat[at:at + p.numel()].view_as(p))
                at += p.numel()
    if cfg.epipolar_mode != "exact":
        warnings.warn(f"the train step samples exactly (epipolar_mode {cfg.epipolar_mode!r} "
                      "ignored), as the JAX package's train step renders without maps",
                      stacklevel=2)
    sample_dtype = None if dtype == torch.float32 else dtype
    autocast = dtype in (torch.bfloat16, torch.float16)
    device = mesh.device
    i, j = mesh.coord

    def step(batch) -> float:
        b, r = batch["rays_o"].shape[:2]
        if b % mesh.dp or r % mesh.rp or (n_rays_per_view and r != n_rays_per_view):
            raise ValueError(f"a batch of {b} views x {r} rays on a dp {mesh.dp} x rp "
                             f"{mesh.rp} mesh ({n_rays_per_view} rays per view)")
        per, share = b // mesh.dp, r // mesh.rp
        rays = slice(j * share, (j + 1) * share)
        optimizer.zero_grad(set_to_none=True)
        part = torch.zeros((), dtype=torch.float64, device=device)
        for v in range(i * per, (i + 1) * per):
            t = {k: torch.as_tensor(x[v]).to(device) for k, x in batch.items()}
            feats = feature_net(t["src_rgbs"])
            with (torch.autocast(device.type, dtype=dtype) if autocast
                  else contextlib.nullcontext()):
                out = render_rays_plain(gnt, t["rays_o"][rays], t["rays_d"][rays],
                                        t["depth_range"][rays], t["tgt_cam"], t["src_cams"],
                                        t["src_rgbs"], feats, cfg, sample_dtype=sample_dtype)
            gt = t["rgb_gt"][rays]
            loss_v = ((out["rgb"].to(gt.dtype) - gt) ** 2).sum() / (3.0 * r * b)
            loss_v.backward()
            part += loss_v.detach()
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for p in params])
        grads = all_reduce_sum(grads, mesh.group)
        at = 0
        for p in params:
            p.grad = grads[at:at + p.numel()].view_as(p).clone()
            at += p.numel()
        loss = all_reduce_sum(part, mesh.group)
        optimizer.step()
        return float(loss)

    return step
