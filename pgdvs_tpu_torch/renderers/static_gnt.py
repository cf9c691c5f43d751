"""Static-background rendering with GNT (torch).

Counterpart of ``pgdvs_tpu.renderers.static_gnt`` on the ported slices:
source features once per image (ResUNet), the sampler's per-image maps,
then a Python loop over ray tiles. Per tile: deterministic sample
placement, epipolar sampling over all source views, the GNT transformer,
and per-ray rgb, depth = sum_s w_s z_s, the weighted in-bounds view count
and the weighted dynamic view count.

The sampler follows ``cfg.epipolar_mode`` and the transformer follows the
sampler and ``gnt_use_dyn_mask`` (a hand kernel on CUDA, its plain version
on the CPU):
  exact  ``epipolar_sample`` on the source rgbs, the quarter-resolution
         features and the dynamic masks (``ExactMaps``), then K2 in its
         unfolded mode (``gnt_fused_apply_mono3``), which reads the sampler's
         features, mask and ray-diff code and the point code, as the JAX
         package's ``RenderConfig()`` runs mono3 there; the counts come from
         the kernel without the dyn mask, from the sampler's masks with it;
  quad   fused full-resolution maps (the dynamic mask as a trailing channel
         with the dyn mask), then K1 (validity recomputed in-kernel) without
         the dyn mask, K2 (validity read from the sampler's mask: in
         bounds, in front and not dynamic) with it, as the JAX package's
         preset splits them (mono4 / mono3);
  patch  fy x fx-pixel patch maps, rays permuted into by x bx pixel blocks,
         one row per (view, block, sample) plus stencil coefficients
         (``epipolar_sample_patch_raw``), then K1's patch_rows mode
         (``gnt_fused_mono4_patch``, the combine in the kernel). The block
         is 4x2 where the geometry allows, else 2x2, else the render falls
         back to quad, each with a warning (``resolve_epipolar_cfg``);
  fused  the fused maps lerped in bf16 (``epipolar_sample_fused``), then K2
         with the sampler's validity mask, as the JAX package's preset
         runs mono3 there (fold_mask needs quad or patch maps);
  quad_i8  int8 quad maps with per-channel scales, dequantized to bf16 in
         the sampler (``epipolar_sample_fused(quad=True)``), then K1 on the
         samples without the dyn mask (the preset's mono4), K2 with it.

With ``n_fine_samples_per_ray > 0`` every tile runs a second pass (the same
sampler and kernel) on the merged coarse + fine samples; a ``render_stride``
puts the rays on every stride-th pixel. A GNT made with ``ret_view_std``
runs the plain versions of these kernels (the module itself) on any device,
and the fast preset's patch falls back to quad for it, as in JAX.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch

from pgdvs_tpu_torch.core import cameras, sampling
from pgdvs_tpu_torch.kernels.gnt_fused import (
    gnt_fused_mono4,
    gnt_fused_mono4_plain,
    pack_mono4_weights,
)
from pgdvs_tpu_torch.kernels.gnt_fused_mono3 import (
    gnt_fused_apply_mono3,
    gnt_fused_apply_mono3_plain,
    gnt_fused_mono3,
    gnt_fused_mono3_plain,
)
from pgdvs_tpu_torch.kernels.gnt_fused_patch import (
    gnt_fused_mono4_patch,
    gnt_fused_mono4_patch_plain,
)
from pgdvs_tpu_torch.models.gnt.feature_net import ResUNet
from pgdvs_tpu_torch.models.gnt.network import GNT, sinusoidal_embed
from pgdvs_tpu_torch.models.gnt.projector import (
    PATCH_BLOCKS,
    ExactMaps,
    build_fused_maps,
    build_patch_maps,
    build_quad_maps,
    epipolar_sample,
    epipolar_sample_fused,
    epipolar_sample_patch_raw,
    epipolar_sample_quad,
    epipolar_sample_quad_masked,
    flatten_quad_maps,
    quantize_quad_maps,
)
from pgdvs_tpu_torch.renderers.config import RenderConfig, check_slice


def make_gnt_models(netwidth: int = 64, depth: int = 8, feat_ch: int = 32,
                    ret_view_std: bool = False):
    """The (feature_net, gnt) pair, freshly initialised by torch; with
    ``ret_view_std`` the GNT returns the view-std diagnostics and renders
    on the plain network."""
    return ResUNet(out_channels=feat_ch), GNT(netwidth, depth, feat_ch, ret_view_std)


def init_gnt_models(seed: int = 0, device="cuda", **kw):
    """(feature_net, gnt) with random weights drawn from ``seed`` (torch's
    default initialisers), in eval mode on ``device``. The caller's global
    RNG state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        fnet, gnt = make_gnt_models(**kw)
    return fnet.to(device).eval(), gnt.to(device).eval()


# the JAX package's preset values of the knobs the port does not carry:
# pallas_patch_block and pallas_ray_block (rays per kernel grid step)
PRESET_PATCH_BLOCK, PRESET_RAY_BLOCK = "4x2", 8


def resolve_epipolar_cfg(cfg: RenderConfig, gnt, rh: int, rw: int):
    """Resolve ``cfg.epipolar_mode`` against the render geometry, as the JAX
    package's ``resolve_epipolar_cfg`` does under its preset's values
    (4x2 blocks, ray block 8, the full fold set), warning at each fallback.

    Returns (cfg, block): for patch, the 4x2 block when rh % 4 == 0 and
    rw % 2 == 0, else "2x2"; and patch only when there is no dyn mask, the
    network is width 64 / depth 8 without the view-std diagnostics, the
    block divides the render and the tile quantum min(ray_tile, rh * rw) is
    a multiple of the block and of 8, else cfg falls back to quad. block is
    None off the patch path.
    """
    if cfg.epipolar_mode != "patch":
        return cfg, None
    block = PRESET_PATCH_BLOCK
    by, bx = PATCH_BLOCKS[block][0]
    if rh % by != 0 or rw % bx != 0:
        warnings.warn(f"patch block {block!r} needs render dims divisible by "
                      f"{by}x{bx}; falling back to '2x2'", stacklevel=2)
        block, (by, bx) = "2x2", (2, 2)
    quantum = min(cfg.ray_tile, rh * rw)
    patch_ok = (
        not cfg.gnt_use_dyn_mask
        and not gnt.ret_view_std
        and gnt.netwidth == 64
        and gnt.depth == 8
        and rh % by == 0
        and rw % bx == 0
        and quantum % (by * bx) == 0
        and quantum % PRESET_RAY_BLOCK == 0
    )
    if not patch_ok:
        warnings.warn("epipolar_mode='patch' requires no dyn mask, GNT width 64 / "
                      "depth 8, no view-std, even render dims and a tile that is a "
                      "multiple of the block and of 8; falling back to 'quad'", stacklevel=2)
        return cfg.replace(epipolar_mode="quad"), None
    return cfg, block


def patch_ray_perm(n_rays: int, rh: int, rw: int, by: int, bx: int, device=None):
    """Ray permutation grouping the rh x rw rays into by x bx pixel blocks,
    and its inverse (long tensors)."""
    perm = (torch.arange(n_rays, device=device).reshape(rh // by, by, rw // bx, bx)
            .permute(0, 2, 1, 3).reshape(-1))
    return perm, torch.argsort(perm)


def build_sampling_maps(cfg: RenderConfig, src_rgbs, feats, src_invalid_masks=None,
                        block: Optional[str] = None):
    """The per-image maps the sampler of ``cfg.epipolar_mode`` reads:
    ``ExactMaps`` (rgb and features in bf16, JAX's sample dtype; the dyn
    masks in float32) for exact, the fused [V, H, W, 3+F(+1)] bf16 maps for
    quad and fused, the int8 quad maps with their scales
    (``FlatQuadMaps``) for quad_i8, ``FlatPatchMaps`` of ``block``
    (``resolve_epipolar_cfg``) for patch. The dyn masks are read only with
    ``cfg.gnt_use_dyn_mask``."""
    masks = src_invalid_masks if cfg.gnt_use_dyn_mask else None
    if cfg.epipolar_mode == "patch":
        blk, foot = PATCH_BLOCKS[block]
        return build_patch_maps(src_rgbs, feats, foot=foot, block=blk)
    if cfg.epipolar_mode == "exact":
        return ExactMaps(src_rgbs.to(torch.bfloat16), feats.to(torch.bfloat16),
                         None if masks is None else masks.float())
    if cfg.epipolar_mode == "quad_i8":
        return flatten_quad_maps(*quantize_quad_maps(build_quad_maps(src_rgbs, feats, masks)))
    return build_fused_maps(src_rgbs, feats, masks)


def _forwards(gnt_params):
    """(params, K1, K1 patch_rows, K2 masked, K2 in any mode) for one pass:
    the hand kernels' wrappers, or, for a GNT made with ``ret_view_std``,
    their plain versions on the GNT module itself, on the rays' device (no
    hand kernel computes the view-std diagnostics; the JAX package likewise
    turns its kernels off for them)."""
    gnt = gnt_params if isinstance(gnt_params, GNT) else gnt_params.gnt
    if gnt.ret_view_std:
        return (gnt, gnt_fused_mono4_plain, gnt_fused_mono4_patch_plain,
                gnt_fused_mono3_plain, gnt_fused_apply_mono3_plain)
    return (gnt_params, gnt_fused_mono4, gnt_fused_mono4_patch, gnt_fused_mono3,
            gnt_fused_apply_mono3)


def gnt_pass(gnt_params, pts, z_vals, rays_d, tgt_cam, src_cams, maps,
             cfg: RenderConfig) -> Dict[str, torch.Tensor]:
    """One GNT pass over sample points pts [R, S, 3] at depths z_vals
    [R, S]: the sampler of ``cfg.epipolar_mode``, the transformer
    (``_forwards``) and the per-ray outputs of ``render_rays_gnt``."""
    params, k1, k1_patch, k2, k2_apply = _forwards(gnt_params)
    mode = cfg.epipolar_mode
    view_code = sinusoidal_embed(rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True))
    smp = None
    if mode == "exact":
        smp = epipolar_sample(pts, tgt_cam, src_cams, *maps)
        out = k2_apply(params, smp["rgb_feat"], smp["ray_diff"], smp["mask"],
                       sinusoidal_embed(pts), view_code)
    else:
        proj = cameras.flat_cam_projection(src_cams)
        centers = torch.cat([
            cameras.flat_cam_c2w(tgt_cam)[None, :3, 3],
            cameras.flat_cam_c2w(src_cams)[:, :3, 3],
        ])
        if mode == "patch":
            raw = epipolar_sample_patch_raw(pts, proj, maps)
            _, map_h, map_w = maps.vhw
            out = k1_patch(params, raw["rows"], raw["coef"], pts, view_code, centers, proj,
                           (map_h, map_w))
        elif mode in ("fused", "quad_i8"):
            smp = epipolar_sample_fused(pts, proj, maps, cfg.gnt_use_dyn_mask,
                                        quad=mode == "quad_i8")
            if mode == "quad_i8" and not cfg.gnt_use_dyn_mask:
                out = k1(params, smp["rgb_feat"], pts, view_code, centers, proj,
                         maps.vhw[1:])
            else:
                out = k2(params, smp["rgb_feat"], smp["mask"], pts, view_code, centers)
        elif cfg.gnt_use_dyn_mask:
            smp = epipolar_sample_quad_masked(pts, proj, maps)
            out = k2(params, smp["rgb_feat"], smp["mask"], pts, view_code, centers)
        else:
            rgb_feat = epipolar_sample_quad(pts, proj, maps)
            _, map_h, map_w, _ = maps.shape
            out = k1(params, rgb_feat, pts, view_code, centers, proj, (map_h, map_w))
    weights = out["weights"]
    if not cfg.gnt_use_dyn_mask:
        # validity is the in-bounds mask, so the kernel's count is the
        # renderer's inbound count (static_gnt.py:359-364 in JAX)
        inbound_cnt = out["inbound_cnt_raw"]
        dyn_cnt = torch.zeros_like(inbound_cnt)
    else:
        # the kernel counts mask views; the renderer's counts are of
        # in-bounds and of dynamic views (static_gnt.py:365-377 in JAX)
        n_src = src_cams.shape[0]
        inbound_cnt = torch.sum(weights * smp["mask_inbound"].sum(0) / n_src, dim=-1)
        dyn_cnt = torch.sum(weights * smp["mask_invalid"].sum(0) / n_src, dim=-1)
    if "view_std" in out:
        # per-block diagnostics composited along the ray by the same weights
        std = torch.sum(weights[..., None] * out["view_std"], dim=-2)
        norm_std = torch.sum(weights[..., None] * out["view_std_normalized"], dim=-2)
    else:
        gnt = gnt_params if isinstance(gnt_params, GNT) else gnt_params.gnt
        std = norm_std = torch.zeros(weights.shape[:-1] + (gnt.depth + 1,),
                                     dtype=torch.float32, device=weights.device)
    return {
        "rgb": out["rgb"],
        "depth": torch.sum(weights * z_vals, dim=-1),
        "weights": weights,
        "inbound_cnt": inbound_cnt,
        "dyn_cnt": dyn_cnt,
        "view_std": std,
        "view_std_normalized": norm_std,
    }


def render_rays_gnt(gnt_params, rays_o, rays_d, depth_range, tgt_cam, src_cams,
                    maps, cfg: RenderConfig) -> Dict[str, torch.Tensor]:
    """Render a batch of rays.

    Args:
      gnt_params: the GNT module, or its weights packed for the rays'
        device (``Mono4Weights``).
      rays_o/rays_d [R, 3]; depth_range [R, 2]; tgt_cam [34];
      src_cams [V, 34]; maps: ``build_sampling_maps(cfg, ...)``. On patch
      the rays come in the maps' pixel blocks (``patch_ray_perm``) and R is
      a multiple of the block (else ValueError).

    The coarse pass places ``cfg.n_coarse_samples_per_ray`` samples; with
    ``cfg.n_fine_samples_per_ray > 0`` a second pass, with the same sampler
    and transformer, runs on the coarse z values merged with the ones
    importance-resampled from the coarse weights (``sample_fine_z_vals``),
    and its outputs are returned, as the JAX package does.

    Returns rgb [R, 3], depth [R], weights [R, S], inbound_cnt [R],
    dyn_cnt [R] (zero without the dyn mask), view_std /
    view_std_normalized [R, depth+1] (zero unless the GNT was made with
    ``ret_view_std``).
    """
    pts, z_vals = sampling.sample_along_rays(
        rays_o, rays_d, depth_range, cfg.n_coarse_samples_per_ray,
        inv_uniform=cfg.sample_inv_uniform,
    )
    out = gnt_pass(gnt_params, pts, z_vals, rays_d, tgt_cam, src_cams, maps, cfg)
    if cfg.n_fine_samples_per_ray > 0:
        z_vals = sampling.sample_fine_z_vals(z_vals, out["weights"],
                                             cfg.n_fine_samples_per_ray,
                                             inv_uniform=cfg.sample_inv_uniform)
        pts = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
        out = gnt_pass(gnt_params, pts, z_vals, rays_d, tgt_cam, src_cams, maps, cfg)
    return out


def render_rays_tiled(gnt_params, rays_o, rays_d, dr, tgt_cam, src_cams,
                      maps, cfg: RenderConfig):
    """Loop ``render_rays_gnt`` over tiles of ``cfg.ray_tile`` rays (the
    last tile may be short); returns flat [n_rays, ...] outputs."""
    n_rays = rays_o.shape[0]
    outs = [
        render_rays_gnt(gnt_params, rays_o[i:i + cfg.ray_tile],
                        rays_d[i:i + cfg.ray_tile], dr[i:i + cfg.ray_tile],
                        tgt_cam, src_cams, maps, cfg)
        for i in range(0, n_rays, cfg.ray_tile)
    ]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


@torch.no_grad()
def render_image_gnt(models, tgt_cam, src_cams, src_rgbs, image_hw, depth_range,
                     cfg: RenderConfig, src_invalid_masks=None):
    """Render a full novel view with GNT.

    Args:
      models: (feature_net, gnt); tgt_cam [34]; src_cams [V, 34];
      src_rgbs [V, H, W, 3]; image_hw (H, W) of the target;
      depth_range [2] or [H, W, 2]; src_invalid_masks [V, H, W, 1]
      (1 = dynamic), read when ``cfg.gnt_use_dyn_mask``.

    Rays go through the pixels ``[::render_stride, ::render_stride]``.
    Returns [rh, rw, C] maps: rgb, depth, weights, inbound_cnt, dyn_cnt,
    view_std(+normalized), oob_mask and, with the dyn mask,
    dyn_mask_any / dyn_mask_all / dyn_mask_thres.
    """
    check_slice(cfg)
    if cfg.gnt_use_dyn_mask and src_invalid_masks is None:
        raise ValueError("gnt_use_dyn_mask needs the sources' dynamic masks")
    feature_net, gnt = models
    h, w = image_hw
    rays_o, rays_d, _uv, (rh, rw) = cameras.get_rays(
        h, w, cameras.flat_cam_intrinsics(tgt_cam), cameras.flat_cam_c2w(tgt_cam),
        stride=cfg.render_stride,
    )
    n_rays = rh * rw
    cfg, block = resolve_epipolar_cfg(cfg, gnt, rh, rw)
    maps = build_sampling_maps(cfg, src_rgbs, feature_net(src_rgbs), src_invalid_masks,
                               block)
    if depth_range.ndim == 1:
        dr = depth_range.expand(n_rays, 2)
    else:
        dr = depth_range[::cfg.render_stride, ::cfg.render_stride].reshape(-1, 2)
    inv_perm = None
    if block is not None:
        # consecutive groups of by*bx rays share one patch row per (sample,
        # view); the outputs are put back in image order below
        perm, inv_perm = patch_ray_perm(n_rays, rh, rw, *PATCH_BLOCKS[block][0],
                                        device=rays_o.device)
        rays_o, rays_d, dr = rays_o[perm], rays_d[perm], dr[perm]
    params = gnt
    if rays_o.device.type == "cuda" and not gnt.ret_view_std:
        params = pack_mono4_weights(gnt, rays_o.device)
    flat = render_rays_tiled(params, rays_o, rays_d, dr, tgt_cam, src_cams, maps, cfg)
    if inv_perm is not None:
        flat = {k: v[inv_perm] for k, v in flat.items()}
    out = {k: v.reshape((rh, rw) + v.shape[1:]) for k, v in flat.items()}
    n_src = src_rgbs.shape[0]
    out["oob_mask"] = (
        out["inbound_cnt"] < (cfg.mask_oob_n_proj_thres / n_src)
    ).float()
    if cfg.gnt_use_dyn_mask:
        dyn_cnt = out["dyn_cnt"]
        out["dyn_mask_any"] = (dyn_cnt > 0.0).float()
        out["dyn_mask_all"] = (dyn_cnt == 1.0).float()
        out["dyn_mask_thres"] = (
            dyn_cnt >= (cfg.mask_invalid_n_proj_thres / n_src)
        ).float()
    return out
