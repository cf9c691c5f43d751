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
         features and the dynamic masks (``ExactMaps``), then K3 (the split
         view / ray kernels, ``gnt_fused_split``), which reads the sampler's
         ray-diff code and mask; the counts come from the sampler's masks;
  quad   fused full-resolution maps (the dynamic mask as a trailing channel
         with the dyn mask), then K1 (validity recomputed in-kernel) without
         the dyn mask, K2 (validity read from the sampler's mask: in
         bounds, in front and not dynamic) with it, as the JAX package's
         preset splits them (mono4 / mono3).
"""

from __future__ import annotations

from typing import Dict

import torch

from pgdvs_tpu_torch.core import cameras, sampling
from pgdvs_tpu_torch.kernels.gnt_fused import gnt_fused_mono4, pack_mono4_weights
from pgdvs_tpu_torch.kernels.gnt_fused_mono3 import gnt_fused_mono3
from pgdvs_tpu_torch.kernels.gnt_fused_split import gnt_fused_split, pack_split_weights
from pgdvs_tpu_torch.models.gnt.feature_net import ResUNet
from pgdvs_tpu_torch.models.gnt.network import GNT, sinusoidal_embed
from pgdvs_tpu_torch.models.gnt.projector import (
    ExactMaps,
    build_fused_maps,
    epipolar_sample,
    epipolar_sample_quad,
    epipolar_sample_quad_masked,
)
from pgdvs_tpu_torch.renderers.config import RenderConfig, check_slice


def make_gnt_models(netwidth: int = 64, depth: int = 8, feat_ch: int = 32):
    """The (feature_net, gnt) pair, freshly initialised by torch."""
    return ResUNet(out_channels=feat_ch), GNT(netwidth, depth, feat_ch)


def init_gnt_models(seed: int = 0, device="cuda", **kw):
    """(feature_net, gnt) with random weights drawn from ``seed`` (torch's
    default initialisers), in eval mode on ``device``. The caller's global
    RNG state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        fnet, gnt = make_gnt_models(**kw)
    return fnet.to(device).eval(), gnt.to(device).eval()


def build_sampling_maps(cfg: RenderConfig, src_rgbs, feats, src_invalid_masks=None):
    """The per-image maps the sampler of ``cfg.epipolar_mode`` reads:
    ``ExactMaps`` (rgb and features in bf16, JAX's sample dtype; the dyn
    masks in float32) for exact, the fused [V, H, W, 3+F(+1)] bf16 maps for
    quad. The dyn masks are read only with ``cfg.gnt_use_dyn_mask``."""
    masks = src_invalid_masks if cfg.gnt_use_dyn_mask else None
    if cfg.epipolar_mode == "exact":
        return ExactMaps(src_rgbs.to(torch.bfloat16), feats.to(torch.bfloat16),
                         None if masks is None else masks.float())
    return build_fused_maps(src_rgbs, feats, masks)


def render_rays_gnt(gnt_params, rays_o, rays_d, depth_range, tgt_cam, src_cams,
                    maps, cfg: RenderConfig) -> Dict[str, torch.Tensor]:
    """Render a batch of rays.

    Args:
      gnt_params: the GNT module, or its weights packed for the rays'
        device (``SplitWeights`` for exact, ``Mono4Weights`` for quad).
      rays_o/rays_d [R, 3]; depth_range [R, 2]; tgt_cam [34];
      src_cams [V, 34]; maps: ``build_sampling_maps(cfg, ...)``.

    Returns rgb [R, 3], depth [R], weights [R, S], inbound_cnt [R],
    dyn_cnt [R] (zero without the dyn mask), view_std /
    view_std_normalized [R, depth+1] (zero: the diagnostics are not
    computed).
    """
    pts, z_vals = sampling.sample_along_rays(
        rays_o, rays_d, depth_range, cfg.n_coarse_samples_per_ray,
        inv_uniform=cfg.sample_inv_uniform,
    )
    view_code = sinusoidal_embed(rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True))
    smp = None
    if cfg.epipolar_mode == "exact":
        smp = epipolar_sample(pts, tgt_cam, src_cams, *maps)
        out = gnt_fused_split(gnt_params, smp["rgb_feat"], smp["ray_diff"], smp["mask"],
                              sinusoidal_embed(pts), view_code)
    else:
        proj = cameras.flat_cam_projection(src_cams)
        centers = torch.cat([
            cameras.flat_cam_c2w(tgt_cam)[None, :3, 3],
            cameras.flat_cam_c2w(src_cams)[:, :3, 3],
        ])
        if cfg.gnt_use_dyn_mask:
            smp = epipolar_sample_quad_masked(pts, proj, maps)
            out = gnt_fused_mono3(gnt_params, smp["rgb_feat"], smp["mask"], pts,
                                  view_code, centers)
        else:
            rgb_feat = epipolar_sample_quad(pts, proj, maps)
            _, map_h, map_w, _ = maps.shape
            out = gnt_fused_mono4(gnt_params, rgb_feat, pts, view_code, centers, proj,
                                  (map_h, map_w))
    weights = out["weights"]
    if smp is None:
        inbound_cnt = out["inbound_cnt_raw"]
        dyn_cnt = torch.zeros_like(inbound_cnt)
    else:
        # K3 returns no count and K2's is of mask views; the renderer's
        # counts are of in-bounds and of dynamic views (static_gnt.py:357-377
        # in JAX)
        n_src = src_cams.shape[0]
        inbound_cnt = torch.sum(weights * smp["mask_inbound"].sum(0) / n_src, dim=-1)
        dyn_cnt = torch.sum(weights * smp["mask_invalid"].sum(0) / n_src, dim=-1)
    gnt = gnt_params if isinstance(gnt_params, GNT) else gnt_params.gnt
    std = torch.zeros(weights.shape[:-1] + (gnt.depth + 1,),
                      dtype=torch.float32, device=weights.device)
    return {
        "rgb": out["rgb"],
        "depth": torch.sum(weights * z_vals, dim=-1),
        "weights": weights,
        "inbound_cnt": inbound_cnt,
        "dyn_cnt": dyn_cnt,
        "view_std": std,
        "view_std_normalized": std,
    }


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

    Returns [H, W, C] maps: rgb, depth, weights, inbound_cnt, dyn_cnt,
    view_std(+normalized), oob_mask and, with the dyn mask,
    dyn_mask_any / dyn_mask_all / dyn_mask_thres.
    """
    check_slice(cfg)
    if cfg.gnt_use_dyn_mask and src_invalid_masks is None:
        raise ValueError("gnt_use_dyn_mask needs the sources' dynamic masks")
    feature_net, gnt = models
    h, w = image_hw
    maps = build_sampling_maps(cfg, src_rgbs, feature_net(src_rgbs), src_invalid_masks)
    rays_o, rays_d, _uv, (rh, rw) = cameras.get_rays(
        h, w, cameras.flat_cam_intrinsics(tgt_cam), cameras.flat_cam_c2w(tgt_cam),
    )
    n_rays = rh * rw
    if depth_range.ndim == 1:
        dr = depth_range.expand(n_rays, 2)
    else:
        dr = depth_range.reshape(-1, 2)
    params = gnt
    if rays_o.device.type == "cuda":
        pack = pack_split_weights if cfg.epipolar_mode == "exact" else pack_mono4_weights
        params = pack(gnt, rays_o.device)
    flat = render_rays_tiled(params, rays_o, rays_d, dr, tgt_cam, src_cams, maps, cfg)
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
