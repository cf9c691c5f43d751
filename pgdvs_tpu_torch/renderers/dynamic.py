"""Dynamic-foreground rendering: a depth + flow point cloud, splatted.

Counterpart of ``pgdvs_tpu.renderers.dynamic``. Every pixel of temporal source 1 is a candidate point: lifted by
its depth, advected by flow into frame 2, lifted again there, interpolated
linearly to the target time, optionally cleaned by statistical outlier
removal (``dyn_pcl_remove_outlier``), then rendered by ``dyn_render_type``:
``softsplat`` (projected into the target camera and softmax-splatted with
static-region colours replaced by clamped gaussian noise so they lose
contested pixels), ``pcl`` (the z-buffered point rasterizer,
``kernels/point_raster.py``) or ``mesh`` (the pixel-grid mesh rasterizer,
``kernels/mesh_raster.py``). The cloud stays the dense H*W buffer, the JAX
package's default (its ``dyn_point_capacity`` of 0). With a tracker and
``dyn_render_track_temporal="no_tgt"`` the track branch
(``renderers/dynamic_track.py``) renders the content the two temporally
closest frames do not see, and fills the pixels the layer leaves uncovered
(pgdvs_renderer_dyn.py:229-235); without a tracker that branch is skipped,
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from pgdvs_tpu_torch.core import cameras
from pgdvs_tpu_torch.core.geometry import uv_depth_to_world
from pgdvs_tpu_torch.core.interpolate import bilinear_sample, nearest_sample
from pgdvs_tpu_torch.kernels.knn import statistical_outlier_mask
from pgdvs_tpu_torch.kernels.mesh_raster import rasterize_grid_mesh
from pgdvs_tpu_torch.kernels.point_raster import rasterize_points
from pgdvs_tpu_torch.kernels.softsplat import brightness_metric, softsplat
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.renderers.dynamic_track import render_with_track
from pgdvs_tpu_torch.utils import tracing


def compute_dyn_pointcloud(*, rgb_1, dyn_mask_1, depth_1, flow_12,
                           flow_12_occ_mask, rgb_2, depth_2, cam_1, cam_2,
                           cam_tgt, time_1, time_2, time_tgt,
                           cfg: RenderConfig):
    """The time-interpolated dynamic point cloud (dense, masked).

    Images [H, W, C]; cams flat-34; times scalars. Returns points [H*W, 3],
    colors [H*W, 3], valid [H*W] bool (dynamic, flow in bounds and, with
    ``dyn_pcl_remove_outlier``, not an outlier), flow_to_tgt [H, W, 2],
    valid_mask_img [H, W, 1] and nn_dist_thres, the outlier threshold the
    track branch reuses (0 when neither needs it).
    """
    h, w, _ = rgb_1.shape
    k2, c2w2 = cameras.flat_cam_intrinsics(cam_2), cameras.flat_cam_c2w(cam_2)
    rays_o, rays_d, uv, _ = cameras.get_rays(
        h, w, cameras.flat_cam_intrinsics(cam_1), cameras.flat_cam_c2w(cam_1)
    )
    pcl_1 = rays_o + rays_d * depth_1.reshape(-1, 1)

    dyn = dyn_mask_1.reshape(-1) > 0
    if cfg.dyn_render_use_flow_consistency:
        dyn = dyn & ~(flow_12_occ_mask.reshape(-1) > 0)
    uv_flow = uv + flow_12.reshape(-1, 2)
    flow_ok = (
        (uv_flow[:, 0] >= 0) & (uv_flow[:, 0] <= w - 1.0)
        & (uv_flow[:, 1] >= 0) & (uv_flow[:, 1] <= h - 1.0)
    )
    valid = dyn & flow_ok

    # frame-2 lookups at the advected uv (align_corners=False == uv - 0.5)
    x2, y2 = uv_flow[:, 0] - 0.5, uv_flow[:, 1] - 0.5
    depth_f2 = nearest_sample(depth_2, x2, y2)[..., 0]
    rgb_f2 = bilinear_sample(rgb_2, x2, y2)
    pcl_2 = uv_depth_to_world(uv_flow, depth_f2, k2, c2w2)

    with tracing.span("sync"):
        t_2 = float(time_2)
    with tracing.span("sync"):
        t_1 = float(time_1)
    same_time = bool(abs(t_2 - t_1) < 1e-9)
    if same_time:
        points, colors = pcl_1, rgb_1.reshape(-1, 3)
    else:
        denom = time_2 - time_1
        points = ((time_2 - time_tgt) / denom) * pcl_1 + (
            (time_tgt - time_1) / denom) * pcl_2
        colors = rgb_f2

    nn_dist_thres = torch.zeros((), dtype=torch.float32, device=points.device)
    if cfg.dyn_pcl_remove_outlier or cfg.dyn_render_track_temporal != "none":
        with tracing.span("dynamic.knn", device=points.device):
            keep, nn_dist_thres = statistical_outlier_mask(
                points, valid, k=cfg.dyn_pcl_outlier_knn,
                std_thres=cfg.dyn_pcl_outlier_std_thres,
            )
        if cfg.dyn_pcl_remove_outlier:
            valid = keep

    with tracing.span("sync"):  # inverse_se3's scalar store into a single camera
        uv_tgt, _z, _front = cameras.project_points(points, cam_tgt)
    flow_to_tgt = torch.where(valid[:, None], uv_tgt - uv,
                              torch.zeros_like(uv)).reshape(h, w, 2)
    return {
        "points": points,
        "colors": colors,
        "valid": valid,
        "flow_to_tgt": flow_to_tgt,
        "valid_mask_img": valid.float().reshape(h, w, 1),
        "nn_dist_thres": nn_dist_thres,
    }


def render_dynamic(data, cfg: RenderConfig,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None, tracker=None):
    """Render the dynamic layer for one novel view.

    With softsplat the static-region colours are replaced by
    ``clamp(noise, 0, 1)``, where noise is a standard normal [H, W, 3]
    drawn from ``generator`` unless it is given directly; pcl and mesh
    draw no noise. ``tracker`` (``models.tracking``) runs the track branch
    under ``dyn_render_track_temporal="no_tgt"``.

    Returns rgb [H, W, 3], mask [H, W, 1] and the per-branch intermediates.
    Traced as ``dynamic``, the K-NN outlier removal as ``dynamic.knn``, the
    softsplat branch's brightness metric and splats as ``dynamic.splat``.
    """
    with tracing.span("dynamic", device=data["rgb_src_temporal"].device):
        return _render_dynamic(data, cfg, generator, noise, tracker)


def _render_dynamic(data, cfg, generator, noise, tracker):
    rgb_t = data["rgb_src_temporal"]
    h, w = rgb_t.shape[1:3]
    pcl = compute_dyn_pointcloud(
        rgb_1=rgb_t[0],
        dyn_mask_1=data["dyn_mask_src_temporal"][0],
        depth_1=data["depth_src_temporal"][0],
        flow_12=data["flow_fwd"],
        flow_12_occ_mask=data["flow_fwd_occ_mask"],
        rgb_2=rgb_t[1],
        depth_2=data["depth_src_temporal"][1],
        cam_1=data["flat_cam_src_temporal"][0],
        cam_2=data["flat_cam_src_temporal"][1],
        cam_tgt=data["flat_cam_tgt"],
        time_1=data["time_src_temporal"][0],
        time_2=data["time_src_temporal"][1],
        time_tgt=data["time_tgt"][0],
        cfg=cfg,
    )
    if cfg.dyn_render_type == "pcl":
        rgb, mask = rasterize_points(pcl["points"], pcl["colors"], data["flat_cam_tgt"],
                                     (h, w), valid=pcl["valid"],
                                     radius=cfg.dyn_render_pcl_pt_radius)
    elif cfg.dyn_render_type == "mesh":
        rgb, mask = rasterize_grid_mesh(pcl["points"], pcl["colors"], pcl["valid"],
                                        data["flat_cam_tgt"], (h, w))
    elif cfg.dyn_render_type == "softsplat":
        dyn_mask = pcl["valid_mask_img"]
        if noise is None:
            noise = torch.randn(rgb_t[0].shape, generator=generator,
                                dtype=rgb_t.dtype, device=rgb_t.device)
        noise = torch.clamp(noise, 0.0, 1.0)
        rgb_1_rand = rgb_t[0] * dyn_mask + noise * (1.0 - dyn_mask)
        with tracing.span("dynamic.splat", device=rgb_t.device):
            metric = brightness_metric(rgb_1_rand, rgb_t[1], data["flow_fwd"],
                                       cfg.softsplat_metric_abs_alpha)
            splat_rgb = softsplat(rgb_1_rand, pcl["flow_to_tgt"], metric, mode="soft")
            splat_mask = softsplat(dyn_mask, pcl["flow_to_tgt"], metric, mode="soft")
        mask = (splat_mask > 1e-3).float()
        rgb = splat_rgb * mask
    else:
        raise ValueError(f"unknown dyn_render_type={cfg.dyn_render_type!r}")
    out = {"temporal_closest_rgb": rgb, "temporal_closest_mask": mask, "pcl": pcl}
    if tracker is not None and cfg.dyn_render_track_temporal == "no_tgt":
        track = render_with_track(data, cfg, tracker, base_pcl=pcl)
        m_track = (~(mask > 0) & (track["mask"] > 0)).float()
        rgb = (1.0 - m_track) * rgb + m_track * track["rgb"]
        mask = ((mask > 0) | (track["mask"] > 0)).float()
        out.update(temporal_track_rgb=track["rgb"], temporal_track_mask=track["mask"])
    else:
        out.update(temporal_track_rgb=torch.zeros_like(rgb),
                   temporal_track_mask=torch.zeros_like(mask))
    out.update(rgb=rgb, mask=mask)
    return out
