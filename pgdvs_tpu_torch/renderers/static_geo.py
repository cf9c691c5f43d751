"""Static background from an aggregated point cloud (pure-geometry mode).

Counterpart of ``pgdvs_tpu.renderers.static_geo`` (the reference's
``StaticGeoPointRenderer``, ``st_geo_renderer.py``): optional statistical
outlier removal over the whole-video static cloud (``kernels/knn.py``,
same-set mode), then z-buffered point splatting into the target camera
(``kernels/point_raster.py``). Traced as ``static.geo``, its outlier
removal as ``static.geo.knn`` and its raster as ``static.geo.raster``; the
counter ``geo.points`` counts the cloud's rows (its shape: no
synchronisation).
"""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.kernels.knn import statistical_outlier_mask
from pgdvs_tpu_torch.kernels.point_raster import rasterize_points
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.utils import tracing


@torch.no_grad()
def render_static_geo(st_pcl_rgb, tgt_cam, image_hw, cfg: RenderConfig, valid=None):
    """Render the aggregated static point cloud.

    Args:
      st_pcl_rgb: [N, 6] packed (xyz, rgb), N a padded capacity (the
        dataset contract); tgt_cam: [34]; image_hw: (H, W).
      valid: [N] bool for padded entries.

    Returns rgb [H, W, 3] and mask [H, W, 1].
    """
    with tracing.span("static.geo", device=st_pcl_rgb.device):
        points, colors = st_pcl_rgb[:, :3], st_pcl_rgb[:, 3:6]
        tracing.count("geo.points", points.shape[0])
        if valid is None:
            valid = torch.ones((points.shape[0],), dtype=torch.bool, device=points.device)
        valid = valid.bool()
        if cfg.st_pcl_remove_outlier:
            with tracing.span("static.geo.knn", device=points.device):
                valid, _thres = statistical_outlier_mask(
                    points, valid, k=cfg.st_pcl_outlier_knn,
                    std_thres=cfg.st_pcl_outlier_std_thres)
        with tracing.span("static.geo.raster", device=points.device):
            return rasterize_points(points, colors, tgt_cam, image_hw, valid=valid,
                                    radius=cfg.st_render_pcl_pt_radius)
