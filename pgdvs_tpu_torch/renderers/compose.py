"""Top-level novel-view renderer: static + dynamic + composite.

Counterpart of ``pgdvs_tpu.renderers.compose.render_novel_view`` on the
ported slices, with the same output keys: the static background from GNT
(masked view attention reads ``dyn_mask_src_spatial``) or from the
aggregated point cloud (``static_mode="geo"``: ``st_pcl_rgb`` /
``st_pcl_valid``, no models), the dynamic foreground
(``renderers.dynamic``, with the track branch where a tracker is given),
composited as
``(1 - dyn_mask) * static + dyn_mask * dyn``; ``pure_gnt`` and
``pure_gnt_with_dyn_mask`` return the static layer alone. With a
``render_stride`` the static layer is rendered on every stride-th pixel and
the full-resolution dynamic layer is brought to its size first, as the JAX
package does: the rgb by ``jax.image.resize``'s cubic, the mask by its
nearest, then > 0 (``core.interpolate.resize``).
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from pgdvs_tpu_torch.core.interpolate import resize
from pgdvs_tpu_torch.renderers.config import RenderConfig, check_slice
from pgdvs_tpu_torch.renderers.dynamic import render_dynamic
from pgdvs_tpu_torch.renderers.static_geo import render_static_geo
from pgdvs_tpu_torch.renderers.static_gnt import render_image_gnt
from pgdvs_tpu_torch.utils import tracing

_view_ids = itertools.count()  # the root id of each view's span


@torch.no_grad()
def render_novel_view(models, data, cfg: RenderConfig,
                      generator: Optional[torch.Generator] = None,
                      static_mode: str = "gnt",
                      noise: Optional[torch.Tensor] = None, tracker=None):
    """Render one novel (space, time) view.

    Args:
      models: (feature_net, gnt) modules on the data's device (unused, and
        may be None, for static_mode="geo").
      data: the renderer input contract for one view as tensors
        (``pgdvs_tpu_torch.data.contract``).
      cfg: a RenderConfig inside the ported slice (else ValueError).
      generator: torch.Generator for the dynamic branch's noise.
      static_mode: "gnt" or "geo".
      noise: optional [H, W, 3] standard-normal draw used instead.
      tracker: optional point tracker (``models.tracking``), which runs the
        track branch under ``dyn_render_track_temporal="no_tgt"``.

    Returns a dict with combined_rgb and the intermediates the JAX
    renderer returns. Traced as the root span ``view``.
    """
    check_slice(cfg, static_mode)
    with tracing.span("view", device=data["rgb_src_temporal"].device,
                      root_id=next(_view_ids)):
        return _render_novel_view(models, data, cfg, generator, static_mode, noise, tracker)


def _render_novel_view(models, data, cfg, generator, static_mode, noise, tracker):
    h, w = data["rgb_src_temporal"].shape[1:3]
    if static_mode == "geo":
        static_rgb, static_mask = render_static_geo(
            data["st_pcl_rgb"], data["flat_cam_tgt"], (h, w), cfg,
            valid=data.get("st_pcl_valid"))
        ret = {"geo_static_rgb": static_rgb, "geo_static_mask": static_mask}
    else:
        src_rgbs = (data["static_rgb_src_spatial"] if cfg.gnt_use_masked_spatial_src
                    else data["rgb_src_spatial"])
        st = render_image_gnt(models, data["flat_cam_tgt"],
                              data["flat_cam_src_spatial"], src_rgbs, (h, w),
                              data["depth_range"], cfg,
                              src_invalid_masks=data.get("dyn_mask_src_spatial"))
        ret = {f"static_coarse_{k}": v for k, v in st.items()}
        static_rgb = st["rgb"]
        if cfg.pure_gnt or cfg.pure_gnt_with_dyn_mask:
            ret["combined_rgb"] = static_rgb
            return ret

    dyn = render_dynamic(data, cfg, generator=generator, noise=noise, tracker=tracker)
    dyn_rgb, dyn_mask = dyn["rgb"], dyn["mask"]
    if cfg.render_stride > 1:
        rh, rw = static_rgb.shape[:2]
        dyn_rgb = resize(dyn_rgb, rh, rw, "cubic")
        dyn_mask = (resize(dyn_mask, rh, rw, "nearest") > 0).float()
    ret.update({
        "render_dyn_rgb": dyn_rgb,
        "render_dyn_mask": dyn_mask,
        "render_dyn_temporal_closest_rgb": dyn["temporal_closest_rgb"],
        "render_dyn_temporal_closest_mask": dyn["temporal_closest_mask"],
        "render_dyn_temporal_track_rgb": dyn["temporal_track_rgb"],
        "render_dyn_temporal_track_mask": dyn["temporal_track_mask"],
        "combined_rgb": (1.0 - dyn_mask) * static_rgb + dyn_mask * dyn_rgb,
        "combined_rgb_static": (1.0 - dyn_mask) * static_rgb,
        "combined_rgb_dyn": dyn_mask * dyn_rgb,
    })
    return ret
