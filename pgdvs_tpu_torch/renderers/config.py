"""Render configuration of the port.

Carries the semantic fields of ``pgdvs_tpu.renderers.config.RenderConfig``
(the reference's ``render_cfg`` block) plus ``ray_tile`` and
``epipolar_mode``. The JAX package's TPU knobs are not carried:
``use_pallas_gnt``, ``pallas_kernel``, ``pallas_ray_block``,
``pallas_precompute_kv``, ``pallas_ablate``, ``pallas_fold_*``,
``pallas_patch_block``, ``dyn_point_capacity``, ``track_queries_per_frame``,
``knn_tile`` and ``compiler_options_for``. On CUDA the port always runs a
hand kernel; which one follows from the semantic flags alone:

  patch sampling (no dyn mask)  K1 in its ``patch_rows`` mode
                                (``kernels/gnt_fused_patch.py``): raw patch
                                rows and stencil coefficients, combined in
                                the kernel; validity, ray-diff and point
                                code made in the kernel;
  quad sampling, no dyn mask    K1 (``kernels/gnt_fused.py``): the same on
                                sampled features;
  quad sampling, dyn mask       K2 (``kernels/gnt_fused_mono3.py``): validity
                                read from the sampler's mask;
  exact sampling, either        K2 in its unfolded mode (the same module's
                                ``gnt_fused_apply_mono3``), fed the mask,
                                the ray-diff code and the point code that
                                the exact sampler materializes, as the JAX
                                package's ``RenderConfig()`` runs mono3;
  fused sampling, either        K2, validity read from the sampler's mask
                                (the preset's mono3: fold_mask needs quad
                                or patch maps);
  quad_i8 sampling, no dyn mask K1 on the dequantized int8 quad samples
                                (the preset's mono4);
  quad_i8 sampling, dyn mask    K2, as quad with the dyn mask.

Under the JAX package's unforced flags, fused and quad_i8 run mono3 with
every operand read (K2 unfolded); the values agree to bf16 either way. A
GNT made with ``ret_view_std`` runs the plain network on every path, as
JAX's view-std diagnostics run its flax network.

K3 (``kernels/gnt_fused_split.py``, JAX's ``pallas_kernel="split"``) and
K2's other operand modes (fold_lerp behind ``epipolar_sample_quad_raw``,
fold_mask, pre-packed) are reached by direct call only, as no preset of the
JAX package picks them.

The port renders these slices of the configuration space so far: static
GNT with or without masked view attention (``gnt_use_dyn_mask``,
``pure_gnt_with_dyn_mask``), every epipolar sampler of the JAX package
(exact, the default and reference-faithful; fused, quad, quad_i8, patch),
coarse and fine samples, any render stride; or the static layer from the
aggregated point cloud (``static_mode="geo"``, with or without its outlier
removal, ``st_pcl_remove_outlier``); the dynamic layer by softsplat, the
point rasterizer or the grid mesh (``dyn_render_type``), with or without
statistical outlier removal (``dyn_pcl_remove_outlier``), with or without
the track branch (``dyn_render_track_temporal="no_tgt"`` and a tracker of
``models.tracking``: Lucas-Kanade or TAPIR; CoTracker is not ported).
``check_slice`` raises ValueError for an unknown mode; nothing falls back
silently.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- image / ray sampling -------------------------------------------
    render_stride: int = 1
    sample_inv_uniform: bool = True
    n_coarse_samples_per_ray: int = 256
    n_fine_samples_per_ray: int = 0

    # --- static (GNT) branch --------------------------------------------
    pure_gnt: bool = False
    pure_gnt_with_dyn_mask: bool = False
    gnt_use_dyn_mask: bool = False
    gnt_use_masked_spatial_src: bool = True
    mask_oob_n_proj_thres: int = 1
    mask_invalid_n_proj_thres: int = 4

    # --- static point-cloud branch (pure-geometry ablations) -------------
    st_pcl_remove_outlier: bool = False
    st_pcl_outlier_knn: int = 50
    st_pcl_outlier_std_thres: float = 0.1
    st_render_pcl_pt_radius: float = 0.01
    st_render_pcl_pts_per_pixel: int = 1

    # --- dynamic branch ---------------------------------------------------
    dyn_pcl_remove_outlier: bool = False
    dyn_pcl_outlier_knn: int = 50
    dyn_pcl_outlier_std_thres: float = 0.1
    dyn_render_type: str = "softsplat"  # softsplat | pcl | mesh
    dyn_render_pcl_pt_radius: float = 0.01
    dyn_render_pcl_pts_per_pixel: int = 1
    dyn_render_track_temporal: str = "none"  # none | no_tgt
    dyn_pcl_track_track2base_thres_mult: float = 50.0
    dyn_render_use_flow_consistency: bool = False
    softsplat_metric_abs_alpha: float = 100.0

    # --- execution ---------------------------------------------------------
    ray_tile: int = 2048        # rays per GNT call
    epipolar_mode: str = "exact"  # 'exact' (reference-faithful) | 'fused' | 'quad'
    #                               | 'quad_i8' | 'patch' (the JAX package's samplers)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def apply_perf_preset(cfg: RenderConfig) -> RenderConfig:
    """The fast sampler for ``cfg``, as the JAX package's preset picks it:
    patch sampling on 4x2 ray blocks without the dyn mask (one gather row
    per ray block, sample and view; the geometry decides the block at
    render time, ``static_gnt.resolve_epipolar_cfg``), quad sampling (one
    bilinear tap set per sample and view on the fused full-resolution map)
    with it, since the patch path carries no dyn mask."""
    return cfg.replace(epipolar_mode="quad" if cfg.gnt_use_dyn_mask else "patch")


def check_slice(cfg: RenderConfig, static_mode: str = "gnt") -> None:
    """Raise ValueError unless the port renders ``cfg``."""
    unsupported = {
        "static_mode not in ('gnt', 'geo')": static_mode not in ("gnt", "geo"),
        "epipolar_mode not in ('exact', 'fused', 'quad', 'quad_i8', 'patch')":
            cfg.epipolar_mode not in ("exact", "fused", "quad", "quad_i8", "patch"),
        "dyn_render_type not in ('softsplat', 'pcl', 'mesh')":
            cfg.dyn_render_type not in ("softsplat", "pcl", "mesh"),
        "dyn_render_track_temporal not in ('none', 'no_tgt')":
            cfg.dyn_render_track_temporal not in ("none", "no_tgt"),
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise ValueError(
            "configuration outside the ported slice: " + ", ".join(bad)
        )
