"""Named benchmark / ablation bundles of the port.

The reference's curated ``benchmark_type`` names
(the reference's ``scripts/benchmark.sh:56-269``), copied whole from
``pgdvs_tpu.configs.benchmarks`` (the table is data): render_cfg overrides
plus static mode, dataset, dataset arguments, engine and tracker selection.
``resolve_benchmark(name, preset)`` turns one into the port's
``RenderConfig`` on the fast (patch, or quad with masked view attention)
or the exact sampler.

Name legend: st = static branch (cvd = consistent-video-depth point cloud,
gnt = transformer), dy = dynamic branch, pcl_clean = statistical outlier
removal, masked_attn / masked_input = GNT dynamic-mask handling, zoed =
ZoeDepth instead of CVD depth, track_* = occlusion recovery via tracking.

Every name resolves; ``make_tracker`` builds a bundle's tracker
(Lucas-Kanade or TAPIR) on the card unless asked for the CPU, and raises
ValueError for CoTracker, which is not ported; the CLI runs the
``visualize_nvidia_*`` bundles (``engine: "vis"``) through the Visualizer.
"""

from __future__ import annotations

from typing import Any, Dict

from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset

BENCHMARK_TYPES: Dict[str, Dict[str, Any]] = {
    "st_cvd_dy_cvd": {
        "static_mode": "geo",
        "dataset": "nvidia_eval_pure_geo",
        "render_cfg": dict(
            st_pcl_remove_outlier=False,
            dyn_pcl_remove_outlier=False,
            st_render_pcl_pt_radius=0.01,
            st_render_pcl_pts_per_pixel=3,
        ),
    },
    "st_cvd_dy_cvd_pcl_clean": {
        "static_mode": "geo",
        "dataset": "nvidia_eval_pure_geo",
        "render_cfg": dict(
            st_pcl_remove_outlier=False,
            dyn_pcl_remove_outlier=True,
            st_render_pcl_pt_radius=0.01,
            st_render_pcl_pts_per_pixel=3,
        ),
    },
    "st_cvd_pcl_clean_dy_cvd_pcl_clean": {
        "static_mode": "geo",
        "dataset": "nvidia_eval_pure_geo",
        "render_cfg": dict(
            st_pcl_remove_outlier=True,
            st_pcl_outlier_knn=50,
            st_pcl_outlier_std_thres=0.2,
            dyn_pcl_remove_outlier=True,
            st_render_pcl_pt_radius=0.01,
            st_render_pcl_pts_per_pixel=3,
        ),
    },
    "st_gnt": {
        "static_mode": "gnt",
        "render_cfg": dict(
            pure_gnt=True, gnt_use_dyn_mask=False, gnt_use_masked_spatial_src=False
        ),
    },
    "st_gnt_masked_attn": {
        "static_mode": "gnt",
        "render_cfg": dict(
            pure_gnt_with_dyn_mask=True,
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=False,
        ),
    },
    "st_gnt_dy_cvd": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=False,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=False,
        ),
    },
    "st_gnt_dy_cvd_pcl_clean": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=False,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=True,
        ),
    },
    "st_gnt_masked_input_dy_cvd": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=False,
            gnt_use_masked_spatial_src=True,
            dyn_pcl_remove_outlier=False,
        ),
    },
    "st_gnt_masked_input_attn_dy_cvd_pcl_clean": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=True,
            dyn_pcl_remove_outlier=True,
        ),
    },
    "st_gnt_masked_input_dy_cvd_pcl_clean": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=False,
            gnt_use_masked_spatial_src=True,
            dyn_pcl_remove_outlier=True,
        ),
    },
    # the paper's main configuration
    "default": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=True,
        ),
    },
    "st_gnt_masked_attn_dy_cvd_pcl_clean_render_point": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=True,
            dyn_render_type="pcl",
            dyn_render_pcl_pt_radius=0.01,
            dyn_render_pcl_pts_per_pixel=3,
        ),
    },
    "st_gnt_masked_attn_dy_cvd_pcl_clean_render_mesh": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=True,
            dyn_render_type="mesh",
        ),
    },
    "st_gnt_masked_attn_dy_zoed_pcl_clean": {
        "static_mode": "gnt",
        "render_cfg": dict(
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=True,
        ),
        "dataset_args": dict(
            use_zoe_depth="k_me_med_share",
            zoe_depth_data_path="nvidia_long_zoedepth",
        ),
    },
    "st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir": {
        "static_mode": "gnt",
        "tracker": "tapir",
        "render_cfg": dict(
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=True,
            dyn_render_track_temporal="no_tgt",
            dyn_pcl_track_track2base_thres_mult=50,
        ),
        "dataset_args": dict(with_track_sources=True),
    },
    "st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir_raw_res": {
        "static_mode": "gnt",
        "tracker": "tapir_raw_res",
        "render_cfg": dict(
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=True,
            dyn_render_track_temporal="no_tgt",
            dyn_pcl_track_track2base_thres_mult=50,
        ),
        "dataset_args": dict(with_track_sources=True),
    },
    "st_gnt_masked_attn_dy_cvd_pcl_clean_track_cotracker": {
        "static_mode": "gnt",
        "tracker": "cotracker",  # flax CoTracker port (needs the released
        #                          checkpoint; tracker='lk' is weight-free)
        "render_cfg": dict(
            gnt_use_dyn_mask=True,
            gnt_use_masked_spatial_src=False,
            dyn_pcl_remove_outlier=True,
            dyn_render_track_temporal="no_tgt",
            dyn_pcl_track_track2base_thres_mult=50,
        ),
        "dataset_args": dict(with_track_sources=True),
    },
    "visualize_nvidia_max_disp_32": {
        "static_mode": "gnt",
        "engine": "vis",
        "dataset": "nvidia_vis",
        "dataset_args": dict(
            n_render_frames=400,
            vis_center_time=50,
            vis_time_interval=50,
            vis_bt_max_disp=32,
        ),
        "render_cfg": dict(gnt_use_dyn_mask=True),
    },
    "visualize_nvidia_max_disp_64": {
        "static_mode": "gnt",
        "engine": "vis",
        "dataset": "nvidia_vis",
        "dataset_args": dict(
            n_render_frames=400,
            vis_center_time=50,
            vis_time_interval=50,
            vis_bt_max_disp=64,
        ),
        "render_cfg": dict(gnt_use_dyn_mask=True),
    },
}

# alias preserved from the reference
BENCHMARK_TYPES["st_gnt_masked_attn_dy_cvd_pcl_clean"] = BENCHMARK_TYPES["default"]


def resolve_benchmark(name: str, preset: str = "fast"):
    """Return (render_cfg, spec dict) for a named benchmark bundle.

    preset="fast" (default) applies ``apply_perf_preset``, as the JAX
    package does: the patch sampler for the unmasked bundles, the quad
    sampler for those with masked view attention; preset="exact" keeps the
    reference-faithful exact sampler.
    """
    if name not in BENCHMARK_TYPES:
        raise KeyError(f"unknown benchmark {name!r}; known: {sorted(BENCHMARK_TYPES)}")
    if preset not in ("fast", "exact"):
        raise KeyError(f"unknown perf preset {preset!r}; valid: fast | exact")
    spec = dict(BENCHMARK_TYPES[name])
    cfg = RenderConfig(**spec.get("render_cfg", {}))
    return (apply_perf_preset(cfg) if preset == "fast" else cfg), spec


# ROADMAP.md, queue 1, item 4 (the branches slice) carries CoTracker
COTRACKER_ITEM = "ROADMAP.md queue 1 item 4, the branches slice: track, CoTracker"


def make_tracker(name, device="cuda"):
    """The tracker a bundle names (its ``tracker`` entry) on ``device``
    (default the card, as ``Evaluator``'s):
    None for None / "none", ``LucasKanadeTracker()`` for "lk", TAPIR at
    256x256 for "tapir" and at the frames' size for "tapir_raw_res" (the
    released checkpoint under ``$PGDVS_CKPT_DIR``, else seeded random
    weights with a warning). "cotracker" raises ValueError (not ported);
    any other name KeyError."""
    if name in (None, "none"):
        return None
    if name == "lk":
        from pgdvs_tpu_torch.models.tracking import LucasKanadeTracker

        return LucasKanadeTracker()
    if name in ("tapir", "tapir_raw_res"):
        from pgdvs_tpu_torch.models.tracking.tapir import make_tapir_tracker

        return make_tapir_tracker(keep_raw_res=name == "tapir_raw_res", device=device)
    if name == "cotracker":
        raise ValueError(f"the 'cotracker' tracker is not ported yet ({COTRACKER_ITEM}); "
                         "the ported trackers are 'lk', 'tapir' and 'tapir_raw_res'")
    raise KeyError(f"unknown tracker {name!r}")
