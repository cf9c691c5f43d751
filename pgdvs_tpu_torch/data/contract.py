"""The renderer input contract.

Every dataset assembles, per novel view, the same dict of arrays the
reference datasets emit (reference ``pgdvs/datasets/nvidia_eval.py:545-604``,
documented at ``pgdvs_renderer.py:84-103``). Shapes below are for a single
view (the reference's B=1 unbatched); S = n spatial sources (10),
T = n temporal sources (2), K = track sources per side (5).

Keys marked (geo) only appear in pure-geometry mode; (track) only when a
tracker is enabled.
"""

RENDER_CONTRACT_KEYS = {
    "seq_ids": (13,),
    "rgb_tgt": ("H", "W", 3),
    "rgb_src_spatial": ("S", "H", "W", 3),
    "dyn_rgb_src_spatial": ("S", "H", "W", 3),
    "static_rgb_src_spatial": ("S", "H", "W", 3),
    "rgb_src_temporal": ("T", "H", "W", 3),
    "dyn_rgb_src_temporal": ("T", "H", "W", 3),
    "static_rgb_src_temporal": ("T", "H", "W", 3),
    "dyn_mask_src_spatial": ("S", "H", "W", 1),
    "dyn_mask_src_temporal": ("T", "H", "W", 1),
    "flow_fwd": ("H", "W", 2),
    "flow_fwd_occ_mask": ("H", "W", 1),
    "flow_bwd": ("H", "W", 2),
    "flow_bwd_occ_mask": ("H", "W", 1),
    "flat_cam_tgt": (34,),
    "flat_cam_src_spatial": ("S", 34),
    "flat_cam_src_temporal": ("T", 34),
    "depth_src_temporal": ("T", "H", "W", 1),
    "depth_range": (2,),  # or (H, W, 2) per-ray (DyCheck iPhone)
    "time_tgt": (1,),
    "time_src_temporal": ("T",),
    "eval_mask": ("H", "W", 3),
    # (geo)
    "st_pcl_rgb": ("N", 6),
    "st_pcl_valid": ("N",),
    # (track)
    "rgb_src_track_fwd": ("K", "H", "W", 3),
    "rgb_src_track_bwd": ("K", "H", "W", 3),
    "dyn_mask_src_track_fwd": ("K", "H", "W", 1),
    "dyn_mask_src_track_bwd": ("K", "H", "W", 1),
    "depth_src_track_fwd": ("K", "H", "W", 1),
    "depth_src_track_bwd": ("K", "H", "W", 1),
    "flat_cam_src_track_fwd": ("K", 34),
    "flat_cam_src_track_bwd": ("K", 34),
    "time_src_track_fwd": ("K",),
    "time_src_track_bwd": ("K",),
    "n_actual_src_track_fwd": (1,),
    "n_actual_src_track_bwd": (1,),
}
