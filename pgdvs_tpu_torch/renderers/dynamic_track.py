"""Track-based dynamic rendering: recover content occluded in the two
temporally closest frames.

Counterpart of ``pgdvs_tpu.renderers.dynamic_track`` (the reference's
``pgdvs_renderer_dyn_track.py``): a point tracker follows every
dynamic-mask pixel of the ±K track frames across the window; points that
are invisible in both temporally closest frames but visible in at least two
track frames are lifted to 3D at their two temporally nearest visible
frames, interpolated linearly to the target time, filtered by their
distance to the base dynamic cloud and among themselves, appended to the
base cloud and z-buffer rasterized.

The frames are stacked [T = 2K + 2] with a mask of the real track slots, and
the queries keep the JAX package's slot layout (every pixel of every frame,
dynamic ones first). The port then tracks only the valid queries: no
Lucas-Kanade or TAPIR track depends on another's, and the invalid ones yield
no point, so the cloud is built on the compacted set (and the KNN filters
compact it again); JAX's one call over all T * H * W slots would not fit a
card at full width. A tracker whose queries do share a call (CoTracker's
attention couples them) tells the renderer by its ``one_set`` attribute:
in one-set mode it gets JAX's whole slot layout and the valid mask, as
JAX's renderer hands them over; otherwise (``make_tracker``'s CoTracker
chunks the valid queries) the compacted valid queries, as the others.
The self filter is traced as ``dynamic.knn``, as the base cloud's.
"""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.core import cameras
from pgdvs_tpu_torch.core.geometry import uv_depth_to_world
from pgdvs_tpu_torch.core.interpolate import bilinear_sample, nearest_sample
from pgdvs_tpu_torch.kernels.knn import knn_mean_sq_dist, statistical_outlier_mask
from pgdvs_tpu_torch.kernels.point_raster import rasterize_points
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.utils import tracing

TRACK_KEYS = ("rgb", "dyn_mask", "depth", "flat_cam", "time")


def build_track_stack(data):
    """Stack [fwd track | temporal pair | bwd track] frame data (the
    reference's ``prepare_data``, pgdvs_renderer_dyn_track.py:599-764).

    The reference pads the track lists with copies of the temporal frames;
    ``real_track`` marks the slots that came from real extra frames
    (``n_actual_src_track_*``). Returns the stacked [T, ...] tensors
    (rgbs, masks, depths, cams, times), real_track [T] bool, idx_temporal
    and k.
    """
    k = data["rgb_src_track_fwd"].shape[0]
    stacked = {
        key: torch.cat([data[f"{key}_src_track_fwd"], data[f"{key}_src_temporal"],
                        data[f"{key}_src_track_bwd"]])
        for key in TRACK_KEYS
    }
    slot = torch.arange(2 * k + 2, device=stacked["rgb"].device)
    n_fwd = data["n_actual_src_track_fwd"][0].to(slot.device)
    n_bwd = data["n_actual_src_track_bwd"][0].to(slot.device)
    real_track = (slot < n_fwd) | ((slot >= k + 2) & (slot < k + 2 + n_bwd))
    return {
        "rgbs": stacked["rgb"],
        "masks": stacked["dyn_mask"],
        "depths": stacked["depth"],
        "cams": stacked["flat_cam"],
        "times": stacked["time"],
        "real_track": real_track,
        "idx_temporal": (k, k + 1),
        "k": k,
    }


def select_queries(stack, queries_per_frame: int):
    """Fixed-capacity query slots: the dynamic-mask pixels of each real
    track frame first, in a stable order (run_track,
    pgdvs_renderer_dyn_track.py:480-488).

    Returns queries [T * Q, 3] (t, x, y) and valid [T * Q] (the temporal
    slots and the slots past a frame's dynamic pixels are invalid).
    """
    t_total, h, w, _ = stack["masks"].shape
    flat = stack["masks"].reshape(t_total, h * w)
    order = torch.argsort(-flat, dim=1, stable=True)[:, :queries_per_frame]
    valid = (torch.gather(flat, 1, order) > 0) & stack["real_track"][:, None]
    t_col = torch.arange(t_total, device=flat.device)[:, None].expand_as(order)
    queries = torch.stack([t_col.float(), (order % w).float(), (order // w).float()], dim=-1)
    return queries.reshape(-1, 3), valid.reshape(-1)


def nearest_two(visibles, times, time_tgt):
    """Per query, the two visible frames nearest to ``time_tgt`` (the lower
    index first among equally near ones, as ``jax.lax.top_k``): [N, 2]."""
    time_diff = torch.abs(times[None, :] - time_tgt)
    time_diff = torch.where(visibles, time_diff, torch.full_like(time_diff, float("inf")))
    return torch.sort(time_diff, dim=1, stable=True).indices[:, :2]


def compute_track_pointcloud(stack, tracks, visibles, query_valid, time_tgt, base_points,
                             base_colors, base_valid, base_thres, cfg: RenderConfig,
                             stats=None):
    """Lift the valid occluded-track points to 3D at the target time
    (compute_pcl_for_tgt, pgdvs_renderer_dyn_track.py:98-396).

    Returns points [N, 3], colors [N, 3] and valid [N] (after the distance
    filter against the base cloud and the self filter at its threshold).
    ``stats``, where given, gets the points lifted and those kept after
    each filter.
    """
    t_total = stack["rgbs"].shape[0]
    i1, i2 = stack["idx_temporal"]
    vis_tc = visibles[:, i1] | visibles[:, i2]
    vis_cnt_track = torch.sum(visibles & stack["real_track"][None, :], dim=1)
    valid = query_valid & ~vis_tc & (vis_cnt_track >= 2)
    lifted = int(valid.sum()) if stats is not None else None
    top2 = nearest_two(visibles, stack["times"], time_tgt)

    # every frame's samples at the tracked positions; the top two are taken
    # below. The reference's rgb lookup shrinks the coordinate to
    # u * (w - 1) / w and its depth lookup samples at u - 0.5 (edge-clamped
    # here): both quirks kept, as the JAX package keeps them.
    h_f, w_f = stack["rgbs"].shape[1:3]
    rgb_all, pts_all = [], []
    for t in range(t_total):
        xy = tracks[:, t]
        rgb_all.append(bilinear_sample(stack["rgbs"][t], xy[:, 0] * (w_f - 1) / w_f,
                                       xy[:, 1] * (h_f - 1) / h_f))
        depth = nearest_sample(stack["depths"][t], xy[:, 0] - 0.5, xy[:, 1] - 0.5)[:, 0]
        cam = stack["cams"][t]
        pts_all.append(uv_depth_to_world(xy, depth, cameras.flat_cam_intrinsics(cam),
                                         cameras.flat_cam_c2w(cam)))
    rgb_all = torch.stack(rgb_all, dim=1)
    pts_all = torch.stack(pts_all, dim=1)

    idx = top2[:, :, None].expand(-1, -1, 3)
    p12 = torch.gather(pts_all, 1, idx)
    c12 = torch.gather(rgb_all, 1, idx)
    t12 = stack["times"][top2]
    ratio = (time_tgt - t12[:, 0:1]) / (t12[:, 1:2] - t12[:, 0:1] + 1e-8)
    points = p12[:, 0] + (p12[:, 1] - p12[:, 0]) * ratio
    colors = torch.mean(c12, dim=1)

    # the distance filter against the base dynamic cloud (mean over K + 1)
    d2base = knn_mean_sq_dist(points, valid, k=cfg.dyn_pcl_outlier_knn + 1,
                              candidates=base_points, cand_valid=base_valid,
                              exclude_self=False)
    valid = valid & (d2base < base_thres * cfg.dyn_pcl_track_track2base_thres_mult)
    # the self filter at the base cloud's threshold
    with tracing.span("dynamic.knn", device=points.device):
        keep, _ = statistical_outlier_mask(points, valid, k=cfg.dyn_pcl_outlier_knn,
                                           std_thres=cfg.dyn_pcl_outlier_std_thres,
                                           dist_thres=base_thres)
    if stats is not None:
        stats.update(lifted=lifted, kept_base_filter=int(valid.sum()),
                     kept_self_filter=int(keep.sum()))
    return points, colors, keep


def render_with_track(data, cfg: RenderConfig, tracker, base_pcl: dict):
    """The track branch: track -> lift -> filter -> merge -> rasterize.

    Args:
      data: the contract incl. the track-source keys.
      tracker: callable (frames, queries, valid) -> (tracks, visibles).
      base_pcl: points / colors / valid / nn_dist_thres of the base cloud
        (``dynamic.compute_dyn_pointcloud``).

    Every dynamic pixel of the real track frames is a query (the JAX
    package's default capacity, ``track_queries_per_frame=0``). A tracker
    with ``one_set`` true gets every slot and the valid mask; any other the
    valid queries alone.

    Returns {'rgb': [H, W, 3], 'mask': [H, W, 1]}.
    """
    h, w = data["rgb_src_temporal"].shape[1:3]
    stack = build_track_stack(data)
    queries, q_valid = select_queries(stack, h * w)
    dev = base_pcl["points"].device
    if bool(q_valid.any()):
        if getattr(tracker, "one_set", False):
            tracks, visibles = tracker(stack["rgbs"], queries, q_valid)
        else:
            queries = queries[q_valid]
            q_valid = torch.ones((queries.shape[0],), dtype=torch.bool, device=dev)
            tracks, visibles = tracker(stack["rgbs"], queries)
        points, colors, valid = compute_track_pointcloud(
            stack, tracks, visibles, q_valid, data["time_tgt"][0], base_pcl["points"],
            base_pcl["colors"], base_pcl["valid"], base_pcl["nn_dist_thres"], cfg)
    else:
        points = colors = torch.zeros((0, 3), device=dev)
        valid = torch.zeros((0,), dtype=torch.bool, device=dev)
    rgb, mask = rasterize_points(
        torch.cat([points, base_pcl["points"]]), torch.cat([colors, base_pcl["colors"]]),
        data["flat_cam_tgt"], (h, w), valid=torch.cat([valid, base_pcl["valid"]]),
        radius=cfg.dyn_render_pcl_pt_radius)
    return {"rgb": rgb, "mask": mask}
