"""The pure-geometry cell's check: the program's static cloud, its outlier
decisions, its splat and the dynamic layer held against
``reference/geo.py`` and ``reference/render.py``.

The numbers of one view (each a share or a relative gap; the limits are in
``limits/<cell>.json``):

* ``geo_cloud``: the whole-video cloud the reader built, against
  ``geo.aggregate_static_cloud``'s rule on the written frames, frame by
  frame (``cloud_numbers``): the largest of the share of coverage
  decisions differing (ties left out: a point seen again by the camera
  that lifted it projects onto integer coordinates, where float32 decides
  the truncation), the relative gap in point count, and the relative RMS
  gap of the xyz of the points paired; ``geo_cloud_rgb``: the relative
  RMS gap of the pairs' colours (the reader decodes the JPEG frames, the
  reference reads the frames as written). Once a run: the cloud is the
  scene's.
* ``geo_knn``, ``geo_knn_worst``, ``geo_rule``: the static cloud's mean
  K-NN squared distances and outlier decisions, as ``check.py``'s
  ``dyn_knn``, ``dyn_knn_worst`` and ``dyn_rule`` (read where the static
  layer looks them up; ties left out).
* ``geo_static_rgb``: relative RMS gap of the static layer at the view's
  sampled pixels where both masks agree; ``geo_static_mask``: the share of
  the image's pixels whose mask differs. The reference splats the cloud
  the program rendered (held by ``geo_cloud``) under its own decisions;
  the pixels a tie covers are left out of both.
* ``dyn_knn``, ``dyn_knn_worst``, ``dyn_rule``, ``dyn_rgb``,
  ``combined_rgb``: as in ``check.py``, and the pixels a landing on an
  integer coordinate reaches left out too (``landing_ties``); the
  composite also leaves out the static ties' pixels and those whose static
  mask differs.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import check
from perfbench.reference import geo, render
from perfbench.reference import reader as rr

# what the configuration file states of the static layer and the resolved
# RenderConfig must agree on
GEO_KEYS = {
    "st_remove_outlier": "st_pcl_remove_outlier",
    "st_outlier_knn": "st_pcl_outlier_knn",
    "st_outlier_std": "st_pcl_outlier_std_thres",
    "st_point_radius": "st_render_pcl_pt_radius",
    "st_points_per_pixel": "st_render_pcl_pts_per_pixel",
}
DEPTH_BAND = 0.01  # the raster's relative depth band of the front surface
# a coverage test's tie: the reader stores its points in float32, which
# moves a projection by up to ~4e-5 px at 288x550 (a coordinate's ulp times
# the focal length over the depth); 1e-3 px leaves 25 times that
COVER_TIE_PX = 1e-3
# a softsplat landing's tie: the program projects in float32 (a landing at
# x ~ 500 px moves by ~3e-5 px), and a landing on an integer coordinate puts
# a vanishing bilinear weight on its neighbour, which sets that pixel's mask
# whole (loop seed 3000000041 read dyn_rgb 0.02 from x = 391.0 against
# 391.00003); landings within 1e-3 px of an integer reach ties
LAND_TIE_PX = 1e-3


def render_config(config):
    """The program's RenderConfig for the configuration file, checked
    against what the file states (``check.CFG_KEYS`` and ``GEO_KEYS``)."""
    rcfg = check.render_config(config)
    for key, field in GEO_KEYS.items():
        if getattr(rcfg, field) != config[key]:
            raise ValueError(f"configuration states {key}={config[key]!r}, the bundle "
                             f"resolves {field}={getattr(rcfg, field)!r}")
    return rcfg


def capture_static_decisions(drv):
    """Wrap the outlier removal where the static layer looks it up, keeping
    each call's decisions and means (read through ``drv.last_means``, which
    ``check.capture_outlier_decisions`` fills) in ``drv.geo_keep`` /
    ``drv.geo_means``; returns the restore triples, the dynamic layer's
    capture included."""
    from pgdvs_tpu_torch.renderers import static_geo

    restore = check.capture_outlier_decisions(drv)
    orig = static_geo.statistical_outlier_mask

    def recorded(*a, **kw):
        drv.last_means = None
        out = orig(*a, **kw)
        drv.geo_keep, drv.geo_means = out[0], drv.last_means
        drv.last_means = None
        return out

    static_geo.statistical_outlier_mask = recorded
    drv.geo_keep = drv.geo_means = None
    return restore + ((static_geo, "statistical_outlier_mask", orig),)


def kept_outputs(out, idx, drv):
    """What the check compares of one view, on the device (no
    synchronisation)."""
    return {
        "static_rgb": out["geo_static_rgb"].reshape(-1, 3)[idx],
        "static_mask": out["geo_static_mask"].reshape(-1),
        "combined": out["combined_rgb"].reshape(-1, 3)[idx],
        "dyn_rgb": out["render_dyn_rgb"],
        "geo_keep": drv.geo_keep, "geo_means": drv.geo_means,
        "keep": drv.last_keep, "means": drv.last_means,
    }


def reference_frames(scene, sources):
    """The frames ``geo.aggregate_static_cloud`` reads, from what the
    benchmark wrote (``reference/reader.py``'s reading of each file)."""
    frames = []
    for f in range(scene.n_frames):
        cam = rr.flat_cam(scene.eval_hw, scene.raw_hw, scene.c2w(f))
        src = sources[f]
        frames.append({"rgb": rr.half_rgb(src["rgb"]), "depth": rr.half_depth(src["depth"]),
                       "static": rr.half_mask(src["dyn_mask"]) == 0,
                       "k": cam[2:18].reshape(4, 4), "c2w": scene.c2w(f)})
    return frames


def capture_coverage(drv, dataset):
    """Keep, in ``drv.coverage``, each coverage test the reader makes while
    it aggregates the static cloud (the rows of the cloud so far and the
    pixels they cover), where the reader looks the test up."""
    orig = dataset._proj_mask
    drv.coverage = []

    def recorded(h, w, pcl, k4, w2c):
        out = orig(h, w, pcl, k4, w2c)
        drv.coverage.append((int(pcl.shape[0]), out.copy()))
        return out

    dataset._proj_mask = recorded


def program_cloud(xyz, rgb, coverage, n_frames):
    """The reader's cloud as ``geo.aggregate_static_cloud`` gives the
    reference's: the rows where each frame's additions start, from the
    coverage tests it recorded (one per frame after the first)."""
    if len(coverage) != n_frames - 1:
        raise RuntimeError(f"the reader made {len(coverage)} coverage tests for "
                           f"{n_frames} frames (data.nvidia_pure_geo._proj_mask not captured)")
    return {"xyz": xyz, "rgb": rgb, "starts": [0] + [n for n, _c in coverage] + [len(xyz)],
            "covered": [None] + [c for _n, c in coverage]}


def cloud_numbers(frames, cloud, tie_px=COVER_TIE_PX):
    """``geo_cloud`` and ``geo_cloud_rgb`` of a cloud (``program_cloud``,
    or the control's ``geo.aggregate_static_cloud``) against the frames.

    Frame by frame, on the cloud's own rows so far: the share of pixels
    whose coverage differs from ``geo.covered_pixels``' off its ties; the
    gap in rows added from the frame's static pixels left uncovered; the
    added rows paired in order with those pixels' reference points. A frame
    whose row count differs is left out of the pairing (its gap counts)."""
    xyz, rgb, starts, covered = cloud["xyz"], cloud["rgb"], cloud["starts"], cloud["covered"]
    wrong = tested = gap = 0
    got_x, got_c, want_x, want_c = [], [], [], []
    for i, fr in enumerate(frames):
        h, w = fr["depth"].shape
        cov = np.zeros(h * w, bool) if covered[i] is None else np.asarray(covered[i], bool)
        if i > 0:
            sure, maybe = geo.covered_pixels(xyz[:starts[i]], fr["k"], fr["c2w"], h, w, tie_px)
            wrong += int(((cov != sure) & ~(maybe & ~sure)).sum())
            tested += h * w
        add = np.asarray(fr["static"], bool).reshape(-1) & ~cov
        rows = slice(starts[i], starts[i + 1])
        if starts[i + 1] - starts[i] != int(add.sum()):
            gap += abs(starts[i + 1] - starts[i] - int(add.sum()))
            continue
        got_x.append(xyz[rows])
        got_c.append(rgb[rows])
        want_x.append(geo.unproject(fr)[add])
        want_c.append(np.asarray(fr["rgb"], np.float64).reshape(-1, 3)[add])

    def rel(a, b):
        if not a:
            return 1.0
        a, b = np.concatenate(a).astype(np.float64), np.concatenate(b)
        return float(np.sqrt(((a - b) ** 2).sum() / max((b * b).sum(), 1e-30)))

    return {"geo_cloud": max(wrong / max(tested, 1), gap / max(starts[-1], 1), rel(got_x, want_x)),
            "geo_cloud_rgb": rel(got_c, want_c)}


def rule_numbers(means, keep, own, own_keep, cand, thres, std_thres):
    """(RMS gap of the means over their median, largest gap over the
    threshold, share of decisions differing off the ties, ties [N]) of
    ``means`` / ``keep`` against the reference's ``own`` / ``own_keep``, as
    ``check.compare`` reads the dynamic layer's."""
    own_c = own[cand].double()
    gap = means[cand].double() - own_c
    thres_gap = abs(float(render.outlier_threshold(means, cand, std_thres)) - thres)
    tie = torch.zeros_like(cand)
    tie[cand] = (own_c - thres).abs() <= gap.abs() + thres_gap + check.TIE_SLACK * abs(thres)
    rule = float(((keep[cand] != own_keep[cand]) & ~tie[cand]).float().mean())
    return (float(gap.pow(2).mean().sqrt() / own_c.median()), float(gap.abs().max() / thres),
            rule, tie)


def reference_view(config, data, noise, points, colors, valid, rule, low=False):
    """The reference's (or, ``low``, the control's) view: the static splat
    under ``rule``'s decisions (``geo.static_outlier_rule`` on the cloud the
    program rendered: means, threshold, keep), the dynamic cloud, its rule
    and splat."""
    hw = tuple(data["rgb_src_temporal"].shape[1:3])
    geo_means, geo_thres, geo_keep = rule
    st_rgb, st_mask = geo.splat_points(points, colors, geo_keep, data["flat_cam_tgt"].float(),
                                       hw, config["st_point_radius"], DEPTH_BAND, low)
    d_points, cand = render.dynamic_cloud(data, config["flow_consistency"])
    d_means = render.knn_means(d_points, cand, config["dyn_outlier_knn"], low)
    d_thres = float(render.outlier_threshold(d_means, cand, config["dyn_outlier_std"]))
    d_keep = cand & (d_means.double() < d_thres)
    dyn_rgb, dyn_mask = render.splat_layer(data, noise, d_points, d_keep,
                                           config["softsplat_alpha"], low)
    m = dyn_mask.reshape(-1, 1)
    combined = (1.0 - m) * st_rgb.reshape(-1, 3) + m * dyn_rgb.reshape(-1, 3)
    return {"static_rgb": st_rgb.reshape(-1, 3), "static_mask": st_mask.reshape(-1),
            "combined": combined, "dyn_rgb": dyn_rgb, "geo_keep": geo_keep,
            "geo_means": geo_means, "geo_thres": geo_thres, "valid": valid,
            "points": points, "d_points": d_points, "cand": cand, "means": d_means,
            "keep": d_keep, "thres": d_thres}


def landing_ties(data, ref, tie_px=LAND_TIE_PX):
    """[H*W] bool: the reference's kept dynamic points whose landing in the
    target lies within ``tie_px`` of an integer coordinate."""
    uv, _front = render.project(render.projection(data["flat_cam_tgt"].float()),
                                ref["d_points"])
    frac = (uv - torch.round(uv)).abs()
    return ref["keep"] & (frac <= tie_px).any(-1)


def at_pixels(view, idx):
    """A reference or control view as the program's kept outputs."""
    return {**view, "static_rgb": view["static_rgb"][idx], "combined": view["combined"][idx]}


def compare(config, data, prog, ref, idx):
    """The numbers of one view (but the cloud's): ``prog`` the program's
    kept outputs (or the control's, ``at_pixels``), ``ref`` the
    reference's ``reference_view``."""
    for key in ("geo_means", "geo_keep", "means", "keep"):
        if prog[key] is None:
            raise RuntimeError("outlier removal is on but the program's K-NN means or "
                               "decisions were not captured (kernels.knn.knn_mean_sq_dist, "
                               "renderers.static_geo / renderers.dynamic."
                               "statistical_outlier_mask)")
    nums = {}
    hw = tuple(data["rgb_src_temporal"].shape[1:3])
    (nums["geo_knn"], nums["geo_knn_worst"], nums["geo_rule"], tie_s) = rule_numbers(
        prog["geo_means"], prog["geo_keep"], ref["geo_means"], ref["geo_keep"], ref["valid"],
        ref["geo_thres"], config["st_outlier_std"])
    reach_s = geo.footprint_reach(ref["points"], tie_s, data["flat_cam_tgt"].float(), hw,
                                  config["st_point_radius"])
    (nums["dyn_knn"], nums["dyn_knn_worst"], nums["dyn_rule"], tie_d) = rule_numbers(
        prog["means"], prog["keep"], ref["means"], ref["keep"], ref["cand"], ref["thres"],
        config["dyn_outlier_std"])
    reach_d = render.splat_reach(data, ref["d_points"], tie_d | landing_ties(data, ref))
    agree = prog["static_mask"] == ref["static_mask"]
    nums["geo_static_mask"] = float((~agree & ~reach_s).float().mean())
    at = (agree & ~reach_s)[idx]
    nums["geo_static_rgb"] = check.rel_rms(prog["static_rgb"][at], ref["static_rgb"][idx][at])
    free_d = ~reach_d
    nums["dyn_rgb"] = check.rel_rms(prog["dyn_rgb"].reshape(-1, 3)[free_d],
                                    ref["dyn_rgb"].reshape(-1, 3)[free_d])
    at = (agree & ~reach_s & free_d)[idx]
    nums["combined_rgb"] = check.rel_rms(prog["combined"][at], ref["combined"][idx][at])
    return nums
