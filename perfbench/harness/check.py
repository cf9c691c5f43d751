"""What every driver shares: the program set up from a configuration, what
the check keeps of a view, and the view held against the reference.

The numbers of one view (each a share or a relative gap; ``limits/<cell>.json``
holds their limits):

* ``static_rgb``, ``static_depth``, ``combined_rgb``: relative RMS gaps at
  the view's sampled pixels (ResUNet, sampler, GNT, composite);
* with outlier removal on, from the program's mean K-NN squared distances
  and its decisions (both read where the program looks them up):
  ``dyn_knn``, the RMS gap of the means from exact ones over their median;
  ``dyn_knn_worst``, the largest gap of one point's mean over the
  reference's threshold; ``dyn_rule``, the share of candidates whose
  decision differs from the rule (median + t * std) on the exact means,
  ties left out;
* ``dyn_rgb``: relative RMS gap of the dynamic layer (masked by its mask, so
  a pixel whose mask differs counts whole) from the reference splatting its
  own decisions.

A tie is a candidate whose exact mean lies nearer the exact threshold than
the float32 gap measured at that point explains: its mean's gap plus the
gap of the threshold that the rule gives on the program's means (plus
``TIE_SLACK`` of the threshold, for that threshold's own float32 rounding).
A program that applies the rule to its own means can flip a tie and
nothing else; how far its means may err is ``dyn_knn_worst``'s limit. Ties
are left out of ``dyn_rule``, and the pixels they reach
(``render.splat_reach``) out of ``dyn_rgb`` and ``combined_rgb``.
"""

from __future__ import annotations

import torch

from perfbench.reference import nets, render

# what the configuration file states and the resolved RenderConfig must agree on
CFG_KEYS = {
    "gnt_use_dyn_mask": "gnt_use_dyn_mask",
    "masked_spatial_src": "gnt_use_masked_spatial_src",
    "dyn_remove_outlier": "dyn_pcl_remove_outlier",
    "dyn_outlier_knn": "dyn_pcl_outlier_knn",
    "dyn_outlier_std": "dyn_pcl_outlier_std_thres",
    "softsplat_alpha": "softsplat_metric_abs_alpha",
    "flow_consistency": "dyn_render_use_flow_consistency",
    "sampler": "epipolar_mode",
    "dyn_render": "dyn_render_type",
}
TIE_SLACK = 1e-5


def render_config(config):
    """The program's RenderConfig for the configuration file, checked
    against what the file states."""
    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark

    rcfg, _spec = resolve_benchmark(config["bundle"], config["preset"])
    rcfg = rcfg.replace(n_coarse_samples_per_ray=config["n_coarse_samples"],
                        n_fine_samples_per_ray=config["n_fine_samples"],
                        ray_tile=config["ray_tile"])
    for key, field in CFG_KEYS.items():
        if getattr(rcfg, field) != config[key]:
            raise ValueError(f"configuration states {key}={config[key]!r}, the bundle "
                             f"resolves {field}={getattr(rcfg, field)!r}")
    return rcfg


def rel_rms(p, r):
    return float(torch.sqrt(((p.float() - r.float()) ** 2).sum()
                            / torch.clamp((r.float() ** 2).sum(), min=1e-30)))


def compare(config, data, prog, ref):
    """The numbers of one view: ``prog`` the program's (or the control's)
    kept outputs, ``ref`` the reference's (``reference_view`` completed by
    ``with_dynamic`` with its own decisions)."""
    nums = {}
    reach = torch.zeros_like(ref["cand"])
    if ref["own_means"] is not None:
        if prog["means"] is None or prog["keep"] is None:
            raise RuntimeError("outlier removal is on but the program's K-NN means or "
                               "decisions were not captured (kernels.knn.knn_mean_sq_dist, "
                               "renderers.dynamic.statistical_outlier_mask)")
        cand, thres = ref["cand"], ref["thres"]
        own = ref["own_means"][cand].double()
        gap = prog["means"][cand].double() - own
        nums["dyn_knn"] = float(gap.pow(2).mean().sqrt() / own.median())
        nums["dyn_knn_worst"] = float(gap.abs().max() / thres)
        thres_gap = abs(float(render.outlier_threshold(prog["means"], cand,
                                                       config["dyn_outlier_std"])) - thres)
        tie = torch.zeros_like(cand)
        tie[cand] = (own - thres).abs() <= gap.abs() + thres_gap + TIE_SLACK * abs(thres)
        nums["dyn_rule"] = float(((prog["keep"][cand] != ref["own_keep"][cand]) & ~tie[cand])
                                 .float().mean())
        reach = render.splat_reach(data, ref["points"], tie)
    free = ~reach
    at = free[ref["idx"]]
    nums.update({
        "static_rgb": rel_rms(prog["static_rgb"], ref["static_rgb"]),
        "static_depth": rel_rms(prog["static_depth"], ref["static_depth"]),
        "dyn_rgb": rel_rms(prog["dyn_rgb"].reshape(-1, 3)[free],
                           ref["dyn_rgb"].reshape(-1, 3)[free]),
        "combined_rgb": rel_rms(prog["combined"][at], ref["combined"][at]),
    })
    return nums


def failed_views(per_view, limits):
    """How many views read over a limit in any number."""
    return sum(any(v[k] > limits[k] for k in limits) for v in per_view)


def worst(per_view):
    keys = per_view[0].keys() if per_view else []
    return {k: max(v[k] for v in per_view) for k in keys}


def meta_models(config, device):
    """The program's (feature_net, gnt), allocated on ``device`` without
    initialisation (the seeded state is loaded next)."""
    from pgdvs_tpu_torch.renderers.static_gnt import make_gnt_models

    with torch.device("meta"):
        fnet, gnt = make_gnt_models(config["netwidth"], config["depth"], config["feat_ch"])
    return fnet.to_empty(device=device).eval(), gnt.to_empty(device=device).eval()


def reference_models(config, states, device):
    with torch.device("meta"):
        resunet = nets.ResUNet(out_channels=config["feat_ch"])
        gnt = nets.GNT(config["netwidth"], config["depth"], config["feat_ch"])
    resunet, gnt = resunet.to_empty(device=device).eval(), gnt.to_empty(device=device).eval()
    resunet.load_state_dict(states[0])
    gnt.load_state_dict(states[1])
    return resunet, gnt


def kept_outputs(out, idx, kept_points, means):
    """What the check compares, gathered on the device (no synchronisation);
    ``kept_points`` and ``means``: the program's outlier decisions and mean
    K-NN squared distances (None: not captured)."""
    return {
        "static_rgb": out["static_coarse_rgb"].reshape(-1, 3)[idx],
        "static_depth": out["static_coarse_depth"].reshape(-1)[idx],
        "combined": out["combined_rgb"].reshape(-1, 3)[idx],
        "dyn_rgb": out["render_dyn_rgb"],
        "keep": kept_points,
        "means": means,
    }


def capture_outlier_decisions(drv):
    """Wrap the program's outlier removal where its dynamic layer looks it
    up, and its K-NN means where the removal looks them up, keeping each
    call's decisions and means in ``drv.last_keep`` / ``drv.last_means``;
    returns the restore triples."""
    from pgdvs_tpu_torch.kernels import knn
    from pgdvs_tpu_torch.renderers import dynamic

    orig_mask, orig_means = dynamic.statistical_outlier_mask, knn.knn_mean_sq_dist

    def recorded_mask(*a, **kw):
        out = orig_mask(*a, **kw)
        drv.last_keep = out[0]
        return out

    def recorded_means(*a, **kw):
        out = orig_means(*a, **kw)
        drv.last_means = out
        return out

    dynamic.statistical_outlier_mask = recorded_mask
    knn.knn_mean_sq_dist = recorded_means
    drv.last_keep = drv.last_means = None
    return (dynamic, "statistical_outlier_mask", orig_mask), (knn, "knn_mean_sq_dist", orig_means)


def restore(triples):
    for module, attr, orig in triples:
        setattr(module, attr, orig)


def reference_view(config, ref_models, feats, data, idx, low=False):
    """The reference's (or, ``low``, the control's) static layer at the
    sampled pixels ``idx``, its dynamic cloud, its own K-NN means, threshold
    and outlier decisions."""
    rgb, depth = render.static_rays(ref_models[1], feats, data, idx, config["sampler"],
                                    config["n_coarse_samples"], config["gnt_use_dyn_mask"],
                                    low=low)
    points, cand = render.dynamic_cloud(data, config["flow_consistency"])
    means, own, thres = None, cand, None
    if config["dyn_remove_outlier"]:
        means = render.knn_means(points, cand, config["dyn_outlier_knn"], low)
        thres = float(render.outlier_threshold(means, cand, config["dyn_outlier_std"]))
        own = cand & (means.double() < thres)
    return {"static_rgb": rgb, "static_depth": depth, "points": points, "cand": cand,
            "own_means": means, "own_keep": own, "thres": thres, "idx": idx}


def with_dynamic(config, ref, data, noise, low=False):
    """``ref`` completed with the dynamic layer splatting its own kept
    points, and the composite at the sampled pixels."""
    dyn_rgb, dyn_mask = render.splat_layer(data, noise, ref["points"], ref["own_keep"],
                                           config["softsplat_alpha"], low)
    idx = ref["idx"]
    m = dyn_mask.reshape(-1, 1)[idx]
    return {**ref, "combined": (1.0 - m) * ref["static_rgb"] + m * dyn_rgb.reshape(-1, 3)[idx],
            "dyn_rgb": dyn_rgb, "keep": ref["own_keep"], "means": ref["own_means"]}


def hold(config, ref_models, feats_of, data, noise, idx, prog, control):
    """(program's numbers, control's numbers or None) of one view;
    ``feats_of(low)`` gives the sources' reference (or control) features."""
    ref = with_dynamic(config, reference_view(config, ref_models, feats_of(False), data, idx),
                       data, noise)
    nums = compare(config, data, prog, ref)
    if not control:
        return nums, None
    ctl = with_dynamic(config, reference_view(config, ref_models, feats_of(True), data, idx,
                                              low=True), data, noise, low=True)
    return nums, compare(config, data, ctl, ref)
