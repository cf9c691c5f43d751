"""pgdvs_tpu_torch CLI: evaluate and visualize novel-view synthesis with the
PyTorch port.

The port's counterpart of the repository's ``run.py`` (the JAX CLI), with
its ``eval``, ``vis`` and ``benchmark`` subcommands and the same flags, less
the JAX-only ones (``--distributed``, ``--devices``, ``--gnt-dtype``), plus
``--device {cuda,cpu}`` (default cuda; without a card, cuda raises). The
readers are the JAX package's five: ``nvidia_eval``,
``nvidia_eval_pure_geo``, ``nvidia_vis``, ``mono_vis`` and
``dycheck_iphone_eval`` (``benchmark --dataset-family dycheck_iphone``).
``vis`` and the ``visualize_nvidia_*`` bundles render a trajectory through
``engines.visualizer.Visualizer`` into ``--out-dir``. The geo static mode
(``--static-mode geo`` on ``nvidia_eval_pure_geo``, the ``st_cvd_*``
bundles) renders no network, so it loads no GNT. A bundle's tracker
(Lucas-Kanade, TAPIR for the ``_track_tapir`` bundles, CoTracker for
``_track_cotracker`` from ``$PGDVS_CKPT_DIR``) is built by
``configs.benchmarks.make_tracker`` on ``--device``. The train and bench
subcommands are not there.

Examples:
  python -m pgdvs_tpu_torch.run eval --data-root /data --scene-ids Balloon1 \
      --out-dir experiments/balloon1 --save-vis
  python -m pgdvs_tpu_torch.run vis --dataset nvidia_vis --data-root /data \
      --scene-ids Balloon1 --out-dir experiments/balloon1_vis
  python -m pgdvs_tpu_torch.run vis --dataset mono_vis --data-root /davis \
      --scene-ids lady-running --out-dir experiments/lady_running_vis
  python -m pgdvs_tpu_torch.run benchmark --benchmark-type default \
      --data-root /data --out-dir experiments/default [--perf-preset exact]
  python -m pgdvs_tpu_torch.run benchmark --benchmark-type visualize_nvidia_max_disp_32 \
      --data-root /data --scene-ids Balloon1 --out-dir experiments/bt32
  python -m pgdvs_tpu_torch.run benchmark --dataset-family dycheck_iphone \
      --data-root /iphone --scene-ids paper-windmill --out-dir experiments/iphone
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import pathlib

import torch

LOGGER = logging.getLogger("pgdvs_tpu_torch")


def _overrides(kvs, fields: set, defaults) -> dict:
    """``--render-cfg K=V`` pairs, each cast to the type of its default;
    SystemExit for a field the port's RenderConfig does not have."""
    out = {}
    for kv in kvs or []:
        k, _, v = kv.partition("=")
        if k not in fields:
            raise SystemExit(f"unknown render_cfg field {k!r}; known: {sorted(fields)}")
        cur = getattr(defaults, k)
        if isinstance(cur, bool):
            out[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            out[k] = int(v)
        elif isinstance(cur, float):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def build_render_config(args, base: dict = None):
    """``--render-cfg`` overrides composed onto ``base`` (a restored run's
    saved config) or the defaults: base -> perf preset (``--perf-preset
    fast``, the default) -> explicit overrides, which always win."""
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset

    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    base_cfg = RenderConfig(**{k: v for k, v in (base or {}).items() if k in fields})
    if getattr(args, "perf_preset", "exact") == "fast":
        base_cfg = apply_perf_preset(base_cfg)
    return base_cfg.replace(**_overrides(args.render_cfg, fields, RenderConfig()))


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _dataset_kwargs(args, spec_args=None) -> dict:
    kwargs = {"data_root": args.data_root, **(spec_args or {})}
    if args.scene_ids:
        kwargs["scene_ids"] = args.scene_ids
    for kv in args.dataset_arg or []:
        k, _, v = kv.partition("=")
        kwargs[k] = _coerce(v)
    return kwargs


PORTED_DATASETS = ("nvidia_eval", "nvidia_eval_pure_geo", "nvidia_vis", "mono_vis",
                   "dycheck_iphone_eval")


def _check_dataset(name: str) -> None:
    if name not in PORTED_DATASETS:
        raise ValueError(f"unknown dataset {name!r}; the readers are {PORTED_DATASETS}")


def build_dataset(args, name=None, spec_args=None):
    from pgdvs_tpu_torch.data.combined import CombinedDataset

    name = name or args.dataset
    _check_dataset(name)
    return CombinedDataset([(name, _dataset_kwargs(args, spec_args))])


def build_models_and_params(args, static_mode="gnt"):
    """(feature_net, gnt) on ``args.device``: the reference checkpoint
    (``--gnt-ckpt`` or ``$PGDVS_CKPT_DIR``), else random weights from seed
    0 with a warning; None for static_mode "geo", which renders no
    network."""
    from pgdvs_tpu_torch.models.gnt.weight_port import load_gnt_checkpoint
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    if static_mode == "geo":
        return None
    models = load_gnt_checkpoint(args.gnt_ckpt, device=args.device)
    if models is None:
        LOGGER.warning(
            "no GNT checkpoint found (set --gnt-ckpt or PGDVS_CKPT_DIR); using random "
            "weights - renders will be structurally valid but not photometric")
        models = init_gnt_models(seed=0, device=args.device)
    return models


def _lpips(device):
    from pgdvs_tpu_torch.metrics.lpips import load_lpips_weights

    net = load_lpips_weights(device=device)
    if net is None:
        LOGGER.warning("LPIPS weights unavailable; reporting PSNR/SSIM only")
    return net


def _evaluate(args, models, cfg, dataset, static_mode, save_vis, tracker=None):
    from pgdvs_tpu_torch.engines.evaluator import Evaluator

    ev = Evaluator(models, cfg, static_mode=static_mode, out_dir=args.out_dir,
                   lpips_net=_lpips(args.device), save_vis=save_vis, device=args.device,
                   tracker=tracker)
    result = ev.run(dataset, process_index=args.process_index,
                    process_count=args.process_count, max_items=args.max_items)
    print(json.dumps(result, indent=2))
    if args.out_dir:
        with open(pathlib.Path(args.out_dir) / "summary.json", "w") as f:
            json.dump(result, f, indent=2)
    return result


def cmd_eval(args):
    from pgdvs_tpu_torch.renderers.config import check_slice

    cfg = build_render_config(args)
    check_slice(cfg, args.static_mode)
    if args.static_mode == "geo" and args.dataset != "nvidia_eval_pure_geo":
        raise ValueError("--static-mode geo renders the aggregated static cloud, which only "
                         f"--dataset nvidia_eval_pure_geo provides, not {args.dataset!r}")
    dataset = build_dataset(args)
    models = build_models_and_params(args, args.static_mode)
    return _evaluate(args, models, cfg, dataset, args.static_mode, args.save_vis)


def _visualize(args, models, cfg, dataset, static_mode):
    from pgdvs_tpu_torch.engines.visualizer import Visualizer

    if not args.out_dir:
        raise SystemExit("a visualization needs --out-dir")
    vis = Visualizer(models, cfg, args.out_dir, static_mode=static_mode, device=args.device)
    print(f"wrote {vis.run(dataset)}")
    return vis


def cmd_vis(args):
    """Render a trajectory reader's frames (``--dataset nvidia_vis`` or
    ``mono_vis``) into ``--out-dir``; returns the Visualizer."""
    from pgdvs_tpu_torch.renderers.config import check_slice

    cfg = build_render_config(args)
    check_slice(cfg, args.static_mode)
    dataset = build_dataset(args)
    models = build_models_and_params(args, args.static_mode)
    return _visualize(args, models, cfg, dataset, args.static_mode)


def cmd_benchmark(args):
    """Run a named benchmark_type bundle (the reference's ablation matrix):
    the evaluator, or the Visualizer for the ``engine: "vis"`` bundles.
    Unlike the JAX CLI's, it also applies ``--dataset-arg`` (after the
    bundle's own dataset arguments)."""
    from pgdvs_tpu_torch.configs.benchmarks import make_tracker, resolve_benchmark
    from pgdvs_tpu_torch.renderers.config import RenderConfig, check_slice

    cfg, spec = resolve_benchmark(args.benchmark_type, preset=args.perf_preset)
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    cfg = cfg.replace(**_overrides(args.render_cfg, fields, cfg))
    check_slice(cfg, spec["static_mode"])
    tracker = make_tracker(spec.get("tracker"), device=args.device)
    name = spec.get("dataset", "nvidia_eval")
    if args.dataset_family == "dycheck_iphone":
        name = "dycheck_iphone_eval"
    dataset = build_dataset(args, name, spec.get("dataset_args"))
    models = build_models_and_params(args, spec["static_mode"])
    if spec.get("engine") == "vis":
        return _visualize(args, models, cfg, dataset, spec["static_mode"])
    return _evaluate(args, models, cfg, dataset, spec["static_mode"], save_vis=True,
                     tracker=tracker)


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns its result."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--dataset", default="nvidia_eval")
        p.add_argument("--data-root", default=".")
        p.add_argument("--scene-ids", nargs="*", default=None)
        p.add_argument("--dataset-arg", nargs="*", default=None, metavar="K=V")
        p.add_argument("--render-cfg", nargs="*", default=None, metavar="K=V")
        p.add_argument("--static-mode", default="gnt", choices=["gnt", "geo"])
        p.add_argument("--gnt-ckpt", default=None)
        p.add_argument("--out-dir", default=None)
        p.add_argument("--process-index", type=int, default=0)
        p.add_argument("--process-count", type=int, default=1)
        p.add_argument("--max-items", type=int, default=-1)
        p.add_argument("--perf-preset", default="fast", choices=["fast", "exact"],
                       help="fast (default): the JAX package's fast preset (patch "
                       "sampling into K1 patch_rows; quad into K2 with masked view "
                       "attention). exact: the reference-faithful sampler (K2 "
                       "unfolded). Explicit --render-cfg flags override it knob by knob")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the renders run (default cuda; raises without a card)")

    pe = sub.add_parser("eval", help="evaluate on a dataset")
    common(pe)
    pe.add_argument("--save-vis", action="store_true")
    pe.set_defaults(fn=cmd_eval)

    pv = sub.add_parser("vis", help="render a visualization trajectory")
    common(pv)
    pv.set_defaults(fn=cmd_vis)

    pbm = sub.add_parser("benchmark", help="run a named benchmark_type bundle")
    common(pbm)
    pbm.add_argument("--benchmark-type", default="default")
    pbm.add_argument("--dataset-family", default="nvidia")
    pbm.set_defaults(fn=cmd_benchmark)

    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    return args.fn(args)


if __name__ == "__main__":
    main()
