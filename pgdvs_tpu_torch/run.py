"""pgdvs_tpu_torch CLI: evaluate, visualize and fine-tune novel-view
synthesis with the PyTorch port.

The port's counterpart of the repository's ``run.py`` (the JAX CLI), with
its ``eval``, ``vis``, ``benchmark`` and ``train`` subcommands and the same
flags, plus ``--device {cuda,cpu}`` (default cuda; without a card, cuda
raises) and ``--dist-backend``. ``--distributed`` joins the process group
that ``torchrun`` (``python -m torch.distributed.run``) describes, one rank
per GPU (``parallel.mesh.init_distributed``: nccl on the card, gloo on the
CPU; ``--dist-backend gloo`` lets ranks share one card, which NCCL
refuses), and defaults ``--process-index`` / ``--process-count`` to the
rank and the world size. ``--devices N`` (0: every rank, 1: none) lays the
evaluator's mesh over N ranks, which render one view each; the items are
then strided over the meshes. Under a process group every rank returns the
dataset's summary and only rank 0 writes ``summary.json``. ``train``
fine-tunes the GNT and its ResUNet (``engines.trainer.Trainer``) over a
``(dp, rp)`` mesh of every rank, with checkpoints in ``--out-dir``; its
``--gnt-dtype bfloat16`` (the default, as in JAX) runs the GNT under
``torch.autocast``, ``float32`` keeps TF32 off. The
readers are the JAX package's five: ``nvidia_eval``,
``nvidia_eval_pure_geo``, ``nvidia_vis``, ``mono_vis`` and
``dycheck_iphone_eval`` (``benchmark --dataset-family dycheck_iphone``).
``vis`` and the ``visualize_nvidia_*`` bundles render a trajectory through
``engines.visualizer.Visualizer`` into ``--out-dir``. The geo static mode
(``--static-mode geo`` on ``nvidia_eval_pure_geo``, the ``st_cvd_*``
bundles) renders no network, so it loads no GNT. A bundle's tracker
(Lucas-Kanade, TAPIR for the ``_track_tapir`` bundles, CoTracker for
``_track_cotracker`` from ``$PGDVS_CKPT_DIR``) is built by
``configs.benchmarks.make_tracker`` on ``--device``. ``eval`` and
``benchmark`` take ``--trace-dir DIR``: the program's spans and counters
(``utils.tracing``) are on for the run and their summary is written to
``DIR/spans.json`` at its end (``DIR/spans_<rank>.json`` per rank under
``--distributed``). The bench subcommand,
which runs the JAX package's benchmark, is not there.

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
  python -m pgdvs_tpu_torch.run train --data-root /data --scene-ids Balloon1 \
      --out-dir experiments/ft_balloon1 --epochs 4 [--resume]
  python -m torch.distributed.run --nproc-per-node 8 -m pgdvs_tpu_torch.run train \
      --distributed --data-root /data --scene-ids Balloon1 --out-dir experiments/ft
  python -m torch.distributed.run --nproc-per-node 8 -m pgdvs_tpu_torch.run eval \
      --distributed --data-root /data --out-dir experiments/eval8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import pathlib

import torch

from pgdvs_tpu_torch.utils import tracing

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


def _device(args) -> torch.device:
    """This rank's device for ``--device``: the current card (the rank's
    own under ``--distributed``) or the CPU."""
    if args.device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _summary_name(args) -> str:
    """``summary.json``, or ``summary_<index>.json`` for a process that
    evaluates one of ``--process-count`` shards with no process group to
    sum them: its count, sums and means are its shard's (the dataset's
    mean is the shards' summed sums over their summed counts)."""
    from pgdvs_tpu_torch.parallel.mesh import world

    if args.process_count > 1 and world()[1] == 1:
        return f"summary_{args.process_index}.json"
    return "summary.json"


def build_eval_mesh(args):
    """The evaluator's mesh over ``--devices`` ranks (0: every rank of the
    world), or None for one. Where ``--distributed`` set the process grid,
    the items are strided over the meshes instead of the ranks."""
    from pgdvs_tpu_torch.parallel.mesh import make_mesh, world

    n = args.devices if args.devices > 0 else world()[1]
    if n <= 1:
        return None
    mesh = make_mesh(n_devices=n, device=_device(args))
    if mesh.size > 1 and getattr(args, "grid_from_world", False):
        args.process_index, args.process_count = mesh.index, mesh.count
    return mesh


def _evaluate(args, models, cfg, dataset, static_mode, save_vis, tracker=None):
    from pgdvs_tpu_torch.engines.evaluator import Evaluator
    from pgdvs_tpu_torch.parallel.mesh import world

    ev = Evaluator(models, cfg, static_mode=static_mode, out_dir=args.out_dir,
                   lpips_net=_lpips(args.device), save_vis=save_vis, device=args.device,
                   tracker=tracker, mesh=build_eval_mesh(args))
    result = ev.run(dataset, process_index=args.process_index,
                    process_count=args.process_count, max_items=args.max_items)
    if world()[0] == 0:
        print(json.dumps(result, indent=2))
        if args.out_dir:
            name = _summary_name(args)
            if name != "summary.json":
                LOGGER.warning("process %d of %d without a process group: %s holds this "
                               "shard's sums only", args.process_index, args.process_count,
                               name)
            with open(pathlib.Path(args.out_dir) / name, "w") as f:
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


class _FirstItems:
    """The first ``n`` items of an indexable dataset, read anew on each
    pass (``train --max-items``)."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, min(n, len(dataset))

    def __iter__(self):
        return (self.dataset[i] for i in range(self.n))


def cmd_train(args):
    """Per-scene GNT fine-tuning (the capability the reference scaffolds but
    leaves unimplemented, ``trainer_pgdvs.py:246-247``) over a (dp, rp)
    mesh of every rank, on the dataset's first ``--max-items`` items where
    given (all by default); returns {epochs, steps, final_epoch_loss}."""
    from pgdvs_tpu_torch.engines.checkpoint import load_run_config, save_run_config
    from pgdvs_tpu_torch.engines.trainer import Trainer
    from pgdvs_tpu_torch.parallel.mesh import make_mesh, world
    from pgdvs_tpu_torch.renderers.config import check_slice

    if args.resume and not args.out_dir:
        raise SystemExit("--resume needs --out-dir (the checkpoint directory)")
    saved = load_run_config(args.out_dir) if args.resume else None
    # resume recompose: the restored config is the base, new CLI overrides win
    cfg = build_render_config(args, base=(saved or {}).get("render_cfg"))
    check_slice(cfg)
    rank = world()[0]
    if args.out_dir and rank == 0:
        save_run_config(args.out_dir, {"render_cfg": dataclasses.asdict(cfg)})
    dataset = build_dataset(args)
    if args.max_items >= 0:
        dataset = _FirstItems(dataset, args.max_items)
    models = build_models_and_params(args)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.gnt_dtype]
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(rp=args.rp, device=next(models[0].parameters()).device)
    trainer = Trainer(models, cfg, lr=args.lr, n_rays_per_view=args.n_rays,
                      mesh=mesh, ckpt_dir=args.out_dir,
                      n_ckpts_keep=args.n_ckpts_keep, train_on=args.train_on, dtype=dtype)
    if args.resume:
        trainer.resume()
    loss = float("nan")
    for _ in range(args.epochs):
        loss = trainer.train_epoch(dataset, seed=args.seed)
        LOGGER.info("epoch %d mean loss %.5f", trainer.epoch, loss)
    result = {"epochs": trainer.epoch, "steps": trainer.step, "final_epoch_loss": loss}
    if rank == 0:
        print(json.dumps(result))
    return result


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

    def distributed(p, evaluates=True):
        p.add_argument("--distributed", action="store_true",
                       help="join the torchrun process group, one rank per GPU, and default "
                       "--process-index/count to this rank and the world size")
        p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                       help="the process group's backend (default: nccl on the card, gloo "
                       "on the CPU); gloo lets ranks share one card")
        if evaluates:
            p.add_argument("--devices", type=int, default=0,
                           help="ranks of the evaluator's mesh, one view each (0 = every "
                           "rank, 1 = none)")

    def traced(p):
        p.add_argument("--trace-dir", default=None, metavar="DIR",
                       help="turn the program's spans and counters on and write their "
                       "summary to DIR/spans.json at the end (DIR/spans_<rank>.json per "
                       "rank under --distributed)")

    pe = sub.add_parser("eval", help="evaluate on a dataset")
    common(pe)
    distributed(pe)
    pe.add_argument("--save-vis", action="store_true")
    traced(pe)
    pe.set_defaults(fn=cmd_eval)

    pv = sub.add_parser("vis", help="render a visualization trajectory")
    common(pv)
    pv.set_defaults(fn=cmd_vis)

    pt = sub.add_parser("train", help="per-scene GNT fine-tuning")
    common(pt)
    distributed(pt, evaluates=False)
    pt.add_argument("--epochs", type=int, default=1)
    pt.add_argument("--lr", type=float, default=5e-4)
    pt.add_argument("--n-rays", type=int, default=512)
    pt.add_argument("--rp", type=int, default=1,
                    help="ray-parallel mesh axis size (dp = ranks // rp)")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--train-on", default="src", choices=["src", "tgt"],
                    help="src: hold one source view out as the photometric target (honest). "
                    "tgt: supervise on the item's target view; on eval datasets that is the "
                    "held-out ground truth (test leakage); debugging only")
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--n-ckpts-keep", type=int, default=3)
    pt.add_argument("--gnt-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="bfloat16: the GNT under torch.autocast (parameters and Adam state "
                    "float32); float32: TF32 off")
    # training differentiates the plain network on the exact sampler, so the
    # render-speed preset would only put inert knobs into the saved config
    pt.set_defaults(fn=cmd_train, perf_preset="exact")

    pbm = sub.add_parser("benchmark", help="run a named benchmark_type bundle")
    common(pbm)
    distributed(pbm)
    pbm.add_argument("--benchmark-type", default="default")
    pbm.add_argument("--dataset-family", default="nvidia")
    traced(pbm)
    pbm.set_defaults(fn=cmd_benchmark)

    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    dist_run = getattr(args, "distributed", False)
    trace_dir = getattr(args, "trace_dir", None)
    if trace_dir:
        tracing.enable()
    if dist_run:
        from pgdvs_tpu_torch.parallel.mesh import init_distributed, world

        init_distributed(args.dist_backend, args.device)
        # DistributedSampler-style item striding follows the process grid
        # unless the user pinned it
        if args.process_count == 1:
            args.process_index, args.process_count = world()
            args.grid_from_world = True
    try:
        result = args.fn(args)
        if trace_dir:
            from pgdvs_tpu_torch.parallel.mesh import world

            name = f"spans_{world()[0]}.json" if dist_run else tracing.SUMMARY_FILE
            tracing.write_summary(pathlib.Path(trace_dir) / name)
        return result
    finally:
        if trace_dir:
            tracing.disable()
        if dist_run:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
