"""Optical-flow preprocessing CLI: RAFT forward / backward flow and the
cycle-consistency npz files.

Counterpart of ``pgdvs_tpu.preprocess.compute_flow`` (the reference's
``pgdvs/preprocess/compute_flow.py:221-380``): for every frame pair (i, i+k)
at the given intervals, run RAFT forward and backward (32 iterations) and
write ``interval_<k>/<i:05d>_<j:05d>.npz`` and ``<j:05d>_<i:05d>.npz`` with
``flow`` [H, W, 2] and ``coord_diff`` [H, W, 2] (the round-trip error the
readers threshold into occlusion masks, ``flow_consistency``).

The port's RAFT (``models/flow/raft.py``) runs with the princeton-vl
checkpoint from ``$PGDVS_CKPT_DIR`` on ``device`` (default the card);
without the checkpoint it raises FileNotFoundError, as the JAX package
does. Frames are read with ``data/image_io.read_rgb``.

  python -m pgdvs_tpu_torch.preprocess.compute_flow --rgb-dir <dir> \\
      --save-dir <dir> [--intervals 1 2] [--iters 32] [--tiling none] \\
      [--device cuda]
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from pgdvs_tpu_torch.data.image_io import read_rgb
from pgdvs_tpu_torch.preprocess.flow_consistency import flow_roundtrip

_IMG_EXTS = {".png", ".jpg", ".jpeg"}


def _frame_files(rgb_dir: pathlib.Path):
    return sorted(f for f in rgb_dir.iterdir() if f.suffix.lower() in _IMG_EXTS)


def _flowformer_fn(base_fn):
    """The FlowFormer tiling protocol around ``base_fn``: each direction per
    patch, through ``one_way`` where the model offers it."""
    from pgdvs_tpu_torch.preprocess.flowformer_tiling import (FLOWFORMER_TRAIN_SIZE,
                                                              adaptive_flow, tiled_flow)

    if hasattr(base_fn, "one_way"):
        m = base_fn.one_way
    else:
        def m(pa, pb):
            return base_fn(pa, pb)[0]

    def flow_fn(img1, img2):
        big = (img1.shape[0] >= FLOWFORMER_TRAIN_SIZE[0]
               and img1.shape[1] >= FLOWFORMER_TRAIN_SIZE[1])
        one_way = tiled_flow if big else adaptive_flow
        return one_way(m, img1, img2), one_way(m, img2, img1)

    return flow_fn


def compute_scene_flows(
    rgb_dir,
    save_dir,
    intervals=(1,),
    flow_fn=None,
    iters: int = 32,
    tiling: str = "none",
    device="cuda",
) -> int:
    """Forward and backward flows for every frame pair at the given
    intervals; returns the number of npz files written.

    flow_fn: optional (img1, img2) -> (flow12, flow21) over [H, W, 3]
    frames in [0, 1] (numpy or tensors back); default the RAFT port with the
    released checkpoint on ``device``. tiling: "none" runs the model at the
    frame's size (RAFT's protocol); "flowformer" runs the FlowFormer patch
    protocol (``flowformer_tiling``) over whichever model flow_fn wraps.
    The cycle consistency runs on ``device``.
    """
    rgb_dir = pathlib.Path(rgb_dir)
    save_dir = pathlib.Path(save_dir)
    if flow_fn is None:
        from pgdvs_tpu_torch.models.flow.raft_port import make_raft_flow

        flow_fn = make_raft_flow(iters=iters, device=device)
    if tiling == "flowformer":
        flow_fn = _flowformer_fn(flow_fn)

    frames = [read_rgb(f).astype(np.float32) / 255.0 for f in _frame_files(rgb_dir)]

    def as_flow(f):
        return torch.as_tensor(f, dtype=torch.float32, device=device)

    n_written = 0
    for k in intervals:
        out_dir = save_dir / f"interval_{k}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for i in range(len(frames) - k):
            j = i + k
            f12, f21 = (as_flow(f) for f in flow_fn(frames[i], frames[j]))
            cd_12 = flow_roundtrip(f12, f21)[0]
            cd_21 = flow_roundtrip(f21, f12)[0]
            for (a, b), flow, cd in (((i, j), f12, cd_12), ((j, i), f21, cd_21)):
                np.savez(out_dir / f"{a:05d}_{b:05d}.npz", flow=flow.cpu().numpy(),
                         coord_diff=cd.cpu().numpy())
            n_written += 2
    return n_written


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rgb-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--intervals", type=int, nargs="*", default=[1])
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--tiling", default="none", choices=["none", "flowformer"])
    p.add_argument("--device", default="cuda", help="torch device (default the card)")
    args = p.parse_args(argv)
    n = compute_scene_flows(args.rgb_dir, args.save_dir, intervals=args.intervals,
                            iters=args.iters, tiling=args.tiling, device=args.device)
    print(f"wrote {n} flow npz files -> {args.save_dir}")


if __name__ == "__main__":
    main()
