"""Metric mono-depth preprocessing: ZoeDepth per frame, aligned to sparse
MVS depth, written in the zoe npz layout the readers take.

Counterpart of ``pgdvs_tpu.preprocess.compute_zoedepth`` (the reference's
``pgdvs/preprocess/compute_zoedepth.py``): per frame a metric depth
prediction is aligned to COLMAP sparse / MVS depth in disparity space
(median and 80 %-trimmed scale / shift, per frame and shared over the
video: ``depth_align.align_video``) and written as
``<save_dir>/zoe_depths_<type>/<i:05d>.npz`` with ``depth_pred``, the
eight ``me_{med,trim}_{scale,shift}_{indiv,share}`` values and the ``me_*``
diagnostics that the NVIDIA reader's "moe" choice sorts on
(``data/nvidia_eval.py``).

``--zoe-ckpt`` runs the port's DPT-BEiT-L ZoeDepth (``models/depth``)
from a released ``ZoeD_M12_*.pt`` on ``--device`` (default the card),
under the reference's infer protocol (``zoe_infer``); a missing file
raises FileNotFoundError. ``--pred-dir`` reads precomputed predictions
(npz / npy per frame: ``depth_pred``, ``depth``, ``pred`` or the first
array); callers of ``compute_scene_zoe`` may pass any ``depth_fn``. Frames
are read with ``data/image_io.read_rgb``.

  python -m pgdvs_tpu_torch.preprocess.compute_zoedepth --rgb-dir <dir> \\
      --mvs-depth-dir <dir> --save-dir <dir> (--zoe-ckpt <pt> | --pred-dir <dir>) \\
      [--zoe-type n] [--max-depth 10] [--device cuda]
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from pgdvs_tpu_torch.data.image_io import read_rgb
from pgdvs_tpu_torch.preprocess.depth_align import align_video

_IMG_EXTS = {".png", ".jpg", ".jpeg"}


def _load_depth_file(f: pathlib.Path) -> np.ndarray:
    z = np.load(f)
    if hasattr(z, "files"):
        for key in ("depth_pred", "depth", "pred"):
            if key in z.files:
                return np.asarray(z[key], np.float32)
        return np.asarray(z[z.files[0]], np.float32)
    return np.asarray(z, np.float32)


def _find(directory: pathlib.Path, stem: str, what: str) -> pathlib.Path:
    for ext in (".npz", ".npy"):
        p = directory / (stem + ext)
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {what} for {stem} in {directory}")


def compute_scene_zoe(rgb_dir, mvs_depth_dir, save_dir, zoe_type: str = "n", depth_fn=None,
                      pred_dir=None) -> int:
    """Align per-frame metric depth and write the zoe npz layout.

    Args:
      rgb_dir: frame images (defines the frame list / stems).
      mvs_depth_dir: per-frame sparse / MVS depth npz | npy (0 = missing).
      save_dir: files land in ``<save_dir>/zoe_depths_<zoe_type>/``.
      zoe_type: 'n' | 'k' | 'nk' (the variant subdirectory name).
      depth_fn: optional callable, [H, W, 3] float32 numpy in [0, 1] ->
        [H, W] depth (numpy or a tensor on any device).
      pred_dir: precomputed predictions (used when depth_fn is None; files
        matched by frame stem).

    Returns the number of frames written.
    """
    if depth_fn is None and pred_dir is None:
        raise ValueError("need depth_fn or pred_dir")
    rgb_dir, mvs_dir = pathlib.Path(rgb_dir), pathlib.Path(mvs_depth_dir)
    out_dir = pathlib.Path(save_dir) / f"zoe_depths_{zoe_type}"
    out_dir.mkdir(parents=True, exist_ok=True)

    files = sorted(f for f in rgb_dir.iterdir() if f.suffix.lower() in _IMG_EXTS)
    preds, mvs = [], []
    for f in files:
        if depth_fn is not None:
            img = read_rgb(f).astype(np.float32) / 255.0
            pred = depth_fn(img)
            if isinstance(pred, torch.Tensor):
                pred = pred.cpu().numpy()
            preds.append(np.asarray(pred, np.float32))
        else:
            preds.append(_load_depth_file(_find(pathlib.Path(pred_dir), f.stem, "prediction")))
        mvs.append(_load_depth_file(_find(mvs_dir, f.stem, "MVS depth")))

    # the alignment runs on the sparse valid pixels only (MVS depth 0 =
    # missing; compute_zoedepth.py:296-330 masks to the reconstruction)
    infos = align_video([p[m > 0] for p, m in zip(preds, mvs)], [m[m > 0] for m in mvs])
    for i, (pred, info) in enumerate(zip(preds, infos)):
        np.savez(out_dir / f"{i:05d}.npz", depth_pred=pred, **info)
    return len(files)


def make_dpt_depth_fn(zoe_ckpt: str, max_depth: float = 10.0, net_hw=(384, 512),
                      with_flip_aug: bool = True, device="cuda"):
    """depth_fn running the port's DPT-BEiT ZoeDepth from a released
    ``ZoeD_M12_*.pt`` (backbone and metric head from the checkpoint, the
    variant from its keys; ``zoe_port.load_zoe_model``) on ``device``
    (default the card) under the reference's ``model.infer`` protocol
    (``zoe_infer``). Returns depth [H, W] as a float32 tensor there."""
    from pgdvs_tpu_torch.models.depth.zoe_infer import zoe_infer
    from pgdvs_tpu_torch.models.depth.zoe_port import load_zoe_model

    model = load_zoe_model(zoe_ckpt, max_depth=max_depth, device=device)

    def depth_fn(img):
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(img, np.float32), device=device)
            return zoe_infer(model, x, net_hw=net_hw, with_flip_aug=with_flip_aug)

    return depth_fn


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rgb-dir", required=True)
    p.add_argument("--mvs-depth-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--pred-dir", default=None,
                   help="precomputed depth predictions (npz/npy per frame)")
    p.add_argument("--zoe-ckpt", default=None,
                   help="ZoeD_M12_*.pt checkpoint: run the port's DPT-BEiT ZoeDepth instead "
                        "of reading --pred-dir")
    p.add_argument("--max-depth", type=float, default=10.0)
    p.add_argument("--zoe-type", default="n", choices=["n", "k", "nk"])
    p.add_argument("--device", default="cuda", help="torch device (default the card)")
    args = p.parse_args(argv)
    if not (args.pred_dir or args.zoe_ckpt):
        p.error("need --pred-dir or --zoe-ckpt")
    depth_fn = (make_dpt_depth_fn(args.zoe_ckpt, max_depth=args.max_depth, device=args.device)
                if args.zoe_ckpt else None)
    n = compute_scene_zoe(args.rgb_dir, args.mvs_depth_dir, args.save_dir,
                          zoe_type=args.zoe_type, pred_dir=args.pred_dir, depth_fn=depth_fn)
    print(f"wrote {n} aligned depth npz -> {args.save_dir}")


if __name__ == "__main__":
    main()
