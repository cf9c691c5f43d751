"""Monocular-depth scale/shift alignment against sparse MVS depth.

The port's copy of ``pgdvs_tpu.preprocess.depth_align`` (numpy,
unchanged). Equivalent of the reference ZoeDepth alignment
(``pgdvs/preprocess/compute_zoedepth.py:296-398``): scale
and shift are estimated in **disparity** space (Midas Eq. 5 reasoning) on
static pixels where MVS depth exists, via median statistics, with an
80%-quantile trimmed variant that drops the worst normalized-disparity
disagreements. Per-frame ("indiv") and video-averaged ("share") variants
are both produced — four (scale, shift) pairs per frame, matching the npz
contract the NVIDIA dataset's ``use_zoe_depth`` path consumes.

  python -m pgdvs_tpu_torch.preprocess.depth_align --zoe-dir <dir> \\
      --colmap-dir <dir> --save-dir <dir>
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

TINY = 1e-16


@dataclasses.dataclass
class DispAlignment:
    scale_med: float
    shift_med: float
    scale_trim: float
    shift_trim: float
    mae_med: float  # diagnostics: mean-abs / mean disparity error
    me_med: float
    mae_trim: float
    me_trim: float


def align_frame(pred_depth: np.ndarray, mvs_depth: np.ndarray) -> DispAlignment:
    """Estimate disparity scale/shift for one frame.

    Args:
      pred_depth: [N] monocular depth at pixels with valid MVS depth.
      mvs_depth: [N] MVS depth at the same pixels.
    """
    nn_disp = 1.0 / (pred_depth + TINY)
    mvs_disp = 1.0 / (mvs_depth + TINY)

    nn_shifted = nn_disp - np.median(nn_disp)
    mvs_shifted = mvs_disp - np.median(mvs_disp)

    scale_med = float(np.median(mvs_shifted / (nn_shifted + TINY)))
    if scale_med < 0:  # never invert the depth ordering
        scale_med = 0.0
    shift_med = float(np.median(mvs_disp - nn_disp * scale_med))

    # trimmed variant: drop the worst 20% normalized disagreements
    nn_norm = nn_shifted / (np.mean(np.abs(nn_shifted)) + TINY)
    mvs_norm = mvs_shifted / (np.mean(np.abs(mvs_shifted)) + TINY)
    diff = np.abs(nn_norm - mvs_norm)
    keep = diff <= np.quantile(diff, 0.8)

    scale_trim = float(
        np.median(mvs_shifted[keep] / (nn_shifted[keep] + TINY))
    )
    if scale_trim < 0:
        scale_trim = 0.0
    shift_trim = float(
        np.median(mvs_disp[keep] - nn_disp[keep] * scale_trim)
    )

    def errs(scale, shift):
        aligned = nn_disp * scale + shift
        return float(np.mean(np.abs(aligned - mvs_disp))), float(
            np.mean(aligned - mvs_disp)
        )

    mae_med, me_med = errs(scale_med, shift_med)
    mae_trim, me_trim = errs(scale_trim, shift_trim)
    return DispAlignment(
        scale_med, shift_med, scale_trim, shift_trim, mae_med, me_med, mae_trim, me_trim
    )


def align_video(
    pred_depths: Sequence[np.ndarray], mvs_depths: Sequence[np.ndarray]
) -> List[dict]:
    """Per-frame alignment + video-shared (mean) scale/shift.

    Returns one dict per frame in the npz key layout the dataset reads
    (me_{med,trim}_{scale,shift}_{indiv,share} + the me_* diagnostics the
    'moe' best-of selection sorts by).
    """
    per_frame = [align_frame(p, m) for p, m in zip(pred_depths, mvs_depths)]
    share_scale_med = float(np.mean([a.scale_med for a in per_frame]))
    share_shift_med = float(np.mean([a.shift_med for a in per_frame]))
    share_scale_trim = float(np.mean([a.scale_trim for a in per_frame]))
    share_shift_trim = float(np.mean([a.shift_trim for a in per_frame]))

    out = []
    for a, pred, mvs in zip(per_frame, pred_depths, mvs_depths):
        def err(scale, shift):
            aligned = (1.0 / (pred + TINY)) * scale + shift
            return float(np.mean(aligned - 1.0 / (mvs + TINY)))

        out.append(
            {
                "me_med_scale_indiv": a.scale_med,
                "me_med_shift_indiv": a.shift_med,
                "me_trim_scale_indiv": a.scale_trim,
                "me_trim_shift_indiv": a.shift_trim,
                "me_med_scale_share": share_scale_med,
                "me_med_shift_share": share_shift_med,
                "me_trim_scale_share": share_scale_trim,
                "me_trim_shift_share": share_shift_trim,
                # diagnostics ('moe' sorts on |me| per variant)
                "me_med_indiv": a.me_med,
                "me_trim_indiv": a.me_trim,
                "me_med_share": err(share_scale_med, share_shift_med),
                "me_trim_share": err(share_scale_trim, share_shift_trim),
            }
        )
    return out


def main(argv=None):
    """CLI: align monocular depth to COLMAP MVS depth in disparity space.

    --zoe-dir holds per-frame predicted depth npz ({depth} or first array);
    --colmap-dir holds matching sparse/MVS depth npz; writes per-frame npz
    with the 4 scale/shift variants (the dataset's use_zoe_depth choices).
    """
    import argparse
    import pathlib

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--zoe-dir", required=True)
    p.add_argument("--colmap-dir", required=True)
    p.add_argument("--save-dir", required=True)
    args = p.parse_args(argv)

    zoe_dir = pathlib.Path(args.zoe_dir)
    colmap_dir = pathlib.Path(args.colmap_dir)
    save_dir = pathlib.Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    def load_any(f):
        z = np.load(f)
        if hasattr(z, "files"):
            key = "depth" if "depth" in z.files else z.files[0]
            return np.asarray(z[key])
        return np.asarray(z)

    zoe_fs = sorted(zoe_dir.glob("*.npz")) + sorted(zoe_dir.glob("*.npy"))
    preds, mvs = [], []
    for f in zoe_fs:
        preds.append(load_any(f))
        mvs_f = None
        for ext in (".npz", ".npy"):
            cand = colmap_dir / (f.stem + ext)
            if cand.is_file():
                mvs_f = cand
                break
        assert mvs_f is not None, f"no MVS depth for {f.stem}"
        mvs.append(load_any(mvs_f))

    infos = align_video(preds, mvs)
    for f, pred, info in zip(zoe_fs, preds, infos):
        np.savez(save_dir / f"{f.stem}.npz", depth_pred=pred, **info)
    print(f"aligned {len(infos)} frames -> {save_dir}")


if __name__ == "__main__":
    main()
