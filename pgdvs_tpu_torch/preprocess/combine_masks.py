"""Temporal dynamic-mask combination and propagation.

The port's copy of ``pgdvs_tpu.preprocess.combine_masks`` (numpy + scipy,
unchanged). Port of the reference's ``combine_masks`` pipeline
(``pgdvs/preprocess/compute_mask.py:184-477``): per frame,
a raw dynamic mask (semantic OneFormer union, epipolar-flow, or flow-depth —
all precomputed inputs here) is

  1. OR-ed with the previous frame's final mask warped backward by optical
     flow, gated by a *dynamic-count vote* — a pixel only stays dynamic if
     it has been marked dynamic in more than ``normalized_dyn_track_thres``
     of the frames so far (``dyn_cnt / (idx + 1)``), which kills flickering
     false positives;
  2. eroded (disk radius 2) to absorb flow inaccuracy;
  3. promoted by SAM segment overlap: any precomputed SAM segment whose
     overlap with the eroded mask exceeds ``sam_overlap_thres`` of its area
     is marked fully dynamic (segments are inputs; no SAM model runs here);
  4. dilated (disk 2) into the final mask; the updated dynamic count is
     carried to the next frame.

Third-party-free numerics: the reference's ``cv2.remap(INTER_CUBIC,
BORDER_CONSTANT)`` backward warp is reimplemented as a numpy Catmull-like
bicubic (a = -0.75, cv2's kernel) and ``skimage.morphology.binary_
erosion/dilation(disk(2))`` via ``scipy.ndimage`` with skimage's border
semantics (erosion: outside-True; dilation: outside-False).

  python -m pgdvs_tpu_torch.preprocess.combine_masks --mask_dir <dir> \\
      --flow_dir <interval_1 dir> --out_dir <dir> [--sam_dir <dir>]
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def disk_footprint(radius: int) -> np.ndarray:
    """skimage.morphology.disk: x^2 + y^2 <= r^2 on a (2r+1)^2 grid."""
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return (xx * xx + yy * yy) <= radius * radius


def binary_erosion_disk(mask: np.ndarray, radius: int = 2) -> np.ndarray:
    from scipy import ndimage as ndi

    return ndi.binary_erosion(
        mask.astype(bool), structure=disk_footprint(radius), border_value=1
    )


def binary_dilation_disk(mask: np.ndarray, radius: int = 2) -> np.ndarray:
    from scipy import ndimage as ndi

    return ndi.binary_dilation(
        mask.astype(bool), structure=disk_footprint(radius), border_value=0
    )


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """cv2 INTER_CUBIC kernel (BiCubic with a=-0.75) at offsets
    (-1, 0, 1, 2) - t. Returns [..., 4]."""
    x = np.stack([t + 1.0, t, 1.0 - t, 2.0 - t], axis=-1)
    ax = np.abs(x)
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


def warp_flow(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp ``img`` by ``flow`` — the reference's ``warp_flow``
    (compute_mask.py:184-193): sample img at (x + flow_x, y + flow_y) with
    bicubic interpolation and zero constant border."""
    h, w = flow.shape[:2]
    xs = flow[..., 0] + np.arange(w, dtype=np.float32)
    ys = flow[..., 1] + np.arange(h, dtype=np.float32)[:, None]

    x0 = np.floor(xs)
    y0 = np.floor(ys)
    tx = (xs - x0).astype(np.float32)
    ty = (ys - y0).astype(np.float32)
    wx = _cubic_weights(tx)  # [H, W, 4]
    wy = _cubic_weights(ty)

    img_f = img.astype(np.float32)
    squeeze = img_f.ndim == 2
    if squeeze:
        img_f = img_f[..., None]
    out = np.zeros((h, w, img_f.shape[-1]), np.float32)
    for j in range(4):
        yj = y0.astype(np.int64) + (j - 1)
        inside_y = (yj >= 0) & (yj < img.shape[0])
        yj_c = np.clip(yj, 0, img.shape[0] - 1)
        row_acc = np.zeros_like(out)
        for i in range(4):
            xi = x0.astype(np.int64) + (i - 1)
            inside = inside_y & (xi >= 0) & (xi < img.shape[1])
            xi_c = np.clip(xi, 0, img.shape[1] - 1)
            vals = img_f[yj_c, xi_c] * inside[..., None]
            row_acc = row_acc + wx[..., i : i + 1] * vals
        out = out + wy[..., j : j + 1] * row_acc
    return out[..., 0] if squeeze else out


@dataclasses.dataclass
class MaskState:
    """Carried between frames: previous final-raw mask + dynamic count."""

    mask_final_raw: Optional[np.ndarray] = None
    dyn_cnt: Optional[np.ndarray] = None


def combine_masks(
    raw_mask_no_warp: np.ndarray,
    img_idx: int,
    state: MaskState,
    mask_sam: Optional[np.ndarray] = None,
    bwd_flow: Optional[np.ndarray] = None,
    bwd_consist_mask: Optional[np.ndarray] = None,
    normalized_dyn_track_thres: float = 0.5,
    sam_overlap_thres: float = 0.1,
) -> dict:
    """One frame of the reference ``combine_masks`` (compute_mask.py:352-477).

    Args:
      raw_mask_no_warp: [H, W] bool — this frame's raw dynamic mask (already
        unioned over semantic classes / epipolar test upstream).
      img_idx: frame index (normalizes the dynamic-count vote).
      state: previous frame's MaskState (empty state for the first frame).
      mask_sam: optional [n_seg, H, W] bool precomputed SAM segments.
      bwd_flow: optional [H, W, 2] flow frame->frame-1 (required with a
        non-empty state); bwd_consist_mask: [H, W] bool fwd/bwd-consistency.

    Returns the reference's dict: raw/raw_eroded/final_raw/final/dyn_cnt/
    warp_prev/dyn_track (+ the updated state under "state").
    """
    raw_mask_no_warp = raw_mask_no_warp.astype(bool)
    mask_warp_prev_raw = None
    mask_dyn_track = None

    if state.mask_final_raw is not None:
        assert bwd_flow is not None, "bwd flow required to propagate masks"
        bwd_mask = (
            np.ones(raw_mask_no_warp.shape, np.float32)
            if bwd_consist_mask is None
            else bwd_consist_mask.astype(np.float32)
        )
        mask_warp_prev_raw = (
            warp_flow(state.mask_final_raw.astype(np.uint8), bwd_flow)
            * bwd_mask
        ) > 1e-3
        dyn_cnt_warp_prev = warp_flow(state.dyn_cnt, bwd_flow).astype(
            np.float32
        )
        mask_dyn_track = (
            dyn_cnt_warp_prev / (img_idx + 1) * bwd_mask
        ) > normalized_dyn_track_thres
        mask_warp_prev = binary_erosion_disk(
            mask_warp_prev_raw & mask_dyn_track, 2
        )
        raw_mask = raw_mask_no_warp | mask_warp_prev
    else:
        dyn_cnt_warp_prev = None
        raw_mask = raw_mask_no_warp

    raw_mask_eroded = binary_erosion_disk(raw_mask, 2)

    mask_final_raw = np.copy(raw_mask_eroded)
    if mask_sam is not None:
        for seg in mask_sam.astype(bool):
            n_pix = float(seg.sum())
            n_overlap = float((seg & raw_mask_eroded).sum())
            if n_overlap > 0 and n_overlap > sam_overlap_thres * n_pix:
                mask_final_raw[seg] = True

    if state.mask_final_raw is not None:
        cur_dyn_cnt = dyn_cnt_warp_prev + mask_final_raw.astype(np.float32)
    else:
        cur_dyn_cnt = raw_mask_no_warp.astype(np.float32)

    mask_final = binary_dilation_disk(mask_final_raw, 2)

    return {
        "warp_prev": mask_warp_prev_raw,
        "dyn_track": mask_dyn_track,
        "dyn_cnt": cur_dyn_cnt,
        "raw_no_warp": raw_mask_no_warp,
        "raw": raw_mask,
        "raw_eroded": raw_mask_eroded,
        "final_raw": mask_final_raw,
        "final": mask_final,
        "state": MaskState(mask_final_raw=mask_final_raw, dyn_cnt=cur_dyn_cnt),
    }


def propagate_sequence(
    raw_masks: Sequence[np.ndarray],
    bwd_flows: Sequence[Optional[np.ndarray]],
    bwd_consist: Sequence[Optional[np.ndarray]],
    sam_segments: Optional[Sequence[Optional[np.ndarray]]] = None,
    normalized_dyn_track_thres: float = 0.5,
    sam_overlap_thres: float = 0.1,
) -> list:
    """Run combine_masks over a whole sequence (frame t uses flow t->t-1)."""
    state = MaskState()
    outs = []
    for i, raw in enumerate(raw_masks):
        ret = combine_masks(
            raw,
            i,
            state,
            mask_sam=None if sam_segments is None else sam_segments[i],
            bwd_flow=None if i == 0 else bwd_flows[i],
            bwd_consist_mask=None if i == 0 else bwd_consist[i],
            normalized_dyn_track_thres=normalized_dyn_track_thres,
            sam_overlap_thres=sam_overlap_thres,
        )
        state = ret["state"]
        outs.append(ret)
    return outs


def main(argv=None):
    """CLI: combine + temporally propagate precomputed per-frame masks.

    Consumes a directory of per-frame raw masks (``<name>.npy`` bool [H,W],
    from epipolar_mask.py or a semantic-union export), the flow npz layout
    written by compute_flow.py (``<name_i>_<name_j>.npz`` with flow +
    coord_diff), and optional SAM segment stacks (``<name>_sam.npy``
    [n_seg, H, W]); writes ``<name>_final.npy`` (+ dyn_cnt) like the
    reference's mask driver (compute_mask.py:479-556).
    """
    import argparse
    import pathlib

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--mask_dir", required=True)
    p.add_argument("--flow_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--sam_dir", default=None)
    p.add_argument("--flow_interval", type=int, default=1)
    p.add_argument("--dyn_track_thres", type=float, default=0.5)
    p.add_argument("--sam_overlap_thres", type=float, default=0.1)
    p.add_argument("--consist_thres", type=float, default=1.0)
    args = p.parse_args(argv)

    mask_dir = pathlib.Path(args.mask_dir)
    flow_dir = pathlib.Path(args.flow_dir)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # the semantic_masks CLI writes auxiliary arrays next to the raw masks
    # (<stem>_sam.npy, <stem>_semseg_*.npy) and re-runs leave propagation
    # outputs (<stem>_final/_dyn_cnt.npy) — only bare frame stems are masks
    aux = ("_sam", "_semseg_ade20k", "_semseg_coco", "_final", "_dyn_cnt")
    names = sorted(
        f.stem for f in mask_dir.glob("*.npy")
        if not f.stem.endswith(aux)
    )

    state = MaskState()
    for i, name in enumerate(names):
        raw = np.load(mask_dir / f"{name}.npy").astype(bool)
        sam = None
        if args.sam_dir:
            sam_f = pathlib.Path(args.sam_dir) / f"{name}_sam.npy"
            if sam_f.is_file():
                sam = np.load(sam_f)
        bwd_flow = bwd_consist = None
        # propagation starts once a frame at -flow_interval exists (the
        # reference's read_optical_flow would wrap the index negative here
        # and load a bogus pair — compute_mask.py:204-206)
        if i >= args.flow_interval:
            prev = names[i - args.flow_interval]
            info = np.load(flow_dir / f"{name}_{prev}.npz")
            bwd_flow = info["flow"]
            bwd_consist = (
                np.sum(np.abs(info["coord_diff"]), axis=2)
                <= args.consist_thres
            )
        ret = combine_masks(
            raw,
            i,
            state,
            mask_sam=sam,
            bwd_flow=bwd_flow,
            bwd_consist_mask=bwd_consist,
            normalized_dyn_track_thres=args.dyn_track_thres,
            sam_overlap_thres=args.sam_overlap_thres,
        )
        state = ret["state"]
        np.save(out_dir / f"{name}_final.npy", ret["final"])
        np.save(out_dir / f"{name}_dyn_cnt.npy", ret["dyn_cnt"])
    print(f"wrote {len(names)} propagated masks to {out_dir}")


if __name__ == "__main__":
    main()
