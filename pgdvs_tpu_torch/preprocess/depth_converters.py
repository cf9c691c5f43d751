"""Consistent-depth output converters -> the {poses/, depths/} npz layout.

The port's copy of ``pgdvs_tpu.preprocess.depth_converters`` (numpy,
unchanged). Counterparts of the reference's converters that turn per-scene
consistent-depth training outputs into the directory layout the mono
(in-the-wild) datasets read:
  * CasualSAM (``convert_casual_sam_output.py:11-87``): BA_full/*.npz with
    per-frame disp/R/t/K; depth = 1 / (disp + 1e-8).
  * dynamic-video-depth (``convert_dyn_video_depth_output.py:11-91``):
    test/scene_flow_motion_field*/epoch*_test/batch*.npz with depth / c2w /
    K (stored transposed — the converter un-transposes).

Both write poses/<stem>.npz {c2w [4,4], K [4,4]} and depths/<stem>.npz
{depth [H, W]} keyed to the sorted RGB file stems, asserting a single
shared K across the sequence.

  python -m pgdvs_tpu_torch.preprocess.depth_converters casual_sam | \\
      dyn_video_depth --base-dir <dir> --rgb-dir <dir> --save-dir <dir>
"""

from __future__ import annotations

import pathlib

import numpy as np

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}


def _rgb_stems(rgb_dir: pathlib.Path):
    files = sorted(
        f for f in rgb_dir.iterdir() if f.suffix.lower() in _IMG_EXTS
    )
    return [f.stem for f in files]


def _write_frame(save_dir, stem, c2w, k, depth):
    pose_dir = save_dir / "poses"
    depth_dir = save_dir / "depths"
    pose_dir.mkdir(exist_ok=True, parents=True)
    depth_dir.mkdir(exist_ok=True, parents=True)
    np.savez(pose_dir / f"{stem}.npz", c2w=c2w, K=k)
    np.savez(depth_dir / f"{stem}.npz", depth=depth)


def convert_casual_sam(casual_sam_dir, rgb_dir, save_dir) -> int:
    """Convert CasualSAM BA_full outputs. Returns #frames written."""
    casual_sam_dir = pathlib.Path(casual_sam_dir)
    rgb_dir = pathlib.Path(rgb_dir)
    save_dir = pathlib.Path(save_dir)
    result_fs = sorted((casual_sam_dir / "BA_full").glob("*.npz"))
    stems = _rgb_stems(rgb_dir)
    assert len(stems) == len(result_fs), (len(stems), len(result_fs))

    k0 = None
    for i, rf in enumerate(result_fs):
        assert int(rf.stem) == i, (rf.stem, i)
        info = np.load(rf)
        depth = 1.0 / (info["disp"] + 1e-8)
        c2w = np.eye(4)
        c2w[:3, :3] = info["R"]
        c2w[:3, 3] = info["t"]
        k = np.eye(4)
        k[:3, :3] = info["K"]
        if k0 is None:
            k0 = k
        else:
            assert np.abs(k0 - k).sum() < 1e-5, "intrinsics drift"
        _write_frame(save_dir, stems[i], c2w, k, depth)
    return len(result_fs)


def convert_dyn_video_depth(base_dir, rgb_dir, save_dir) -> int:
    """Convert dynamic-video-depth test outputs. Returns #frames written."""
    base_dir = pathlib.Path(base_dir)
    rgb_dir = pathlib.Path(rgb_dir)
    save_dir = pathlib.Path(save_dir)
    result_dirs = list(
        (base_dir / "test").glob("scene_flow_motion_field*/epoch*_test")
    )
    assert len(result_dirs) == 1, result_dirs
    result_fs = sorted(result_dirs[0].glob("*.npz"))
    stems = _rgb_stems(rgb_dir)
    assert len(stems) == len(result_fs), (len(stems), len(result_fs))

    k0 = None
    for i, rf in enumerate(result_fs):
        assert int(rf.stem.split("batch")[1]) == i, (rf.stem, i)
        info = np.load(rf)
        depth = info["depth"][0, 0]
        c2w = info["cam_c2w"][0]
        k = np.eye(4)
        # stored transposed (convert_dyn_video_depth_output.py:59)
        k[:3, :3] = info["K"][0, 0, 0].T
        if k0 is None:
            k0 = k
        else:
            assert np.abs(k0 - k).sum() < 1e-5, "intrinsics drift"
        _write_frame(save_dir, stems[i], c2w, k, depth)
    return len(result_fs)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["casual_sam", "dyn_video_depth"])
    p.add_argument("--base-dir", required=True)
    p.add_argument("--rgb-dir", required=True)
    p.add_argument("--save-dir", required=True)
    args = p.parse_args(argv)
    fn = convert_casual_sam if args.kind == "casual_sam" else (
        convert_dyn_video_depth
    )
    n = fn(args.base_dir, args.rgb_dir, args.save_dir)
    print(f"converted {n} frames -> {args.save_dir}")


if __name__ == "__main__":
    main()
