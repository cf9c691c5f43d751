"""COLMAP pipeline driver (external C++ binary, host-side).

The port's copy of ``pgdvs_tpu.preprocess.colmap_driver``: the same
argument lists through ``_run``, and the same refusal without the binary.
Equivalent of the reference ``colmap_processor.py:21-130``: feature
extraction (masked to exclude dynamic regions) -> exhaustive matching ->
mapping -> bundle adjustment -> undistortion, driven via subprocess. Gated
on the ``colmap`` binary being installed; everything downstream can instead
consume precomputed poses (the released data path).

  python -m pgdvs_tpu_torch.preprocess.colmap_driver --rgb-dir <dir> \\
      --work-dir <dir> [--mask-dir <dir>] [--camera-model SIMPLE_RADIAL]
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path

LOGGER = logging.getLogger(__name__)


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def _run(args):
    LOGGER.info("colmap: %s", " ".join(map(str, args)))
    subprocess.run(list(map(str, args)), check=True)


def run_colmap(
    workdir,
    image_dir,
    mask_dir=None,
    camera_model: str = "SIMPLE_RADIAL",
    single_camera: bool = True,
    dense_undistort: bool = True,
):
    """Run the full SfM pipeline.

    Args:
      workdir: output directory (database + sparse/ + optional dense/).
      image_dir: input frames.
      mask_dir: optional feature-extraction masks (white = use; the
        preprocessing pipeline passes the *inverted* dynamic masks so moving
        content contributes no SfM features, compute_mask.py:872-875).
    """
    if not colmap_available():
        raise RuntimeError(
            "colmap binary not found; install COLMAP or provide precomputed "
            "poses_bounds.npy"
        )
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    db = workdir / "database.db"
    sparse = workdir / "sparse"
    sparse.mkdir(exist_ok=True)

    feat = [
        "colmap", "feature_extractor",
        "--database_path", db,
        "--image_path", image_dir,
        "--ImageReader.camera_model", camera_model,
        "--ImageReader.single_camera", int(single_camera),
    ]
    if mask_dir is not None:
        feat += ["--ImageReader.mask_path", mask_dir]
    _run(feat)
    _run(["colmap", "exhaustive_matcher", "--database_path", db])
    _run(
        [
            "colmap", "mapper",
            "--database_path", db,
            "--image_path", image_dir,
            "--output_path", sparse,
        ]
    )
    model = sparse / "0"
    _run(
        [
            "colmap", "bundle_adjuster",
            "--input_path", model,
            "--output_path", model,
            "--BundleAdjustment.refine_principal_point", 1,
        ]
    )
    if dense_undistort:
        _run(
            [
                "colmap", "image_undistorter",
                "--image_path", image_dir,
                "--input_path", model,
                "--output_path", workdir / "dense",
                "--output_type", "COLMAP",
            ]
        )
    return model


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="COLMAP SfM driver (feature -> match -> map -> BA -> "
        "undistort) + poses_bounds.npy conversion"
    )
    p.add_argument("--rgb-dir", required=True)
    p.add_argument("--work-dir", required=True)
    p.add_argument("--mask-dir", default=None)
    p.add_argument("--camera-model", default="SIMPLE_RADIAL")
    args = p.parse_args(argv)
    if not colmap_available():
        raise SystemExit("colmap binary not found on PATH")
    run_colmap(
        args.work_dir,
        args.rgb_dir,
        mask_dir=args.mask_dir,
        camera_model=args.camera_model,
    )
    print(f"COLMAP outputs under {args.work_dir}")


if __name__ == "__main__":
    main()
