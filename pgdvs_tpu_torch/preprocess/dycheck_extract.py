"""Extract a DyCheck iPhone capture's train split for mono preprocessing.

Counterpart of ``pgdvs_tpu.preprocess.dycheck_extract`` (the reference's
``dycheck_mono_info_extractor.py``, the step that converts a DyCheck
capture into the {rgbs/, depths/, camera.npz} layout the in-the-wild /
mono pipeline consumes): for every TRAIN frame it writes

  <save_dir>/<scene>/rgbs/<frame>.png      raw uint8 RGB (alpha stripped)
  <save_dir>/<scene>/depths/<frame>.npy    scene-scaled depth [H, W]
  <save_dir>/<scene>/camera.npz            all_K [N, 3, 3], all_w2c [N, 4, 4]

Cameras are in DyCheck's normalized world frame (recentred, rescaled),
read through the port's ``data/dycheck_iphone.IPhoneParser``; the frames
are decoded with ``data/image_io.read_image`` and written with
``write_png`` (the same pixels as the JAX package's PIL save).

  python -m pgdvs_tpu_torch.preprocess.dycheck_extract --data_dir <dir> \\
      --save_dir <dir> --scene_id apple [--factor 1]
"""

from __future__ import annotations

import pathlib

import numpy as np

from pgdvs_tpu_torch.data.dycheck_iphone import IPhoneParser
from pgdvs_tpu_torch.data.image_io import read_image, write_png


def extract_scene(data_dir, save_dir, scene_id: str, factor: int = 1):
    parser = IPhoneParser(pathlib.Path(data_dir) / scene_id, factor=factor)
    names, time_ids, cam_ids = parser.load_split("train")
    assert len(names) == len(time_ids) == len(cam_ids)

    out = pathlib.Path(save_dir) / scene_id
    rgb_dir = out / "rgbs"
    depth_dir = out / "depths"
    rgb_dir.mkdir(parents=True, exist_ok=True)
    depth_dir.mkdir(parents=True, exist_ok=True)

    all_k, all_w2c = [], []
    for name in names:
        src = parser.dir / "rgb" / f"{parser.factor}x" / f"{name}.png"
        write_png(rgb_dir / f"{name}.png", read_image(src)[..., :3])  # raw uint8, no alpha
        depth = np.asarray(parser.load_depth(name))
        np.save(depth_dir / f"{name}.npy", depth[..., 0] if depth.ndim == 3 else depth)
        cam = parser.load_camera(name)
        all_k.append(cam.intrin4[:3, :3])
        all_w2c.append(cam.w2c)

    np.savez(
        out / "camera.npz",
        all_K=np.asarray(all_k, np.float32),
        all_w2c=np.asarray(all_w2c, np.float32),
    )
    return len(names)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", default=".")
    p.add_argument("--save_dir", default=".")
    p.add_argument("--scene_id", default="apple")
    p.add_argument("--factor", type=int, default=1)
    args = p.parse_args(argv)
    n = extract_scene(args.data_dir, args.save_dir, args.scene_id, factor=args.factor)
    print(f"extracted {n} train frames -> {args.save_dir}/{args.scene_id}")


if __name__ == "__main__":
    main()
