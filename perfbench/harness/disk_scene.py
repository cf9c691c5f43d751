"""The seeded scene written in the NVIDIA Dynamic Scenes layout.

The layout the program's ``NvidiaEvalDataset`` reads (the reference's
released data): per frame the monocular camera's image (camera f % 12 of a
12-camera arc, time f / (n - 1)) as baseline JPEG at the raw size, its
8-bit evaluation mask, its dynamic mask and disparity; flows at the
evaluation size between the frames each target's temporal pair reads
(interval 2), with a seeded ``coord_diff`` that marks ~6 % of the pixels
occluded; the LLFF ``poses_bounds_cvd.npy``; the ``images_<w>x<h>`` marker
of the evaluation size. After ``chip_smoke.write_reader_scene``, with the
benchmark's own PNG and JPEG writers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from perfbench.harness.jpeg import encode_jpeg
from perfbench.harness.scene import SceneParams, flow_between, intrinsics, render_frame, rng_for

SCENE = "Balloon1"
N_CAMS = 12


def write_png_gray(path, img):
    """An 8-bit greyscale PNG (filter 0 on every row) of uint8 [H, W]."""
    h, w = img.shape

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.asarray(img, np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


class DiskScene:
    """Cameras, times and sizes of the written scene, for the reference."""

    def __init__(self, seed, n_frames, raw_hw, eval_hw, dyn_size=(1.2, 1.2)):
        self.params = SceneParams(seed, n_frames, raw_hw, dyn_size)
        self.n_frames, self.raw_hw, self.eval_hw = n_frames, tuple(raw_hw), tuple(eval_hw)
        self.times = np.linspace(0.0, 1.0, n_frames)
        self.cams = [self.params.camera_pose(c / N_CAMS) for c in range(N_CAMS)]

    def c2w(self, f):
        return self.cams[f % N_CAMS]

    def frame(self, f, hw):
        return render_frame(self.params, hw[0], hw[1], self.c2w(f), self.times[f])

    def write(self, root, jpeg_quality, coord_diff_max, seed):
        """Write the scene under ``root``; returns, per frame at the raw
        size, what the reference reads: the uint8 rgb, the depth and the
        dynamic mask."""
        (rh, rw), (eh, ew) = self.raw_hw, self.eval_hw
        dense = root / "nvidia_long" / SCENE / "dense"
        disp_dir = root / "nvidia_long_depths" / SCENE / "disp"
        flow_root = root / "nvidia_long_flow_mask" / SCENE / "dense"
        for d in (dense / "mv_images", dense / "mv_masks", disp_dir, flow_root / "masks/final",
                  dense / f"images_{ew}x{eh}", flow_root / "flows/interval_2"):
            d.mkdir(parents=True, exist_ok=True)
        focal = intrinsics(rh, rw)[0, 0]
        rows = []
        for f in range(self.n_frames):
            c2w = self.c2w(f).copy()
            c2w[..., 1:3] *= -1  # OpenCV -> [right, up, back]
            m = c2w[:3, :4]
            llff = np.concatenate([-m[:, 1:2], m[:, 0:1], m[:, 2:4]], axis=1)  # [down, right, back]
            hwf = np.array([[rh], [rw], [focal]])
            rows.append(np.concatenate([llff, hwf], axis=1).ravel().tolist() + [0.1, 10.0])
        np.save(dense / "poses_bounds_cvd.npy", np.asarray(rows))
        sources = []
        for f in range(self.n_frames):
            fr = self.frame(f, self.raw_hw)
            rgb = (fr["rgb"] * 255).astype(np.uint8)
            sources.append({"rgb": rgb, "depth": fr["depth"][..., 0],
                            "dyn_mask": fr["dyn_mask"][..., 0]})
            cam = f % N_CAMS
            (dense / f"mv_images/{f:05d}").mkdir()
            (dense / f"mv_masks/{f:05d}").mkdir()
            (dense / f"mv_images/{f:05d}/cam{cam + 1:02d}.jpg").write_bytes(
                encode_jpeg(rgb, jpeg_quality))
            mask = (fr["dyn_mask"][..., 0] * 255).astype(np.uint8)
            write_png_gray(dense / f"mv_masks/{f:05d}/cam{cam + 1:02d}.png", mask)
            write_png_gray(flow_root / f"masks/final/{f:05d}_final.png", mask)
            np.save(disp_dir / f"{f:05d}.npy", (1.0 / fr["depth"][..., 0]).astype(np.float32))
        rng = rng_for(seed, 4)
        frames = {f: self.frame(f, self.eval_hw) for f in range(self.n_frames)}
        for f in range(1, self.n_frames - 1):
            for i, j in ((f - 1, f + 1), (f + 1, f - 1)):
                flow = flow_between(self.params, eh, ew, frames[i], self.times[i], self.c2w(j),
                                    self.times[j])
                cd = rng.uniform(0, coord_diff_max, (eh, ew, 2)).astype(np.float32)
                np.savez(flow_root / f"flows/interval_2/{i:05d}_{j:05d}.npz", flow=flow,
                         coord_diff=cd)
        return sources
