"""NVIDIA evaluation reader, pure-geometry variant: + the aggregated static
point cloud.

Counterpart of ``pgdvs_tpu.data.nvidia_pure_geo`` (the reference's
``nvidia_eval_pure_geo.py``): the static pixels of the whole monocular
video are unprojected into one cloud, each new frame adding only the pixels
that projecting the cloud so far does not cover (coverage = the integer-pixel
hit mask). The cloud is emitted as ``st_pcl_rgb [N, 6]`` padded to a fixed
capacity with a ``st_pcl_valid`` mask; above the capacity every
ceil(n / capacity)-th point is kept. It is built once per scene, on the
host, in numpy and the port's ``unproject_depth`` (float32).

The frames are those of the ``images_<w>x<h>`` directory at the eval height
(PNG, LANCZOS-resized if their size differs), else the mono frames of
``mv_images`` (JPEG or PNG) through ``_read_rgb``, at the first frame's
aspect ratio.
"""

from __future__ import annotations

import numpy as np

from pgdvs_tpu_torch.core.geometry import unproject_depth
from pgdvs_tpu_torch.data.image_io import read_image, resize_lanczos_pil
from pgdvs_tpu_torch.data.llff import hwf_to_intrinsics4
from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset


class NvidiaPureGeoEvalDataset(NvidiaEvalDataset):
    def __init__(self, *args, st_pcl_capacity: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.st_pcl_capacity = st_pcl_capacity
        self._pcl_cache = {}

    def _aggregate_static_pcl(self, scene):
        """[N, 6] float32 (xyz, rgb) of the scene's static cloud."""
        all_hwf, all_c2w, _ = self._cams(scene)
        n_frames = all_hwf.shape[0]
        mono_dirs = list((self.raw_dir / scene / "dense").glob(f"images_*x{self.tgt_height}"))
        if mono_dirs:
            w, h = map(int, mono_dirs[0].name.split("images_")[1].split("x"))
            mono_dir = mono_dirs[0]
        else:
            mono_dir = None
            first = read_image(self._mono_img_path(scene, 0))
            h = self.tgt_height
            w = int(round(first.shape[1] * h / first.shape[0]))

        st_pcl = np.zeros((0, 3), np.float32)
        st_rgb = np.zeros((0, 3), np.float32)
        for i in range(n_frames):
            if mono_dir is not None and (mono_dir / f"{i:05d}.png").exists():
                img = read_image(mono_dir / f"{i:05d}.png")
                if img.shape[:2] != (h, w):
                    img = resize_lanczos_pil(img, h, w)
                img = img.astype(np.float32) / 255.0
            else:
                img = self._read_rgb(self._mono_img_path(scene, i), h, w)
            k4 = hwf_to_intrinsics4(all_hwf[i], tgt_shape=(h, w))
            c2w = all_c2w[i]
            depth = self._read_depth(scene, i, h, w)
            pcl = unproject_depth(depth, k4, c2w).numpy().reshape(-1, 3)
            static = ~(self._read_mask(scene, i, h, w).astype(bool)).reshape(-1)
            if i > 0 and st_pcl.shape[0] > 0:
                covered = self._proj_mask(h, w, st_pcl, k4, np.linalg.inv(c2w))
                static = static & ~covered
            st_pcl = np.concatenate([st_pcl, pcl[static]])
            st_rgb = np.concatenate([st_rgb, img.reshape(-1, 3)[static]])
        return np.concatenate([st_pcl, st_rgb], axis=1).astype(np.float32)

    @staticmethod
    def _proj_mask(h, w, pcl, k4, w2c):
        """[H*W] bool: the integer pixels (coordinates truncated) that the
        points of ``pcl`` project onto, in front of the camera and inside
        [0, w-1] x [0, h-1]."""
        homo = np.concatenate([pcl, np.ones_like(pcl[:, :1])], axis=1)
        cam = (w2c @ homo.T).T[:, :3]
        pix = (k4[:3, :3] @ cam.T).T
        uv = pix[:, :2] / np.maximum(pix[:, 2:], 1e-8)
        ok = ((pix[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] <= w - 1)
              & (uv[:, 1] >= 0) & (uv[:, 1] <= h - 1))
        uv = uv[ok].astype(int)
        mask = np.zeros((h, w), bool)
        mask[uv[:, 1], uv[:, 0]] = True
        return mask.reshape(-1)

    def _scene_pcl(self, scene):
        if scene not in self._pcl_cache:
            self._pcl_cache[scene] = self._aggregate_static_pcl(scene)
        return self._pcl_cache[scene]

    def __getitem__(self, index):
        data = super().__getitem__(index)
        pcl = self._scene_pcl(data["misc"]["scene_id"])
        n = pcl.shape[0]
        cap = self.st_pcl_capacity or n
        if n > cap:
            pcl = pcl[::int(np.ceil(n / cap))][:cap]
            n = pcl.shape[0]
        out = np.zeros((cap, 6), np.float32)
        out[:n] = pcl
        valid = np.zeros((cap,), bool)
        valid[:n] = True
        data["st_pcl_rgb"] = out
        data["st_pcl_valid"] = valid
        return data
