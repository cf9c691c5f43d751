"""NVIDIA Dynamic Scenes evaluation reader.

The counterpart of ``pgdvs_tpu.data.nvidia_eval``: it reads the same
on-disk layout and assembles the same renderer-input contract per novel
view, in numpy, with the same protocol:

  <raw>/<scene>/dense/mv_images/<frame:05d>/cam<id+1:02d>.png   12-cam rig
  <raw>/<scene>/dense/mv_masks/<frame:05d>/cam<id+1:02d>.png    eval masks
  <raw>/<scene>/dense/poses_bounds_cvd.npy                      LLFF poses
  <depth>/<scene>/disp/<frame:05d>.npy                          1/disp depth
  <mask>/<scene>/dense/masks/final/<frame:05d>_final.png        dynamic masks
  <flow>/<scene>/dense/flows/interval_<k>/<i:05d>_<j:05d>.npz   {flow, coord_diff}

The monocular input video uses camera (frame % 12); eval height is 288; a
target frame in the mono video is excluded from its own sources; spatial
sources = the n nearest cameras (``sort_poses_wrt_ref``) in a ±12-frame
window; temporal sources = the two adjacent frames (or the same frame when
the target is held out, duplicated); depth range = [0.8·min, 1.2·q90] of the
spatial sources' point cloud in the target camera; flow occlusion =
|coord_diff|_1 > thres.

Images decode through ``image_io.read_image`` (PNG, or JPEG as the real
DynIBaR frames are, bit for bit what PIL gives) and resize as the JAX reader's libraries do: rgb with
``resize_area`` (OpenCV INTER_AREA), depth and eval masks with
``resize_nearest_cv``, dynamic masks with ``resize_nearest_pil``, a target
off the eval height with ``resize_lanczos_pil``.
"""

from __future__ import annotations

import pathlib
from typing import List, Optional, Sequence

import numpy as np

from pgdvs_tpu_torch.core.geometry import sort_poses_wrt_ref, unproject_depth
from pgdvs_tpu_torch.data.image_io import (
    read_image,
    resize_area,
    resize_lanczos_pil,
    resize_nearest_cv,
    resize_nearest_pil,
)
from pgdvs_tpu_torch.data.llff import hwf_to_intrinsics4, load_poses_bounds
from pgdvs_tpu_torch.utils import tracing

N_CAMS = 12
TGT_HEIGHT = 288

ALL_SCENE_IDS = [
    "Balloon1",
    "Balloon2",
    "Jumping",
    "Playground",
    "Skating",
    "Truck",
    "Umbrella",
    "dynamicFace",
]

ZOE_PRINCIPLES = {
    "me_med_share": ("me_med_scale_share", "me_med_shift_share"),
    "me_med_indiv": ("me_med_scale_indiv", "me_med_shift_indiv"),
    "me_trim_share": ("me_trim_scale_share", "me_trim_shift_share"),
    "me_trim_indiv": ("me_trim_scale_indiv", "me_trim_shift_indiv"),
}


def load_arrays(path):
    """The array of a ``.npy`` file, or a dict of every array of a ``.npz``
    file, read at once and the file closed."""
    data = np.load(path, allow_pickle=False)
    if isinstance(data, np.lib.npyio.NpzFile):
        with data:
            return {k: data[k] for k in data.files}
    return data


class NvidiaEvalDataset:
    """Indexable renderer-contract dicts, one per (frame, camera) image."""

    def __init__(
        self,
        data_root,
        raw_data_dir="nvidia_long",
        depth_data_dir="nvidia_long_depths",
        mask_data_dir="nvidia_long_flow_mask",
        flow_data_dir="nvidia_long_flow_mask",
        scene_ids: Optional[Sequence[str]] = None,
        n_src_views_spatial: int = 10,
        n_src_views_temporal_track_one_side: int = 5,
        use_zoe_depth: str = "none",
        zoe_depth_data_path: Optional[str] = None,
        flow_consist_thres: float = 1.0,
        with_track_sources: bool = False,
        tgt_height: int = TGT_HEIGHT,
        spatial_dist_method: str = "dist",
    ):
        root = pathlib.Path(data_root)
        self.raw_dir = root / raw_data_dir
        self.depth_dir = root / depth_data_dir
        self.mask_dir = root / mask_data_dir
        self.flow_dir = root / flow_data_dir
        self.n_spatial = n_src_views_spatial
        self.n_track = n_src_views_temporal_track_one_side
        self.flow_consist_thres = flow_consist_thres
        self.with_track_sources = with_track_sources
        self.use_zoe_depth = use_zoe_depth
        self.tgt_height = tgt_height
        self.spatial_dist_method = spatial_dist_method
        self.zoe_depth_path = root / zoe_depth_data_path if zoe_depth_data_path else None

        scene_ids = list(scene_ids) if scene_ids is not None else ALL_SCENE_IDS
        self.items: List[tuple] = []
        self._cam_cache = {}
        for scene in sorted(scene_ids):
            mv_dir = self.raw_dir / scene / "dense/mv_images"
            if not mv_dir.is_dir():
                continue
            for frame_dir in sorted(mv_dir.iterdir()):
                if not frame_dir.is_dir():
                    continue
                frame_id = int(frame_dir.name)
                for img_f in sorted(frame_dir.iterdir()):
                    if img_f.suffix.lower() not in (".jpg", ".jpeg", ".png"):
                        continue
                    cam_id = int(img_f.stem.split("cam")[1]) - 1
                    self.items.append((scene, frame_id, cam_id, str(img_f)))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ---------------------------------------------------------------- cams

    def _cams(self, scene):
        if scene not in self._cam_cache:
            self._cam_cache[scene] = load_poses_bounds(
                self.raw_dir / scene / "dense/poses_bounds_cvd.npy")
        return self._cam_cache[scene]

    # ------------------------------------------------------------- readers

    def _mono_img_path(self, scene, frame_id):
        cam = frame_id % N_CAMS
        d = self.raw_dir / scene / f"dense/mv_images/{frame_id:05d}"
        for ext in (".jpg", ".png", ".jpeg"):
            p = d / f"cam{cam + 1:02d}{ext}"
            if p.exists():
                return p
        raise FileNotFoundError(d / f"cam{cam + 1:02d}.*")

    def _read_rgb(self, path, h, w):
        img = read_image(path)
        if img.shape[0] != h or img.shape[1] != w:
            img = resize_area(img, h, w)
        return img.astype(np.float32) / 255.0

    def _read_mask(self, scene, frame_id, h, w):
        m = read_image(self.mask_dir / scene / f"dense/masks/final/{frame_id:05d}_final.png")
        if m.ndim == 3:
            m = m[..., 0]
        if m.shape[0] != h or m.shape[1] != w:
            m = resize_nearest_pil(m, h, w)
        return (m > 0).astype(np.float32)

    def _read_depth(self, scene, frame_id, h, w):
        if self.use_zoe_depth == "none":
            depth = 1.0 / (load_arrays(self.depth_dir / scene / "disp" / f"{frame_id:05d}.npy")
                           + 1e-8)
        else:
            depth = self._read_zoe_depth(scene, frame_id)
        if depth.shape[0] != h or depth.shape[1] != w:
            depth = resize_nearest_cv(depth, h, w)
        return depth.astype(np.float32)

    def _read_zoe_depth(self, scene, frame_id):
        """ZoeDepth with disparity-space scale / shift alignment; "moe" picks
        the variant with the smallest |mean error| diagnostic."""
        variants = []
        if self.use_zoe_depth == "moe":
            for zt in ("n", "k", "nk"):
                for zp in ZOE_PRINCIPLES:
                    f = self.zoe_depth_path / scene / f"dense/zoe_depths_{zt}/{frame_id:05d}.npz"
                    info = load_arrays(f)
                    variants.append((zt, zp, abs(float(info[zp]))))
            variants.sort(key=lambda x: x[2])
            zt, zp, _ = variants[0]
        else:
            zt, zp = self.use_zoe_depth.split("_", 1)
        info = load_arrays(
            self.zoe_depth_path / scene / f"dense/zoe_depths_{zt}/{frame_id:05d}.npz")
        scale_k, shift_k = ZOE_PRINCIPLES[zp]
        raw_disp = 1.0 / (info["depth_pred"] + 1e-16)
        disp = float(info[scale_k]) * raw_disp + float(info[shift_k])
        return 1.0 / (disp + 1e-16)

    def _read_flow(self, scene, src_id, tgt_id, h, w):
        if src_id == tgt_id:
            return np.zeros((h, w, 2), np.float32), np.zeros((h, w, 1), np.float32)
        interval = abs(tgt_id - src_id)
        info = load_arrays(self.flow_dir / scene
                       / f"dense/flows/interval_{interval}/{src_id:05d}_{tgt_id:05d}.npz")
        flow = info["flow"].astype(np.float32)
        occ = (np.sum(np.abs(info["coord_diff"]), axis=2)
               > self.flow_consist_thres).astype(np.float32)[..., None]
        return flow, occ

    # --------------------------------------------------------------- items

    def _frame_bundle(self, scene, frame_ids, all_c2w, all_hwf, h, w):
        """Stack rgb / mask / depth / flat cams for a list of mono frames."""
        rgbs, masks, depths, cams = [], [], [], []
        for fid in frame_ids:
            rgbs.append(self._read_rgb(self._mono_img_path(scene, fid), h, w))
            masks.append(self._read_mask(scene, fid, h, w)[..., None])
            depths.append(self._read_depth(scene, fid, h, w)[..., None])
            k = hwf_to_intrinsics4(all_hwf[fid], tgt_shape=(h, w))
            cams.append(np.concatenate([[h, w], k.ravel(), all_c2w[fid].ravel()])
                        .astype(np.float32))
        return np.stack(rgbs), np.stack(masks), np.stack(depths), np.stack(cams)

    def _target_rgb(self, scene, img_f):
        """The target image at the eval height: resized with LANCZOS to the
        size of the scene's ``images_<w>x<h>`` directory, or to the eval
        height at the raw aspect ratio."""
        raw = read_image(img_f)
        if raw.shape[0] != self.tgt_height:
            mono_dirs = list((self.raw_dir / scene / "dense").glob(f"images_*x{self.tgt_height}"))
            if mono_dirs:
                new_w, new_h = map(int, mono_dirs[0].name.split("images_")[1].split("x"))
            else:
                new_h = self.tgt_height
                new_w = int(round(raw.shape[1] * self.tgt_height / raw.shape[0]))
            raw = resize_lanczos_pil(raw, new_h, new_w)
        return raw

    def _eval_mask(self, scene, tgt_frame, tgt_cam_id, h, w):
        f = self.raw_dir / scene / f"dense/mv_masks/{tgt_frame:05d}/cam{tgt_cam_id + 1:02d}.png"
        if not f.exists():
            return np.ones((h, w, 3), np.float32)
        em = read_image(f).astype(np.float32)
        if em.ndim == 2:
            em = np.repeat(em[..., None], 3, -1)
        em = (em > 1e-3).astype(np.float32)
        if em.shape[0] != h or em.shape[1] != w:
            em = resize_nearest_cv(em, h, w)
        return em

    def depth_range(self, sp_cam, sp_depth, tgt_c2w):
        """[0.8·min, 1.2·q90] of the z of the spatial sources' point cloud in
        the target camera (floored at 1e-16 / 2e-16), float32 [2]."""
        pts = []
        for i in range(sp_cam.shape[0]):
            k4 = sp_cam[i][2:18].reshape(4, 4)
            c2w = sp_cam[i][18:34].reshape(4, 4)
            pts.append(unproject_depth(sp_depth[i][..., 0], k4, c2w).numpy().reshape(-1, 3))
        pts = np.concatenate(pts)
        pts_h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
        cam_pts = (np.linalg.inv(tgt_c2w) @ pts_h.T).T
        return np.array(
            [max(1e-16, 0.8 * float(np.min(cam_pts[:, 2]))),
             max(2e-16, 1.2 * float(np.quantile(cam_pts[:, 2], 0.9)))],
            np.float32)

    def __getitem__(self, index):
        """The contract of item ``index``; traced as ``reader.item``."""
        with tracing.span("reader.item"):
            return self._assemble(index)

    def _assemble(self, index):
        scene, tgt_frame, tgt_cam_id, img_f = self.items[index]
        all_hwf, all_c2w, _ = self._cams(scene)
        n_frames = all_hwf.shape[0]
        in_mono = tgt_frame % N_CAMS == tgt_cam_id

        raw = self._target_rgb(scene, img_f)
        h, w = raw.shape[0], raw.shape[1]
        rgb_tgt = raw.astype(np.float32) / 255.0
        em = self._eval_mask(scene, tgt_frame, tgt_cam_id, h, w)

        # temporal sources
        if in_mono:
            temporal = [f for f in (tgt_frame - 1, tgt_frame + 1) if 0 <= f < n_frames]
        else:
            temporal = [tgt_frame]
        temporal = sorted(temporal)
        n_actual_temporal = len(temporal)
        if n_actual_temporal == 1:
            temporal.append(temporal[0])

        # spatial sources: nearest cameras in a ±12-frame window
        if in_mono:
            pool = (list(range(max(0, tgt_frame - N_CAMS), tgt_frame))
                    + list(range(tgt_frame + 1, min(n_frames, tgt_frame + N_CAMS))))
        else:
            pool = list(range(max(0, tgt_frame - N_CAMS), min(n_frames, tgt_frame + N_CAMS)))
        tgt_c2w = all_c2w[tgt_cam_id]  # poses repeat every 12: the cam id indexes them
        order = sort_poses_wrt_ref(tgt_c2w, all_c2w[pool], metric=self.spatial_dist_method)
        spatial = sorted([pool[i] for i in order[:self.n_spatial]])

        sp_rgb, sp_mask, sp_depth, sp_cam = self._frame_bundle(
            scene, spatial, all_c2w, all_hwf, h, w)
        tp_rgb, tp_mask, tp_depth, tp_cam = self._frame_bundle(
            scene, temporal, all_c2w, all_hwf, h, w)
        depth_range = self.depth_range(sp_cam, sp_depth, tgt_c2w)

        flow_fwd, flow_fwd_occ = self._read_flow(scene, temporal[0], temporal[1], h, w)
        flow_bwd, flow_bwd_occ = self._read_flow(scene, temporal[1], temporal[0], h, w)

        k_tgt = hwf_to_intrinsics4(all_hwf[tgt_cam_id], tgt_shape=(h, w))
        flat_cam_tgt = np.concatenate([[h, w], k_tgt.ravel(), tgt_c2w.ravel()]).astype(np.float32)

        data = {
            "seq_ids": np.array([tgt_frame, *spatial, *temporal], np.int64),
            "rgb_tgt": rgb_tgt,
            "rgb_src_spatial": sp_rgb,
            "dyn_rgb_src_spatial": sp_rgb * sp_mask,
            "static_rgb_src_spatial": sp_rgb * (1 - sp_mask),
            "rgb_src_temporal": tp_rgb,
            "dyn_rgb_src_temporal": tp_rgb * tp_mask,
            "static_rgb_src_temporal": tp_rgb * (1 - tp_mask),
            "dyn_mask_src_spatial": sp_mask,
            "dyn_mask_src_temporal": tp_mask,
            "flow_fwd": flow_fwd,
            "flow_fwd_occ_mask": flow_fwd_occ,
            "flow_bwd": flow_bwd,
            "flow_bwd_occ_mask": flow_bwd_occ,
            "flat_cam_tgt": flat_cam_tgt,
            "flat_cam_src_spatial": sp_cam,
            "flat_cam_src_temporal": tp_cam,
            "depth_src_spatial": sp_depth,
            "depth_src_temporal": tp_depth,
            "depth_range": depth_range,
            "time_tgt": np.array([tgt_frame], np.float32),
            "time_src_temporal": np.array(temporal, np.float32),
            "eval_mask": em,
            "misc": {
                "scene_id": scene,
                "tgt_frame_id": tgt_frame,
                "tgt_cam_id": tgt_cam_id,
                "n_actual_temporal": n_actual_temporal,
                "tgt_dyn_mask": em[..., :1],
            },
        }
        if self.with_track_sources:
            data.update(self._track_sources(scene, temporal, tgt_frame, n_frames, all_c2w,
                                            all_hwf, h, w))
        return data

    def _track_sources(self, scene, temporal, tgt_frame, n_frames, all_c2w, all_hwf, h, w):
        """±K tracking frames, padded with the temporal frame itself past the
        video's ends; n_actual counts the real ones."""
        fwd = [temporal[0]] * self.n_track
        n_fwd = 0
        if tgt_frame > 0:
            lst = list(range(max(0, temporal[0] - self.n_track), temporal[0]))
            fwd[:len(lst)] = lst
            n_fwd = len(lst)
        bwd = [temporal[1]] * self.n_track
        n_bwd = 0
        if tgt_frame < n_frames - 1:
            lst = list(range(temporal[1] + 1, min(n_frames, temporal[1] + 1 + self.n_track)))
            bwd[:len(lst)] = lst
            n_bwd = len(lst)
        out = {}
        for name, ids, n_act in (("fwd", fwd, n_fwd), ("bwd", bwd, n_bwd)):
            rgb, mask, depth, cam = self._frame_bundle(scene, ids, all_c2w, all_hwf, h, w)
            out[f"rgb_src_track_{name}"] = rgb
            out[f"dyn_mask_src_track_{name}"] = mask
            out[f"depth_src_track_{name}"] = depth
            out[f"flat_cam_src_track_{name}"] = cam
            out[f"time_src_track_{name}"] = np.array(ids, np.float32)
            out[f"n_actual_src_track_{name}"] = np.array([n_act], np.int64)
        return out
