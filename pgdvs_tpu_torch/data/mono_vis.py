"""In-the-wild monocular visualization reader (the DAVIS layout).

The counterpart of ``pgdvs_tpu.data.mono_vis``: it reads the preprocessing
pipeline's layout

  <root>/<scene>/rgbs/<name>.png | .jpg
  <root>/<scene>/poses/<name>.npz                {K [4,4] or [3,3], c2w [4,4]}
  <root>/<scene>/depths/<name>.npz               {depth [H,W]}
  <root>/<scene>/masks/final/<name>_final.png
  <root>/<scene>/flows/interval_<k>/<a>_<b>.npz  {flow, coord_diff}

and renders the NVIDIA vis reader's slerp + bullet-time trajectory, its
amplitude scaled by the 5th percentile of the per-frame 5th-percentile
depths (x 0.9 as 1 / scale). The spatial sources rank every frame by camera
distance (no ±12-frame window); the virtual camera takes frame 0's K; masks
off the frame size take PIL's NEAREST resize (``resize_nearest_pil``).
"""

from __future__ import annotations

import pathlib

import numpy as np

from pgdvs_tpu_torch.core.geometry import sort_poses_wrt_ref, unproject_depth
from pgdvs_tpu_torch.data.image_io import read_image, resize_nearest_pil
from pgdvs_tpu_torch.data.nvidia_eval import load_arrays
from pgdvs_tpu_torch.data.nvidia_vis import bt_trajectory, temporal_pair


class MonoVisDataset:
    def __init__(self, data_root, scene_ids, n_render_frames: int = 200,
                 vis_center_time: int = 50, vis_time_interval: int = 10,
                 vis_bt_max_disp: float = 64.0, n_src_views_spatial: int = 10,
                 flow_consist_thres: float = 1.0, n_src_views_temporal_track_one_side: int = 5,
                 with_track_sources: bool = False):
        self.root = pathlib.Path(data_root)
        self.n_spatial = n_src_views_spatial
        self.flow_consist_thres = flow_consist_thres
        self.n_track = n_src_views_temporal_track_one_side
        self.with_track_sources = with_track_sources
        self.traj = []
        self._scene_cache = {}
        for scene in scene_ids:
            ks, c2ws, names = self._scene_cams(scene)
            bounds = [np.percentile(load_arrays(self.root / scene / f"depths/{name}.npz")
                                    ["depth"].reshape(-1), 5) for name in names]
            bt_disp_sc = 1.0 / (np.percentile(np.asarray(bounds), 5) * 0.9)
            for i, (t, c2w) in enumerate(bt_trajectory(
                    c2ws, ks[0][0, 0], bt_disp_sc, n_render_frames, vis_center_time,
                    vis_time_interval, vis_bt_max_disp)):
                self.traj.append((scene, t, i, c2w))

    def _scene_cams(self, scene):
        """(K 4x4 list, c2w list, frame names) of a scene, float64."""
        if scene not in self._scene_cache:
            pose_fs = sorted((self.root / scene / "poses").glob("*.npz"))
            ks, c2ws = [], []
            for f in pose_fs:
                info = load_arrays(f)
                k = np.asarray(info["K"], np.float64)
                if k.shape == (3, 3):
                    k4 = np.eye(4)
                    k4[:3, :3] = k
                    k = k4
                ks.append(k)
                c2ws.append(np.asarray(info["c2w"], np.float64))
            self._scene_cache[scene] = (ks, c2ws, [f.stem for f in pose_fs])
        return self._scene_cache[scene]

    def __len__(self):
        return len(self.traj)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def _read_rgb(self, scene, name):
        for ext in (".png", ".jpg"):
            p = self.root / scene / f"rgbs/{name}{ext}"
            if p.exists():
                return read_image(p).astype(np.float32) / 255.0
        raise FileNotFoundError(f"{scene}/rgbs/{name}")

    def _read_mask(self, scene, name, h, w):
        m = read_image(self.root / scene / f"masks/final/{name}_final.png")
        if m.ndim == 3:
            m = m[..., 0]
        if m.shape != (h, w):
            m = resize_nearest_pil(m, h, w)
        return (m > 0).astype(np.float32)[..., None]

    def _read_flow(self, scene, names, i, j, h, w):
        if i == j:
            return np.zeros((h, w, 2), np.float32), np.zeros((h, w, 1), np.float32)
        info = load_arrays(self.root / scene / f"flows/interval_{abs(j - i)}/"
                           f"{names[i]}_{names[j]}.npz")
        occ = (np.sum(np.abs(info["coord_diff"]), axis=2)
               > self.flow_consist_thres).astype(np.float32)[..., None]
        return info["flow"].astype(np.float32), occ

    def _bundle(self, scene, ids):
        """Stacked rgb / mask / depth / flat cams of frames ``ids``."""
        ks, c2ws, names = self._scene_cams(scene)
        rgbs, masks, depths, cams = [], [], [], []
        for i in ids:
            rgb = self._read_rgb(scene, names[i])
            h, w = rgb.shape[:2]
            rgbs.append(rgb)
            masks.append(self._read_mask(scene, names[i], h, w))
            depths.append(load_arrays(self.root / scene / f"depths/{names[i]}.npz")["depth"]
                          .astype(np.float32)[..., None])
            cams.append(np.concatenate([[h, w], ks[i].ravel(), c2ws[i].ravel()])
                        .astype(np.float32))
        return np.stack(rgbs), np.stack(masks), np.stack(depths), np.stack(cams)

    def __getitem__(self, index):
        scene, tgt_time, frame_i, tgt_c2w = self.traj[index]
        ks, c2ws, names = self._scene_cams(scene)
        n = len(names)
        temporal, n_actual = temporal_pair(tgt_time, n)
        order = sort_poses_wrt_ref(tgt_c2w, np.stack(c2ws), metric="dist")
        spatial = sorted(order[:self.n_spatial].tolist())

        sp_rgb, sp_mask, sp_depth, sp_cam = self._bundle(scene, spatial)
        tp_rgb, tp_mask, tp_depth, tp_cam = self._bundle(scene, temporal)
        h, w = sp_rgb.shape[1:3]

        pts = np.concatenate([unproject_depth(sp_depth[i][..., 0], ks[fid], c2ws[fid])
                              .numpy().reshape(-1, 3) for i, fid in enumerate(spatial)])
        pts_h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
        cam_pts = (np.linalg.inv(tgt_c2w) @ pts_h.T).T
        depth_range = np.array([max(1e-16, 0.8 * float(np.min(cam_pts[:, 2]))),
                                max(2e-16, 1.2 * float(np.quantile(cam_pts[:, 2], 0.9)))],
                               np.float32)
        flow_fwd, fo = self._read_flow(scene, names, temporal[0], temporal[1], h, w)
        flow_bwd, bo = self._read_flow(scene, names, temporal[1], temporal[0], h, w)
        flat_cam_tgt = np.concatenate([[h, w], ks[0].ravel(), tgt_c2w.ravel()]).astype(np.float32)
        data = {
            "seq_ids": np.array([frame_i, *spatial, *temporal], np.int64),
            "rgb_src_spatial": sp_rgb,
            "dyn_rgb_src_spatial": sp_rgb * sp_mask,
            "static_rgb_src_spatial": sp_rgb * (1 - sp_mask),
            "rgb_src_temporal": tp_rgb,
            "dyn_rgb_src_temporal": tp_rgb * tp_mask,
            "static_rgb_src_temporal": tp_rgb * (1 - tp_mask),
            "dyn_mask_src_spatial": sp_mask,
            "dyn_mask_src_temporal": tp_mask,
            "flow_fwd": flow_fwd,
            "flow_fwd_occ_mask": fo,
            "flow_bwd": flow_bwd,
            "flow_bwd_occ_mask": bo,
            "flat_cam_tgt": flat_cam_tgt,
            "flat_cam_src_spatial": sp_cam,
            "flat_cam_src_temporal": tp_cam,
            "depth_src_spatial": sp_depth,
            "depth_src_temporal": tp_depth,
            "depth_range": depth_range,
            "time_tgt": np.array([tgt_time], np.float32),
            "time_src_temporal": np.array(temporal, np.float32),
            "misc": {
                "scene_id": scene,
                "vis_frame_i": frame_i,
                "tgt_time": tgt_time,
                "n_actual_temporal": n_actual,
            },
        }
        if self.with_track_sources:
            data.update(self._track_sources(scene, temporal, tgt_time, n))
        return data

    def _track_sources(self, scene, temporal, tgt_time, n_frames):
        """±K track frames, left-aligned and padded with the temporal frame;
        a side exists only when the virtual time has room on it."""
        fwd = (list(range(max(0, temporal[0] - self.n_track), temporal[0]))
               if tgt_time > 0 else [])
        bwd = (list(range(temporal[1] + 1, min(n_frames, temporal[1] + 1 + self.n_track)))
               if tgt_time < n_frames - 1 else [])
        out = {}
        for side, ids, fill in (("fwd", fwd, temporal[0]), ("bwd", bwd, temporal[1])):
            padded = ids + [fill] * (self.n_track - len(ids))
            rgb, mask, depth, cam = self._bundle(scene, padded)
            out[f"rgb_src_track_{side}"] = rgb
            out[f"dyn_mask_src_track_{side}"] = mask
            out[f"depth_src_track_{side}"] = depth
            out[f"flat_cam_src_track_{side}"] = cam
            out[f"time_src_track_{side}"] = np.array(padded, np.float32)
            out[f"n_actual_src_track_{side}"] = np.array([len(ids)], np.int64)
        return out
