"""DyCheck iPhone reader (the Nerfies / DyCheck capture format).

The counterpart of ``pgdvs_tpu.data.dycheck_iphone``, in numpy on the host.
The on-disk layout of a scene:

  scene.json                      {center, scale, near, far}
  dataset.json, metadata.json     frame names, time / camera ids
  extra.json                      {factor, ...} (overrides ``factor``)
  splits/<split>.json             {frame_names, time_ids, camera_ids}
  rgb/<factor>x/<frame>.png       RGBA
  depth/<factor>x/<frame>.npy     (scaled by the scene scale on load)
  camera/<frame>.json             DyCheck camera (OpenCV, w2c orientation)
  covisible/<factor>x/val/<frame>.png

One item per val frame. Temporal sources: the train frame at the target's
time (the rig shares timestamps), else the nearest older and newer train
times, duplicated when there is one. Spatial sources by
``spatial_src_view_type``: "clustered" (k-means of the train camera centres,
``data.kmeans``, refit per item; the clusters nearest the target, each
giving its member nearest in time), "closest_wo_temporal" and
"closest_with_temporal" (``sort_poses_wrt_ref`` by ``dist_matrix``, the
latter over the 4 n frames nearest in time). The depth range is per pixel,
[H, W, 2]: the 0.1 / 0.9 quantiles of the spatial cloud's depth in the
target camera, clamped to the scene's near / far, then pinned to ±1e-4
around the projected static source depths at truncated integer pixel
coordinates. Dynamic masks come from ``mask_data_dir`` (all dynamic when a
mask is missing), flows from ``flow_data_dir`` (zero when missing); the
evaluation region is the covisible mask (``misc.quant_type = "dycheck"``).
The ±K track windows are clipped to the train times and left-aligned.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from pgdvs_tpu_torch.core.geometry import sort_poses_wrt_ref, unproject_depth
from pgdvs_tpu_torch.data.image_io import read_image, resize_nearest_pil
from pgdvs_tpu_torch.data.kmeans import KMeans
from pgdvs_tpu_torch.data.nvidia_eval import load_arrays

SPATIAL_SRC_VIEW_TYPES = ("clustered", "closest_wo_temporal", "closest_with_temporal")


class DyCheckCamera:
    """OpenCV-model camera: ``orientation`` is the world -> camera
    rotation, ``position`` the centre, ``image_size`` (W, H)."""

    def __init__(self, d):
        self.orientation = np.asarray(d["orientation"], np.float32)
        self.position = np.asarray(d["position"], np.float32)
        self.focal_length = float(d["focal_length"])
        self.principal_point = np.asarray(d["principal_point"], np.float32)
        self.image_size = np.asarray(d["image_size"], np.int64)
        self.skew = float(d.get("skew", 0.0))
        self.pixel_aspect_ratio = float(d.get("pixel_aspect_ratio", 1.0))

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            return cls(json.load(f))

    def _copy(self, **changes) -> "DyCheckCamera":
        out = DyCheckCamera.__new__(DyCheckCamera)
        out.__dict__.update(self.__dict__, **changes)
        return out

    def rescale(self, scale: float) -> "DyCheckCamera":
        return self._copy(focal_length=self.focal_length * scale,
                          principal_point=self.principal_point * scale,
                          image_size=np.round(self.image_size * scale).astype(np.int64))

    @property
    def intrin4(self):
        k = np.eye(4, dtype=np.float32)
        k[0, 0] = self.focal_length
        k[0, 1] = self.skew
        k[1, 1] = self.focal_length * self.pixel_aspect_ratio
        k[0, 2] = self.principal_point[0]
        k[1, 2] = self.principal_point[1]
        return k

    @property
    def w2c(self):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.orientation
        m[:3, 3] = -self.orientation @ self.position
        return m

    @property
    def c2w(self):
        return np.linalg.inv(self.w2c)


class IPhoneParser:
    """Reader of one DyCheck iPhone capture directory."""

    def __init__(self, data_dir, factor: int = 2):
        self.dir = pathlib.Path(data_dir)
        self.factor = factor
        with open(self.dir / "scene.json") as f:
            scene = json.load(f)
        self.center = np.asarray(scene["center"], np.float32)
        self.scale = float(scene["scale"])
        self.near = float(scene["near"])
        self.far = float(scene["far"])
        with open(self.dir / "metadata.json") as f:
            self.metadata = json.load(f)
        with open(self.dir / "dataset.json") as f:
            self.dataset = json.load(f)
        extra_f = self.dir / "extra.json"
        if extra_f.exists():
            with open(extra_f) as f:
                self.factor = int(json.load(f)["factor"])

    def load_split(self, split: str):
        with open(self.dir / "splits" / f"{split}.json") as f:
            d = json.load(f)
        return d["frame_names"], d["time_ids"], d["camera_ids"]

    def frame_name(self, time_id: int, camera_id: int) -> str:
        return f"{camera_id}_{time_id:05d}"

    def load_rgb(self, frame_name: str):
        rgba = read_image(self.dir / "rgb" / f"{self.factor}x" / f"{frame_name}.png")
        return rgba[..., :3].astype(np.float32) / 255.0

    def load_depth(self, frame_name: str):
        depth = load_arrays(self.dir / "depth" / f"{self.factor}x" / f"{frame_name}.npy")
        return (depth * self.scale).astype(np.float32)

    def load_camera(self, frame_name: str) -> DyCheckCamera:
        """The camera at the processing factor, in the scene's normalized
        world (recentred, rescaled)."""
        cam = DyCheckCamera.from_json(self.dir / "camera" / f"{frame_name}.json")
        cam = cam.rescale(1.0 / self.factor)
        return cam._copy(position=(cam.position - self.center) * self.scale)

    def load_covisible(self, frame_name: str, split: str = "val"):
        m = read_image(self.dir / "covisible" / f"{self.factor}x" / split / f"{frame_name}.png")
        if m.ndim == 3:
            m = m[..., 0]
        return (m > 0).astype(np.float32)


class DyCheckIPhoneEvalDataset:
    def __init__(self, data_root, scene_ids, factor: int = 2, n_src_views_spatial: int = 10,
                 mask_data_dir=None, flow_data_dir=None, flow_consist_thres: float = 1.0,
                 spatial_src_view_type: str = "clustered", n_src_views_spatial_cluster=None,
                 n_src_views_temporal_track_one_side: int = 5, with_track_sources: bool = False):
        if spatial_src_view_type not in SPATIAL_SRC_VIEW_TYPES:
            raise ValueError(f"spatial_src_view_type {spatial_src_view_type!r}; valid: "
                             f"{SPATIAL_SRC_VIEW_TYPES}")
        self.root = pathlib.Path(data_root)
        self.n_spatial = n_src_views_spatial
        # the cluster count defaults to the spatial source count
        self.n_clusters = (n_src_views_spatial if n_src_views_spatial_cluster is None
                           else n_src_views_spatial_cluster)
        self.n_track = n_src_views_temporal_track_one_side
        self.with_track_sources = with_track_sources
        self.spatial_src_view_type = spatial_src_view_type
        self.mask_dir = pathlib.Path(mask_data_dir) if mask_data_dir else None
        self.flow_dir = pathlib.Path(flow_data_dir) if flow_data_dir else None
        self.flow_consist_thres = flow_consist_thres
        self.parsers = {s: IPhoneParser(self.root / s, factor) for s in scene_ids}
        self.items = []
        self._train_cache = {}
        for scene in scene_ids:
            names, time_ids, cam_ids = self.parsers[scene].load_split("val")
            for n, t, c in zip(names, time_ids, cam_ids):
                self.items.append((scene, n, int(t), int(c)))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def _train_info(self, scene):
        """(train frame names, time ids, c2ws [N, 4, 4] float32)."""
        if scene not in self._train_cache:
            p = self.parsers[scene]
            names, time_ids, _ = p.load_split("train")
            c2ws = np.stack([p.load_camera(n).c2w for n in names])
            self._train_cache[scene] = (names, list(map(int, time_ids)), c2ws)
        return self._train_cache[scene]

    def _dyn_mask(self, scene, frame_name, h, w):
        if self.mask_dir is not None:
            p = self.mask_dir / scene / f"masks/final/{frame_name}_final.png"
            if p.exists():
                m = read_image(p)
                if m.ndim == 3:
                    m = m[..., 0]
                if m.shape != (h, w):
                    m = resize_nearest_pil(m, h, w)
                return (m > 0).astype(np.float32)[..., None]
        return np.ones((h, w, 1), np.float32)

    def _flow(self, scene, name_a, name_b, h, w):
        if self.flow_dir is not None and name_a != name_b:
            for interval in (1, 2):
                p = self.flow_dir / scene / f"flows/interval_{interval}/{name_a}_{name_b}.npz"
                if p.exists():
                    info = load_arrays(p)
                    occ = (np.sum(np.abs(info["coord_diff"]), axis=2)
                           > self.flow_consist_thres).astype(np.float32)[..., None]
                    return info["flow"].astype(np.float32), occ
        return np.zeros((h, w, 2), np.float32), np.zeros((h, w, 1), np.float32)

    def select_spatial(self, scene, tgt_c2w, tgt_time):
        """Sorted train indices of the spatial sources."""
        names, _, c2ws = self._train_info(scene)
        if self.spatial_src_view_type == "clustered":
            km = KMeans(n_clusters=min(self.n_clusters, len(names)), random_state=0).fit(
                c2ws[:, :3, 3])
            dists = np.linalg.norm(km.cluster_centers_ - tgt_c2w[:3, 3], axis=1)
            chosen = []
            for label in np.argsort(dists)[:self.n_spatial]:
                members = np.nonzero(km.labels_ == label)[0]
                # the member nearest in time; the frame index stands in for
                # the time (train times are consecutive)
                t_dist = np.abs(members.astype(np.float32) - float(tgt_time))
                chosen.append(int(members[np.argmin(t_dist)]))
            return sorted(chosen)
        if self.spatial_src_view_type == "closest_wo_temporal":
            order = sort_poses_wrt_ref(tgt_c2w, c2ws, metric="dist_matrix")
            return sorted(order[:self.n_spatial].tolist())
        t_dist = np.abs(np.arange(len(names), dtype=np.float32) - float(tgt_time))
        pool = np.argsort(t_dist)[:self.n_spatial * 4]
        order = sort_poses_wrt_ref(tgt_c2w, c2ws[pool], metric="dist_matrix")
        return sorted(pool[order][:self.n_spatial].tolist())

    def _bundle(self, scene, idxs, h, w):
        """Stacked rgb / dyn mask / depth / flat cams of train frames
        ``idxs``, with their world points and dynamic flags concatenated."""
        p = self.parsers[scene]
        names = self._train_info(scene)[0]
        rgbs, masks, depths, cams, pcls, dyn = [], [], [], [], [], []
        for i in idxs:
            cam = p.load_camera(names[i])
            depth = p.load_depth(names[i])
            if depth.ndim == 3:
                depth = depth[..., 0]
            dmask = self._dyn_mask(scene, names[i], h, w)
            cams.append(np.concatenate([[h, w], cam.intrin4.ravel(), cam.c2w.ravel()])
                        .astype(np.float32))
            rgbs.append(p.load_rgb(names[i]))
            depths.append(depth[..., None])
            masks.append(dmask)
            pcls.append(unproject_depth(depth, cam.intrin4, cam.c2w).numpy().reshape(-1, 3))
            dyn.append(dmask.reshape(-1) > 0)
        return (np.stack(rgbs), np.stack(masks), np.stack(depths), np.stack(cams),
                np.concatenate(pcls), np.concatenate(dyn))

    def depth_range(self, parser, tgt_camera, sp_pcl, sp_dyn, h, w):
        """The per-pixel [H, W, 2] float32 range (module docstring)."""
        tgt_c2w = tgt_camera.c2w
        w2c = np.linalg.inv(tgt_c2w)
        pts_h = np.concatenate([sp_pcl, np.ones_like(sp_pcl[:, :1])], axis=1)
        cam_pts = (w2c @ pts_h.T).T
        dr_min = max(parser.near, float(np.quantile(cam_pts[:, 2], 0.1)))
        dr_max = min(parser.far, float(np.quantile(cam_pts[:, 2], 0.9)))
        depth_range = np.tile(np.array([dr_min, dr_max], np.float32).reshape(1, 1, 2),
                              (h, w, 1))
        static_pcl = sp_pcl[~sp_dyn]
        if static_pcl.shape[0] > 0:
            sh = np.concatenate([static_pcl, np.ones_like(static_pcl[:, :1])], 1)
            cam_static = (w2c @ sh.T).T[:, :3]
            pix = (tgt_camera.intrin4[:3, :3] @ cam_static.T).T
            uv = pix[:, :2] / (pix[:, 2:] + 1e-8)
            ok = (uv[:, 0] >= 0) & (uv[:, 0] <= w - 1) & (uv[:, 1] >= 0) & (uv[:, 1] <= h - 1)
            uvi = uv[ok].astype(int)  # truncated, not rounded
            zs = cam_static[ok, 2]
            depth_range[uvi[:, 1], uvi[:, 0], 0] = zs - 1e-4
            depth_range[uvi[:, 1], uvi[:, 0], 1] = zs + 1e-4
        return depth_range

    def __getitem__(self, index):
        scene, tgt_name, tgt_time, _ = self.items[index]
        p = self.parsers[scene]
        names, time_ids, _ = self._train_info(scene)
        tgt_camera = p.load_camera(tgt_name)
        tgt_c2w = tgt_camera.c2w
        rgb_tgt = p.load_rgb(tgt_name)
        h, w = rgb_tgt.shape[:2]
        covis = p.load_covisible(tgt_name)

        tids = np.asarray(time_ids)
        temporal_idx = []
        if tgt_time in tids:
            temporal_idx.append(int(np.nonzero(tids == tgt_time)[0][0]))
        else:
            older, newer = tids[tids < tgt_time], tids[tids > tgt_time]
            if older.size:
                temporal_idx.append(int(np.nonzero(tids == older.max())[0][0]))
            if newer.size:
                temporal_idx.append(int(np.nonzero(tids == newer.min())[0][0]))
        n_actual = len(temporal_idx)
        if n_actual == 1:
            temporal_idx.append(temporal_idx[0])
        temporal_idx = sorted(temporal_idx)
        spatial_idx = self.select_spatial(scene, tgt_c2w, tgt_time)

        sp_rgb, sp_mask, sp_depth, sp_cam, sp_pcl, sp_dyn = self._bundle(scene, spatial_idx, h, w)
        tp_rgb, tp_mask, tp_depth, tp_cam, _, _ = self._bundle(scene, temporal_idx, h, w)
        depth_range = self.depth_range(p, tgt_camera, sp_pcl, sp_dyn, h, w)
        flow_fwd, fo = self._flow(scene, names[temporal_idx[0]], names[temporal_idx[1]], h, w)
        flow_bwd, bo = self._flow(scene, names[temporal_idx[1]], names[temporal_idx[0]], h, w)
        flat_cam_tgt = np.concatenate([[h, w], tgt_camera.intrin4.ravel(), tgt_c2w.ravel()]
                                      ).astype(np.float32)
        data = {
            "seq_ids": np.array([tgt_time, *spatial_idx, *temporal_idx], np.int64),
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
            "time_src_temporal": np.array([time_ids[i] for i in temporal_idx], np.float32),
            "eval_mask": covis[..., None],
            "misc": {
                "scene_id": scene,
                "tgt_frame_name": tgt_name,
                "covisible_mask": covis[..., None],
                "n_actual_temporal": n_actual,
                "quant_type": "dycheck",
            },
        }
        if self.with_track_sources:
            data.update(self._track_sources(scene, tids, temporal_idx, h, w))
        return data

    def _track_sources(self, scene, tids, temporal_idx, h, w):
        """±K track frames by time, clipped to the train times, left-aligned
        and padded with the temporal frame."""
        min_t, max_t = int(tids.min()), int(tids.max())
        t0, t1 = int(tids[temporal_idx[0]]), int(tids[temporal_idx[1]])
        out = {}
        for side, ts, fill in (
                ("fwd", range(max(min_t, t0 - self.n_track), t0), temporal_idx[0]),
                ("bwd", range(t1 + 1, min(max_t + 1, t1 + 1 + self.n_track)), temporal_idx[1])):
            ts = list(ts)
            idxs = [int(np.nonzero(tids == t)[0][0]) for t in ts]
            idxs += [fill] * (self.n_track - len(ts))
            rgb, mask, depth, cam, _, _ = self._bundle(scene, idxs, h, w)
            out[f"rgb_src_track_{side}"] = rgb
            out[f"dyn_mask_src_track_{side}"] = mask
            out[f"depth_src_track_{side}"] = depth
            out[f"flat_cam_src_track_{side}"] = cam
            out[f"time_src_track_{side}"] = np.array([tids[i] for i in idxs], np.float32)
            out[f"n_actual_src_track_{side}"] = np.array([len(ts)], np.int64)
        return out
