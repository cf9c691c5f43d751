"""NVIDIA visualization reader: space-time trajectories (bullet time).

The counterpart of ``pgdvs_tpu.data.nvidia_vis``: novel views along a
trajectory that slerp + lerp interpolates consecutive mono-video poses at
fractional times, each composed with a circular "bullet-time" camera offset
(NSFF's render path: translation amplitude max_disp / focal, the amplitude
scaled by the scene's near bound, repeated N_BT_REPS times per sweep). Each
item is the eval reader's contract at the raw mono frame's size, without
``rgb_tgt`` / ``eval_mask`` (there is no ground truth at a virtual view),
with a fractional ``time_tgt`` that drives the dynamic point cloud's
interpolation, and the virtual camera's K made from frame 0's hwf. The
temporal sources are the frames either side of the fractional time; the
spatial sources the nearest cameras in the ±12-frame window around them;
the track windows (``with_track_sources``) the eval reader's.
"""

from __future__ import annotations

import numpy as np

from pgdvs_tpu_torch.core.geometry import linear_pose_interp, sort_poses_wrt_ref
from pgdvs_tpu_torch.data.image_io import image_hw
from pgdvs_tpu_torch.data.llff import hwf_to_intrinsics4
from pgdvs_tpu_torch.data.nvidia_eval import N_CAMS, NvidiaEvalDataset

N_BT_REPS = 8


def create_bt_poses(focal, num_frames: int, max_disp: float = 32.0, sc=None):
    """Bullet-time circular offset poses: a list of ``num_frames`` 4x4
    inverse offsets with translation amplitude ``max_disp / focal``
    (max_disp divided by the scene scale ``sc`` first, when given)."""
    if sc is not None:
        max_disp = max_disp / sc
    max_trans = max_disp / float(focal)
    out = []
    for i in range(num_frames):
        x = max_trans * np.sin(2.0 * np.pi * i / num_frames)
        y = max_trans * np.cos(2.0 * np.pi * i / num_frames) / 2.0
        pose = np.eye(4)
        pose[:3, 3] = [x, y, 0.0]
        out.append(np.linalg.inv(pose))
    return out


def bt_trajectory(c2ws, focal, bt_disp_sc, n_render_frames, vis_center_time,
                  vis_time_interval, vis_bt_max_disp):
    """[(time, c2w)] of the trajectory: ``n_render_frames`` times spaced over
    [center - interval, center + interval] clipped to [0, n - 2], each pose
    the slerp + lerp of its two frames' poses times its bullet-time
    offset."""
    n = len(c2ws)
    times = np.linspace(max(0, vis_center_time - vis_time_interval),
                        min(n - 2, vis_center_time + vis_time_interval), n_render_frames)
    bt = create_bt_poses(focal, num_frames=max(1, n_render_frames // N_BT_REPS),
                         max_disp=vis_bt_max_disp, sc=bt_disp_sc)
    bt = bt * (N_BT_REPS + 1)
    out = []
    for i, t in enumerate(times):
        it = int(np.floor(t))
        rot, trans = linear_pose_interp(c2ws[it][:3, 3], c2ws[it][:3, :3],
                                        c2ws[it + 1][:3, 3], c2ws[it + 1][:3, :3],
                                        float(t - np.floor(t)))
        c2w = np.eye(4)
        c2w[:3, :3] = rot
        c2w[:3, 3] = trans
        out.append((float(t), c2w @ bt[i]))
    return out


def temporal_pair(tgt_time: float, n_frames: int):
    """(the frames either side of ``tgt_time``, duplicated at the video's
    ends; how many are real)."""
    f0 = int(np.floor(tgt_time))
    temporal = sorted({f for f in (f0 if tgt_time > 0 else None,
                                   f0 + 1 if tgt_time < n_frames - 1 else None)
                       if f is not None})
    n_actual = len(temporal)
    if n_actual == 1:
        temporal.append(temporal[0])
    return temporal, n_actual


class NvidiaVisDataset(NvidiaEvalDataset):
    """One item per trajectory frame, over every scene the eval reader
    finds; the eval reader's arguments plus the trajectory's."""

    def __init__(self, *args, n_render_frames: int = 200, vis_center_time: int = 50,
                 vis_time_interval: int = 10, vis_bt_max_disp: float = 64.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_render_frames = n_render_frames
        self.vis_center_time = vis_center_time
        self.vis_time_interval = vis_time_interval
        self.vis_bt_max_disp = vis_bt_max_disp
        self.traj = []
        for scene in sorted({s for s, *_ in self.items}):
            all_hwf, all_c2w, bds = self._cams(scene)
            # the amplitude is normalized by the near bounds (NSFF's
            # bd_factor rescale moved into the translation)
            bt_disp_sc = 1.0 / (np.percentile(bds[:, 0], 5) * 0.9)
            for i, (t, c2w) in enumerate(bt_trajectory(
                    all_c2w, all_hwf[0, 2], bt_disp_sc, n_render_frames, vis_center_time,
                    vis_time_interval, vis_bt_max_disp)):
                self.traj.append((scene, t, i, c2w))

    def __len__(self):
        return len(self.traj)

    def __getitem__(self, index):
        scene, tgt_time, frame_i, tgt_c2w = self.traj[index]
        all_hwf, all_c2w, _ = self._cams(scene)
        n_frames = all_hwf.shape[0]
        temporal, n_actual_temporal = temporal_pair(tgt_time, n_frames)

        pool = list(range(max(0, temporal[0] - N_CAMS), min(n_frames, temporal[1] + N_CAMS)))
        order = sort_poses_wrt_ref(tgt_c2w, all_c2w[pool], metric="dist")
        spatial = sorted([pool[i] for i in order[:self.n_spatial]])

        # the working size is the first temporal source's raw frame size
        h, w = image_hw(self._mono_img_path(scene, temporal[0]))
        sp_rgb, sp_mask, sp_depth, sp_cam = self._frame_bundle(
            scene, spatial, all_c2w, all_hwf, h, w)
        tp_rgb, tp_mask, tp_depth, tp_cam = self._frame_bundle(
            scene, temporal, all_c2w, all_hwf, h, w)
        depth_range = self.depth_range(sp_cam, sp_depth, tgt_c2w)
        flow_fwd, flow_fwd_occ = self._read_flow(scene, temporal[0], temporal[1], h, w)
        flow_bwd, flow_bwd_occ = self._read_flow(scene, temporal[1], temporal[0], h, w)

        k_tgt = hwf_to_intrinsics4(all_hwf[0], tgt_shape=(h, w))
        flat_cam_tgt = np.concatenate([[h, w], k_tgt.ravel(), tgt_c2w.ravel()]).astype(np.float32)
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
            "flow_fwd_occ_mask": flow_fwd_occ,
            "flow_bwd": flow_bwd,
            "flow_bwd_occ_mask": flow_bwd_occ,
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
                "n_actual_temporal": n_actual_temporal,
            },
        }
        if self.with_track_sources:
            data.update(self._track_sources(scene, temporal, tgt_time, n_frames, all_c2w,
                                            all_hwf, h, w))
        return data
