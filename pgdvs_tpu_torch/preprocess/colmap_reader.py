"""COLMAP binary/text model readers (host-side, pure python).

The port's copy of ``pgdvs_tpu.preprocess.colmap_reader``. Reads the
standard COLMAP sparse reconstruction files (cameras.bin, images.bin,
points3D.bin and their .txt forms) — same capability as the reference's
``colmap_reader.py`` (itself derived from COLMAP's public scripts). Needed
by the in-the-wild preprocessing pipeline to convert SfM output into LLFF
``poses_bounds.npy``. The JAX package reads the binary files only (its
``read_model`` raises without ``cameras.bin``); here ``read_model`` falls
back to the text files, as both docstrings say.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict

import numpy as np

# camera model id -> (name, #params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def intrinsics3(self) -> np.ndarray:
        k = np.eye(3)
        if self.model == "SIMPLE_PINHOLE" or self.model == "SIMPLE_RADIAL":
            f, cx, cy = self.params[:3]
            k[0, 0] = k[1, 1] = f
        elif self.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
            fx, fy, cx, cy = self.params[:4]
            k[0, 0], k[1, 1] = fx, fy
        elif self.model == "RADIAL":
            f, cx, cy = self.params[:3]
            k[0, 0] = k[1, 1] = f
        else:
            raise ValueError(f"unsupported camera model {self.model}")
        k[0, 2], k[1, 2] = cx, cy
        return k


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [w, x, y, z], world->camera rotation
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray

    @property
    def w2c(self) -> np.ndarray:
        from pgdvs_tpu_torch.core.geometry import qvec_to_rotmat

        m = np.eye(4)
        m[:3, :3] = qvec_to_rotmat(self.qvec)
        m[:3, 3] = self.tvec
        return m


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def _read(fid, n, fmt):
    return struct.unpack("<" + fmt, fid.read(n))


def read_cameras_bin(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, 8, "Q")[0]
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_bin(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, 8, "Q")[0]
        for _ in range(n):
            img_id = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n_pts = _read(f, 8, "Q")[0]
            data = np.array(_read(f, 24 * n_pts, "ddq" * n_pts)).reshape(-1, 3)
            out[img_id] = ColmapImage(
                img_id,
                qvec,
                tvec,
                cam_id,
                name.decode("utf-8"),
                data[:, :2],
                data[:, 2].astype(np.int64),
            )
    return out


def read_points3d_bin(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, 8, "Q")[0]
        for _ in range(n):
            pid = _read(f, 8, "Q")[0]
            xyz = np.array(_read(f, 24, "ddd"))
            rgb = np.array(_read(f, 3, "BBB"))
            error = _read(f, 8, "d")[0]
            track_len = _read(f, 8, "Q")[0]
            track = np.array(_read(f, 8 * track_len, "ii" * track_len)).reshape(-1, 2)
            out[pid] = ColmapPoint3D(
                pid, xyz, rgb, error, track[:, 0], track[:, 1]
            )
    return out


def _text_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    """cameras.txt: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]."""
    out = {}
    for line in _text_lines(path):
        el = line.split()
        cam_id = int(el[0])
        out[cam_id] = ColmapCamera(cam_id, el[1], int(el[2]), int(el[3]),
                                   np.array([float(v) for v in el[4:]]))
    return out


def read_images_text(path) -> Dict[int, ColmapImage]:
    """images.txt: per image a line IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID
    NAME, then a line of POINTS2D[] as (X, Y, POINT3D_ID), which may be
    empty."""
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    for head, pts_line in zip(lines[0::2], lines[1::2]):
        el = head.split()
        img_id = int(el[0])
        pts = np.array([float(v) for v in pts_line.split()]).reshape(-1, 3)
        out[img_id] = ColmapImage(
            img_id,
            np.array([float(v) for v in el[1:5]]),
            np.array([float(v) for v in el[5:8]]),
            int(el[8]),
            el[9],
            pts[:, :2],
            pts[:, 2].astype(np.int64),
        )
    return out


def read_points3d_text(path) -> Dict[int, ColmapPoint3D]:
    """points3D.txt: POINT3D_ID X Y Z R G B ERROR TRACK[] as (IMAGE_ID,
    POINT2D_IDX)."""
    out = {}
    for line in _text_lines(path):
        el = line.split()
        pid = int(el[0])
        track = np.array([int(v) for v in el[8:]], np.int64).reshape(-1, 2)
        out[pid] = ColmapPoint3D(
            pid,
            np.array([float(v) for v in el[1:4]]),
            np.array([int(v) for v in el[4:7]]),
            float(el[7]),
            track[:, 0],
            track[:, 1],
        )
    return out


def read_model(sparse_dir):
    """Read a sparse model directory (binary preferred, text fallback)."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        return (
            read_cameras_bin(sparse_dir / "cameras.bin"),
            read_images_bin(sparse_dir / "images.bin"),
            read_points3d_bin(sparse_dir / "points3D.bin"),
        )
    if (sparse_dir / "cameras.txt").exists():
        return (
            read_cameras_text(sparse_dir / "cameras.txt"),
            read_images_text(sparse_dir / "images.txt"),
            read_points3d_text(sparse_dir / "points3D.txt"),
        )
    raise FileNotFoundError(f"no cameras.bin or cameras.txt under {sparse_dir}")


def colmap_to_poses_scene(sparse_dir, save_dir=None, max_images: int = 1000):
    """Convert a COLMAP sparse model to the reference's in-the-wild layout.

    Exact port of ``convert_colmap_output.py:47-157`` (the artifact the
    consistent-depth third-party preprocessing consumes): images sorted by
    name; per-image c2w from qvec/tvec; ``poses.npy`` rows =
    [c2w.ravel(16) | K4.ravel(16)] with K from the single camera's
    ``params[0]`` focal and (w/2, h/2) center; ``scene.json`` =
    {scale, center, bbox} from the bbox of the 95%-inner-filtered point
    cloud plus the camera centers (scale = 1/diagonal-length). Like the
    reference, only the first ``max_images`` (=1000,
    ``convert_colmap_output.py:87-92``) name-sorted images are kept — the
    camera centers of dropped frames do not enter the bbox either.

    Returns (poses [N, 32], scene dict); writes both files when
    ``save_dir`` is given.

    Held against the JAX package's converter in
    tests/test_torch_port_preprocess.py.
    """
    import json

    cams, images, points = read_model(sparse_dir)
    assert len(cams) == 1, f"expected a single COLMAP camera, got {len(cams)}"
    cam = next(iter(cams.values()))
    k4 = np.eye(4)
    k4[0, 0] = k4[1, 1] = cam.params[0]
    k4[0, 2] = cam.width / 2.0
    k4[1, 2] = cam.height / 2.0

    ims = sorted(images.values(), key=lambda im: im.name)[:max_images]
    w2c = np.stack([im.w2c for im in ims])
    c2w = np.linalg.inv(w2c)

    pcl = np.stack([p.xyz for p in points.values()])
    # inner-percentile outlier filter (convert_colmap_output.py:32-45):
    # drop points outside the per-axis [2.5%, 97.5%] quantile box
    lo = np.quantile(pcl, 0.025, axis=0)
    hi = np.quantile(pcl, 0.975, axis=0)
    keep = ~(np.any(pcl < lo[None], axis=1) | np.any(pcl > hi[None], axis=1))
    pts = np.concatenate([pcl[keep], c2w[:, :3, 3]], axis=0)
    bbox = np.stack([pts.min(axis=0), pts.max(axis=0)])
    center = bbox.mean(axis=0)
    scale = 1.0 / np.sqrt(np.sum((bbox[1] - bbox[0]) ** 2))

    n = c2w.shape[0]
    poses = np.concatenate(
        [c2w.reshape(n, 16), np.tile(k4[None], (n, 1, 1)).reshape(n, 16)], 1
    )
    scene = {"scale": scale, "center": center.tolist(), "bbox": bbox.tolist()}
    if save_dir is not None:
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        np.save(save_dir / "poses.npy", poses)
        with open(save_dir / "scene.json", "w") as f:
            json.dump(scene, f, indent=2)
    return poses, scene


def colmap_to_poses_bounds(sparse_dir, percentile_clip: float = 99.0):
    """Convert a COLMAP sparse model to LLFF poses_bounds rows.

    Convenience utility in the LLFF/NSFF ``imgs2poses`` style (per-image
    [near, far] from visible-point depth percentiles) — useful for feeding
    the NVIDIA-layout readers from a raw COLMAP run. NOTE: the reference's
    own converter writes a different artifact (poses.npy + scene.json for
    the consistent-depth preprocessing) — see ``colmap_to_poses_scene``.

    Returns ([N, 17] poses_bounds array, sorted image names).
    """
    cams, images, points = read_model(sparse_dir)
    names = sorted(images.values(), key=lambda im: im.name)
    rows = []
    for im in names:
        cam = cams[im.camera_id]
        w2c = im.w2c
        c2w = np.linalg.inv(w2c)
        # OpenCV [right, down, fwd] -> LLFF storage [down, right, back]
        m = c2w[:3, :4].copy()
        m[:, 1:3] *= -1  # -> [right, up, back]
        llff = np.concatenate([-m[:, 1:2], m[:, 0:1], m[:, 2:4]], axis=1)
        hwf = np.array(
            [[cam.height], [cam.width], [cam.intrinsics3[0, 0]]], np.float64
        )
        pose = np.concatenate([llff, hwf], axis=1)

        zs = []
        for pid in im.point3d_ids:
            if pid >= 0 and pid in points:
                pt = points[pid].xyz
                z = (w2c @ np.array([*pt, 1.0]))[2]
                if z > 0:
                    zs.append(z)
        if zs:
            zs = np.asarray(zs)
            hi = np.percentile(zs, percentile_clip)
            zs = zs[zs <= hi]
            near, far = float(np.percentile(zs, 0.5)), float(zs.max())
        else:
            near, far = 0.1, 100.0
        rows.append(pose.ravel().tolist() + [near, far])
    return np.asarray(rows), [im.name for im in names]
