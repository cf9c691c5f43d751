"""Geometric motion masks from epipolar flow consistency.

Equivalent of the reference's flow-epipolar mask
(``pgdvs/preprocess/compute_mask.py:164-340``): with known
camera poses, a pixel whose flow correspondence violates the epipolar
constraint (point-to-epipolar-line distance above a threshold) is moving.
The mask uses the temporally-nearest neighbor's flow (whichever camera is
closer) gated by fwd-bwd consistency, then a binary opening with a disk(1)
structuring element to kill speckle.

The port's copy of ``pgdvs_tpu.preprocess.epipolar_mask``: numpy float64 as
there; the JAX package's OpenCV opening (``MORPH_OPEN``, the 3x3 cross) is
``scipy.ndimage`` erosion then dilation with OpenCV's default border
(outside counts as set for the erosion, as unset for the dilation), and the
CLI writes its PNGs with ``data/image_io.write_png``.

  python -m pgdvs_tpu_torch.preprocess.epipolar_mask --rgb-dir <dir> \\
      --flow-dir <dir> --save-dir <dir> [--pose-dir <dir>]
"""

from __future__ import annotations

import numpy as np


def skew(v):
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )


def epipolar_distance(t_12, k_1, k_2, p_1, p_2):
    """Point-to-epipolar-line distance of correspondences.

    Args:
      t_12: [4, 4] relative transform (cam1 -> cam2).
      k_1, k_2: [3, 3] intrinsics.
      p_1, p_2: [3, N] homogeneous pixel coordinates.
    Returns: [N] absolute geometric epipolar distance.
    """
    e_mat = skew(t_12[:3, 3]) @ t_12[:3, :3]
    f_mat = np.linalg.inv(k_2).T @ e_mat @ np.linalg.inv(k_1)
    l_2 = f_mat @ p_1
    algebraic = np.sum(p_2 * l_2, axis=0)
    norm = np.sqrt(l_2[0] ** 2 + l_2[1] ** 2) + 1e-8
    return np.abs(algebraic / norm)


CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def _binary_opening_disk1(mask):
    """Binary opening with a disk(1) (3x3 cross) structuring element, with
    OpenCV's borders: erosion sees set pixels outside, dilation unset."""
    from scipy import ndimage as ndi

    eroded = ndi.binary_erosion(mask.astype(bool), structure=CROSS, border_value=1)
    return ndi.binary_dilation(eroded, structure=CROSS, border_value=0)


def epipolar_motion_mask(
    *,
    flow_fwd,
    flow_bwd,
    consist_fwd,
    consist_bwd,
    w2c_ref,
    k_ref,
    w2c_prev=None,
    k_prev=None,
    w2c_post=None,
    k_post=None,
    threshold: float = 1.0,
):
    """Motion mask for a reference frame from its fwd/bwd flows.

    Args:
      flow_fwd/flow_bwd: [H, W, 2] flows ref->post / ref->prev (either may
        be None at sequence ends).
      consist_fwd/consist_bwd: [H, W] bool fwd-bwd-consistency masks.
      w2c_*: [4, 4] world-to-camera; k_*: [3, 3] (or [4, 4]) intrinsics.
      threshold: epipolar distance (px) above which a pixel is dynamic.

    Returns: [H, W] bool motion mask.
    """
    def k3(k):
        return np.asarray(k, np.float64)[:3, :3]

    some_flow = flow_fwd if flow_fwd is not None else flow_bwd
    h, w = some_flow.shape[:2]
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    p_ref = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float64)
    p_ref_h = np.concatenate([p_ref, np.ones((p_ref.shape[0], 1))], axis=1).T

    def e_dist(flow, w2c_other, k_other):
        t = w2c_other @ np.linalg.inv(w2c_ref)
        p_other = p_ref + flow.reshape(-1, 2)
        p_other_h = np.concatenate(
            [p_other, np.ones((p_other.shape[0], 1))], axis=1
        ).T
        d = epipolar_distance(t, k3(k_ref), k3(k_other), p_ref_h, p_other_h)
        return d.reshape(h, w)

    use_prev = None
    if flow_fwd is None:
        use_prev = True
    elif flow_bwd is None:
        use_prev = False
    else:
        c_ref = np.linalg.inv(w2c_ref)[:3, 3]
        d_prev = np.sum(np.abs(np.linalg.inv(w2c_prev)[:3, 3] - c_ref))
        d_post = np.sum(np.abs(np.linalg.inv(w2c_post)[:3, 3] - c_ref))
        use_prev = d_prev < d_post

    if use_prev:
        dist = e_dist(flow_bwd, w2c_prev, k_prev) * consist_bwd
    else:
        dist = e_dist(flow_fwd, w2c_post, k_post) * consist_fwd

    return _binary_opening_disk1(dist > threshold)


def main(argv=None):
    """CLI: geometric motion masks for a scene from flows + COLMAP poses.

    Expects the compute_flow npz layout under --flow-dir (interval_1/) and a
    poses/<stem>.npz {c2w, K} directory (depth_converters layout) or a
    poses_bounds.npy; writes final/<stem>_final.png masks (the on-disk name
    the datasets read).
    """
    import argparse
    import pathlib

    from pgdvs_tpu_torch.data.image_io import write_png

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--rgb-dir", required=True)
    p.add_argument("--flow-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--pose-dir", default=None,
                   help="poses/<stem>.npz dir; default <rgb-dir>/../poses")
    p.add_argument("--threshold", type=float, default=1.0)
    p.add_argument("--consist-thres", type=float, default=1.0)
    args = p.parse_args(argv)

    rgb_dir = pathlib.Path(args.rgb_dir)
    flow_dir = pathlib.Path(args.flow_dir) / "interval_1"
    pose_dir = pathlib.Path(args.pose_dir or rgb_dir.parent / "poses")
    save_dir = pathlib.Path(args.save_dir) / "final"
    save_dir.mkdir(parents=True, exist_ok=True)

    stems = sorted(
        f.stem for f in rgb_dir.iterdir()
        if f.suffix.lower() in (".png", ".jpg", ".jpeg")
    )

    def load_pose(stem):
        z = np.load(pose_dir / f"{stem}.npz")
        c2w = np.asarray(z["c2w"], np.float64)
        return np.linalg.inv(c2w), np.asarray(z["K"], np.float64)

    def load_flow(i, j):
        f = flow_dir / f"{i:05d}_{j:05d}.npz"
        if not f.is_file():
            return None, None
        z = np.load(f)
        consist = (
            np.sum(np.abs(z["coord_diff"]), axis=2) <= args.consist_thres
        )
        return np.asarray(z["flow"], np.float32), consist

    n = len(stems)
    for i, stem in enumerate(stems):
        w2c_ref, k_ref = load_pose(stem)
        flow_fwd = flow_bwd = None
        consist_fwd = consist_bwd = None
        w2c_post = k_post = w2c_prev = k_prev = None
        if i + 1 < n:
            flow_fwd, consist_fwd = load_flow(i, i + 1)
            if flow_fwd is not None:
                w2c_post, k_post = load_pose(stems[i + 1])
        if i > 0:
            flow_bwd, consist_bwd = load_flow(i, i - 1)
            if flow_bwd is not None:
                w2c_prev, k_prev = load_pose(stems[i - 1])
        mask = epipolar_motion_mask(
            flow_fwd=flow_fwd,
            flow_bwd=flow_bwd,
            consist_fwd=consist_fwd,
            consist_bwd=consist_bwd,
            w2c_ref=w2c_ref,
            k_ref=k_ref,
            w2c_prev=w2c_prev,
            k_prev=k_prev,
            w2c_post=w2c_post,
            k_post=k_post,
            threshold=args.threshold,
        )
        write_png(save_dir / f"{stem}_final.png", (mask * 255).astype(np.uint8))
    print(f"wrote {n} masks -> {save_dir}")


if __name__ == "__main__":
    main()
