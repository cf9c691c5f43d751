"""The port's preprocessing modules without networks against the JAX
package's, on the CPU, from the same seeded numpy inputs.

  * ``flow_roundtrip`` / ``occlusion_mask`` on smooth random flows, and on
    images one pixel high or wide: coord_diff and its norm within 1e-5 px,
    the masks equal away from the threshold (1e-4);
  * the FlowFormer grid and Gaussian weights equal, ``tiled_flow`` equal,
    ``adaptive_flow`` (cubic up to the train size, linear back) within 1e-5
    of the flow's scale, and ``compute_scene_flows(tiling="flowformer")``
    with a model-free flow function against JAX's at the same bound;
  * ``epipolar_motion_mask`` on the synthetic scene equal; the opening
    (scipy erosion and dilation with OpenCV's borders) equal to JAX's
    ``cv2.morphologyEx`` on random masks touching every border; the CLI's
    PNGs decode equal;
  * ``combine_masks`` over a five-frame sequence with flows, consistency
    and SAM segments equal on every output; the CLI's arrays equal;
  * COLMAP: a random binary model and its text form read alike;
    ``colmap_to_poses_scene`` and ``colmap_to_poses_bounds`` equal to JAX's
    (held against the JAX package only: tests/test_colmap_ab.py needs the
    reference's sources);
  * ``colmap_driver``: the argument lists through a patched ``_run`` equal
    JAX's; without the binary both refuse alike;
  * ``depth_align`` (and its CLI), both ``depth_converters`` and
    ``dycheck_extract`` on a synthetic iPhone capture: the files equal
    (the RGB PNGs decoded).

The numpy modules are copies, so most comparisons are exact.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pgdvs_tpu.data import synthetic
from pgdvs_tpu.preprocess import colmap_driver as j_colmap_driver
from pgdvs_tpu.preprocess import colmap_reader as j_colmap_reader
from pgdvs_tpu.preprocess import combine_masks as j_combine_masks
from pgdvs_tpu.preprocess import compute_flow as j_compute_flow
from pgdvs_tpu.preprocess import depth_align as j_depth_align
from pgdvs_tpu.preprocess import depth_converters as j_depth_converters
from pgdvs_tpu.preprocess import dycheck_extract as j_dycheck_extract
from pgdvs_tpu.preprocess import epipolar_mask as j_epipolar_mask
from pgdvs_tpu.preprocess import flow_consistency as j_flow_consistency
from pgdvs_tpu.preprocess import flowformer_tiling as j_tiling
from pgdvs_tpu_torch.data.image_io import read_image, write_png
from pgdvs_tpu_torch.preprocess import (colmap_driver, colmap_reader, combine_masks,
                                        compute_flow, depth_align, depth_converters,
                                        dycheck_extract, epipolar_mask, flow_consistency,
                                        flowformer_tiling)


def _smooth_flow(rng, h, w, amp=6.0):
    small = rng.uniform(-amp, amp, (-(-h // 4), -(-w // 4), 2)).astype(np.float32)
    return np.kron(small, np.ones((4, 4, 1), np.float32))[:h, :w] + rng.normal(
        0, 0.3, (h, w, 2)).astype(np.float32)


def _write_rgbs(rgb_dir, n, hw, seed=0):
    rng = np.random.default_rng(seed)
    rgb_dir.mkdir(parents=True)
    for i in range(n):
        write_png(rgb_dir / f"{i:05d}.png", rng.integers(0, 256, hw + (3,), dtype=np.uint8))


# ------------------------------------------------------------------- flow


@pytest.mark.parametrize("hw", [(40, 52), (1, 9), (7, 1)])
def test_flow_roundtrip_matches_jax(hw):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    narrow = min(hw) == 1
    fwd = _smooth_flow(rng, *hw, amp=0.6 if narrow else 6.0)
    bwd = -fwd + rng.normal(0, 0.5, fwd.shape).astype(np.float32)
    ref_cd, ref_err = j_flow_consistency.flow_roundtrip(jnp.asarray(fwd), jnp.asarray(bwd))
    cd, err = flow_consistency.flow_roundtrip(torch.from_numpy(fwd), torch.from_numpy(bwd))
    np.testing.assert_allclose(cd.numpy(), np.asarray(ref_cd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref_err), rtol=0, atol=1e-5)
    occ = flow_consistency.occlusion_mask(torch.from_numpy(fwd), torch.from_numpy(bwd), 1.0)
    ref_occ = np.asarray(j_flow_consistency.occlusion_mask(jnp.asarray(fwd), jnp.asarray(bwd), 1.0))
    far = np.abs(np.asarray(ref_err) - 1.0) > 1e-4
    np.testing.assert_array_equal(occ.numpy()[far], ref_occ[far])
    assert narrow or (occ.any() and not occ.all())


def test_flowformer_grid_and_weights_match_jax():
    for shape, patch, ov in (((600, 1400), (432, 960), 20), ((432, 960), (432, 960), 20),
                             ((56, 100), (32, 48), 8), ((77, 49), (32, 48), 5)):
        assert (flowformer_tiling.compute_grid_indices(shape, patch, ov)
                == j_tiling.compute_grid_indices(shape, patch, ov))
    with pytest.raises(ValueError):
        flowformer_tiling.compute_grid_indices((50, 50), (10, 10), 10)
    for size in ((300, 500), (35, 45), (432, 960)):
        assert (flowformer_tiling.compute_adaptive_image_size(size)
                == j_tiling.compute_adaptive_image_size(size))
    for patch, sigma in (((6, 8), 0.7), ((432, 960), 1.0)):
        np.testing.assert_array_equal(flowformer_tiling.gaussian_patch_weight(patch, sigma),
                                      j_tiling.gaussian_patch_weight(patch, sigma))


def _image_model(a, b):
    """A model-free 'flow' that depends on both images and their size."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.stack([(a[..., 0] - b[..., 1]) * 7.0, a[..., 2] * 3.0 - b[..., 0]], axis=-1)


def test_flowformer_tiled_and_adaptive_flow_match_jax():
    rng = np.random.default_rng(5)
    patch = (32, 48)
    a = rng.uniform(0, 1, (56, 100, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (56, 100, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        flowformer_tiling.tiled_flow(_image_model, a, b, patch_size=patch, min_overlap=8),
        j_tiling.tiled_flow(_image_model, a, b, patch_size=patch, min_overlap=8))
    # a torch model on any device: its flow comes back as numpy
    got = flowformer_tiling.tiled_flow(lambda x, y: torch.from_numpy(_image_model(x, y)), a, b,
                                       patch_size=patch, min_overlap=8)
    assert isinstance(got, np.ndarray)
    small_a, small_b = a[:12, :20], b[:12, :20]
    ref = j_tiling.adaptive_flow(_image_model, small_a, small_b)
    got = flowformer_tiling.adaptive_flow(_image_model, small_a, small_b)
    assert got.shape == (12, 20, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_compute_scene_flows_flowformer_tiling_matches_jax(tmp_path):
    rgb_dir = tmp_path / "rgbs"
    _write_rgbs(rgb_dir, 2, (12, 20))

    def fake(a, b):
        return _image_model(a, b), _image_model(b, a)

    n_ref = j_compute_flow.compute_scene_flows(rgb_dir, tmp_path / "jax", flow_fn=fake,
                                               tiling="flowformer")
    n = compute_flow.compute_scene_flows(rgb_dir, tmp_path / "port", flow_fn=fake,
                                         tiling="flowformer", device="cpu")
    assert n == n_ref == 2
    for name in ("00000_00001.npz", "00001_00000.npz"):
        ref, got = (np.load(tmp_path / d / "interval_1" / name) for d in ("jax", "port"))
        for key in ("flow", "coord_diff"):
            np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                       atol=1e-5 * np.abs(ref[key]).max(), err_msg=key)


# ------------------------------------------------------------------ masks


def test_opening_matches_opencv_at_the_borders():
    rng = np.random.default_rng(9)
    for density in (0.5, 0.7, 0.9):
        m = rng.random((23, 31)) < density
        m[0, :] = m[:, 0] = True  # set along two borders
        m[-1, ::2] = True
        np.testing.assert_array_equal(epipolar_mask._binary_opening_disk1(m),
                                      j_epipolar_mask._binary_opening_disk1(m))
    full = np.ones((5, 6), bool)  # outside counts as set for the erosion
    np.testing.assert_array_equal(epipolar_mask._binary_opening_disk1(full), full)


@pytest.fixture(scope="module")
def scene():
    h, w = 48, 64
    times = [0.3, 0.4, 0.5, 0.6]
    poses = [synthetic.camera_pose(i, 8) for i in (1, 2, 3, 4)]
    frames = [synthetic.render_frame(h, w, p, t) for p, t in zip(poses, times)]
    return dict(h=h, w=w, times=times, poses=poses, frames=frames,
                k=synthetic.intrinsics(h, w))


def test_epipolar_motion_mask_matches_jax(scene):
    h, w, poses, times, frames = scene["h"], scene["w"], scene["poses"], scene["times"], \
        scene["frames"]
    k = scene["k"][:3, :3]
    flow_fwd = synthetic.flow_between(h, w, frames[1], poses[1], times[1], poses[2], times[2])
    flow_bwd = synthetic.flow_between(h, w, frames[1], poses[1], times[1], poses[0], times[0])
    rng = np.random.default_rng(3)
    consist = rng.random((h, w)) > 0.05
    for kw in (dict(flow_fwd=flow_fwd, flow_bwd=flow_bwd), dict(flow_fwd=None, flow_bwd=flow_bwd),
               dict(flow_fwd=flow_fwd, flow_bwd=None)):
        args = dict(kw, consist_fwd=consist, consist_bwd=~consist | consist,
                    w2c_ref=np.linalg.inv(poses[1]), k_ref=k, w2c_prev=np.linalg.inv(poses[0]),
                    k_prev=k, w2c_post=np.linalg.inv(poses[2]), k_post=k, threshold=0.5)
        got = epipolar_mask.epipolar_motion_mask(**args)
        np.testing.assert_array_equal(got, j_epipolar_mask.epipolar_motion_mask(**args))
        assert got.any()
    t = np.linalg.inv(poses[2]) @ poses[1]
    p = rng.uniform(0, 60, (3, 40))
    p[2] = 1.0
    np.testing.assert_array_equal(epipolar_mask.epipolar_distance(t, k, k, p, p + 0.5),
                                  j_epipolar_mask.epipolar_distance(t, k, k, p, p + 0.5))


def _write_mask_scene(root, scene):
    """rgbs/, poses/<stem>.npz and flows/interval_1 (the compute_flow
    layout with exact synthetic flows and a coord_diff) of the scene."""
    h, w, n = scene["h"], scene["w"], len(scene["frames"])
    rgb_dir, pose_dir, flow_dir = root / "rgbs", root / "poses", root / "flows" / "interval_1"
    for d in (rgb_dir, pose_dir, flow_dir):
        d.mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i, fr in enumerate(scene["frames"]):
        write_png(rgb_dir / f"{i:05d}.png", (fr["rgb"] * 255).astype(np.uint8))
        np.savez(pose_dir / f"{i:05d}.npz", c2w=scene["poses"][i], K=scene["k"])
        for j in (i - 1, i + 1):
            if 0 <= j < n:
                flow = synthetic.flow_between(h, w, fr, scene["poses"][i], scene["times"][i],
                                              scene["poses"][j], scene["times"][j])
                np.savez(flow_dir / f"{i:05d}_{j:05d}.npz", flow=flow.astype(np.float32),
                         coord_diff=rng.normal(0, 0.5, (h, w, 2)).astype(np.float32))
    return rgb_dir, pose_dir, root / "flows"


def test_mask_clis_match_jax(tmp_path, scene):
    """epipolar_mask's CLI (PNG masks), then combine_masks' CLI over those
    masks saved as .npy with the interval_1 flows (arrays)."""
    rgb_dir, pose_dir, flow_dir = _write_mask_scene(tmp_path / "scene", scene)
    for pkg, mod in (("jax", j_epipolar_mask), ("port", epipolar_mask)):
        mod.main(["--rgb-dir", str(rgb_dir), "--flow-dir", str(flow_dir),
                  "--save-dir", str(tmp_path / pkg), "--pose-dir", str(pose_dir),
                  "--threshold", "0.5"])
    n_dyn = 0
    mask_dir = _mkdir(tmp_path / "scene" / "masks")
    for i in range(len(scene["frames"])):
        name = f"final/{i:05d}_final.png"
        got, ref = read_image(tmp_path / "port" / name), read_image(tmp_path / "jax" / name)
        assert got.dtype == np.uint8 and got.shape == (scene["h"], scene["w"])
        np.testing.assert_array_equal(got, ref)
        n_dyn += int((got > 0).sum())
        np.save(mask_dir / f"{i:05d}.npy", got > 0)
    assert n_dyn > 0
    for pkg, mod in (("jax", j_combine_masks), ("port", combine_masks)):
        mod.main(["--mask_dir", str(mask_dir),
                  "--flow_dir", str(flow_dir / "interval_1"),
                  "--out_dir", str(tmp_path / f"combined_{pkg}"), "--dyn_track_thres", "0.3"])
    for i in range(len(scene["frames"])):
        for suffix in ("_final.npy", "_dyn_cnt.npy"):
            np.testing.assert_array_equal(
                np.load(tmp_path / "combined_port" / f"{i:05d}{suffix}"),
                np.load(tmp_path / "combined_jax" / f"{i:05d}{suffix}"))


def _mkdir(p):
    p.mkdir(parents=True)
    return p


def test_combine_masks_sequence_matches_jax():
    rng = np.random.default_rng(6)
    h, w, n = 24, 32, 5
    raws = [rng.random((h, w)) > 0.8 for _ in range(n)]
    for r in raws:
        r[6:16, 8:20] = True
    flows = [None] + [_smooth_flow(rng, h, w, 2.0) for _ in range(n - 1)]
    consist = [None] + [rng.random((h, w)) > 0.1 for _ in range(n - 1)]
    sams = [rng.random((3, h, w)) > 0.5 for _ in range(n)]
    ref = j_combine_masks.propagate_sequence(raws, flows, consist, sams, 0.4, 0.1)
    got = combine_masks.propagate_sequence(raws, flows, consist, sams, 0.4, 0.1)
    for i, (g, r) in enumerate(zip(got, ref)):
        for key in ("warp_prev", "dyn_track", "dyn_cnt", "raw_no_warp", "raw", "raw_eroded",
                    "final_raw", "final"):
            if r[key] is None:
                assert g[key] is None
            else:
                np.testing.assert_array_equal(g[key], r[key], err_msg=f"{i}:{key}")
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    np.testing.assert_array_equal(combine_masks.warp_flow(img, flows[1]),
                                  j_combine_masks.warp_flow(img, flows[1]))


# ----------------------------------------------------------------- COLMAP


def _random_model(seed=0, n_img=5, n_pts=60):
    rng = np.random.default_rng(seed)
    cam = dict(id=1, model_id=2, model="SIMPLE_RADIAL", w=640, h=480,
               params=[520.0, 320.0, 240.0, 0.01])
    images, points = [], []
    for i in range(n_img):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        ids = rng.integers(-1, n_pts, 8)
        xys = rng.uniform(0, 480, (8, 2))
        images.append(dict(id=i + 3, q=q, t=rng.normal(size=3), cam=1,
                           name=f"frame{(7 * i) % n_img:03d}.png", xys=xys, ids=ids))
    for p in range(n_pts):
        track = rng.integers(0, 8, (3, 2))
        track[:, 0] += 3
        points.append(dict(id=p, xyz=rng.normal(size=3) * 2 + [0, 0, 5],
                           rgb=rng.integers(0, 256, 3), err=float(rng.random()), track=track))
    return cam, images, points


def _write_model_bin(d, cam, images, points):
    d.mkdir(parents=True)
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", cam["id"], cam["model_id"], cam["w"], cam["h"]))
        f.write(struct.pack("<" + "d" * len(cam["params"]), *cam["params"]))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i", im["id"]))
            f.write(struct.pack("<dddd", *im["q"]))
            f.write(struct.pack("<ddd", *im["t"]))
            f.write(struct.pack("<i", im["cam"]))
            f.write(im["name"].encode() + b"\x00")
            f.write(struct.pack("<Q", len(im["ids"])))
            for (x, y), pid in zip(im["xys"], im["ids"]):
                f.write(struct.pack("<ddq", x, y, int(pid)))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points:
            f.write(struct.pack("<Q", p["id"]))
            f.write(struct.pack("<ddd", *p["xyz"]))
            f.write(struct.pack("<BBB", *map(int, p["rgb"])))
            f.write(struct.pack("<d", p["err"]))
            f.write(struct.pack("<Q", len(p["track"])))
            for a, b in p["track"]:
                f.write(struct.pack("<ii", int(a), int(b)))


def _write_model_txt(d, cam, images, points):
    d.mkdir(parents=True)
    (d / "cameras.txt").write_text(
        "# Camera list\n" + f"{cam['id']} {cam['model']} {cam['w']} {cam['h']} "
        + " ".join(repr(v) for v in cam["params"]) + "\n")
    lines = ["# Image list", "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    for im in images:
        lines.append(" ".join(map(repr, [im["id"], *map(float, im["q"]), *map(float, im["t"]),
                                         im["cam"]])) + f" {im['name']}")
        lines.append(" ".join(f"{x!r} {y!r} {int(pid)}" for (x, y), pid
                              in zip(map(tuple, im["xys"].tolist()), im["ids"])))
    (d / "images.txt").write_text("\n".join(lines) + "\n")
    (d / "points3D.txt").write_text("".join(
        " ".join(map(repr, [p["id"], *map(float, p["xyz"]), *map(int, p["rgb"]), p["err"]]))
        + " " + " ".join(str(int(v)) for v in p["track"].reshape(-1)) + "\n" for p in points))


def test_colmap_binary_and_text_read_alike_and_convert_as_jax(tmp_path):
    model = _random_model()
    _write_model_bin(tmp_path / "bin", *model)
    _write_model_txt(tmp_path / "txt", *model)
    cams_b, imgs_b, pts_b = colmap_reader.read_model(tmp_path / "bin")
    cams_t, imgs_t, pts_t = colmap_reader.read_model(tmp_path / "txt")
    cams_j, imgs_j, pts_j = j_colmap_reader.read_model(tmp_path / "bin")
    for a, b, c in ((cams_b, cams_t, cams_j), (imgs_b, imgs_t, imgs_j), (pts_b, pts_t, pts_j)):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            for field in vars(c[k]):
                for other in (b[k], c[k]):
                    np.testing.assert_array_equal(np.asarray(getattr(a[k], field)),
                                                  np.asarray(getattr(other, field)), field)
    for k in imgs_b:
        np.testing.assert_array_equal(imgs_b[k].w2c, imgs_j[k].w2c)
    np.testing.assert_array_equal(cams_b[1].intrinsics3, cams_j[1].intrinsics3)
    for sub in ("bin", "txt"):
        pb, names = colmap_reader.colmap_to_poses_bounds(tmp_path / sub)
        pb_j, names_j = j_colmap_reader.colmap_to_poses_bounds(tmp_path / "bin")
        assert names == names_j
        np.testing.assert_array_equal(pb, pb_j)
    poses, scene_d = colmap_reader.colmap_to_poses_scene(tmp_path / "bin", tmp_path / "out",
                                                         max_images=4)
    poses_j, scene_j = j_colmap_reader.colmap_to_poses_scene(tmp_path / "bin",
                                                             tmp_path / "out_j", max_images=4)
    np.testing.assert_array_equal(poses, poses_j)
    assert scene_d == scene_j
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "poses.npy"),
                                  np.load(tmp_path / "out_j" / "poses.npy"))
    assert (tmp_path / "out" / "scene.json").read_text() == (
        tmp_path / "out_j" / "scene.json").read_text()
    with pytest.raises(FileNotFoundError):
        colmap_reader.read_model(tmp_path / "out")


def test_colmap_driver_arguments_and_refusal(tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    for pkg, mod in (("jax", j_colmap_driver), ("port", colmap_driver)):
        monkeypatch.setattr(mod, "colmap_available", lambda: True)
        monkeypatch.setattr(mod, "_run", lambda args, _c=calls[pkg]: _c.append(
            [str(a) for a in args]))
        for kw in (dict(mask_dir=tmp_path / "masks"), dict(dense_undistort=False,
                                                            camera_model="PINHOLE")):
            model = mod.run_colmap(tmp_path / "work", tmp_path / "rgbs", **kw)
            assert model == tmp_path / "work" / "sparse" / "0"
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 9
    assert calls["port"][0][:2] == ["colmap", "feature_extractor"]
    for pkg, mod in (("jax", j_colmap_driver), ("port", colmap_driver)):
        monkeypatch.setattr(mod, "colmap_available", lambda: False)
    with pytest.raises(RuntimeError) as perr:
        colmap_driver.run_colmap(tmp_path / "w2", tmp_path / "rgbs")
    with pytest.raises(RuntimeError) as jerr:
        j_colmap_driver.run_colmap(tmp_path / "w3", tmp_path / "rgbs")
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(SystemExit, match="colmap binary not found"):
        colmap_driver.main(["--rgb-dir", str(tmp_path), "--work-dir", str(tmp_path / "w4")])


# ------------------------------------------------------------------ depth


def test_depth_align_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    preds, mvss = [], []
    for s in (0.4, 0.6, 0.5):
        d = rng.uniform(2.0, 8.0, size=(12, 16))
        preds.append((1.0 / ((1.0 / d) / s + rng.normal(0, 0.01, d.shape))).astype(np.float32))
        mvss.append(d.astype(np.float32))
    assert depth_align.align_video(preds, mvss) == j_depth_align.align_video(preds, mvss)
    zoe, mvs = _mkdir(tmp_path / "zoe"), _mkdir(tmp_path / "mvs")
    for i, (p, m) in enumerate(zip(preds, mvss)):
        np.savez(zoe / f"{i:05d}.npz", depth=p)
        np.save(mvs / f"{i:05d}.npy", m)
    for pkg, mod in (("jax", j_depth_align), ("port", depth_align)):
        mod.main(["--zoe-dir", str(zoe), "--colmap-dir", str(mvs),
                  "--save-dir", str(tmp_path / pkg)])
    for i in range(3):
        got, ref = (np.load(tmp_path / pkg / f"{i:05d}.npz") for pkg in ("port", "jax"))
        assert got.files == ref.files
        for key in ref.files:
            np.testing.assert_array_equal(got[key], ref[key])


def test_depth_converters_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    rgb_dir = tmp_path / "rgbs"
    _write_rgbs(rgb_dir, 3, (6, 8))
    cs = _mkdir(tmp_path / "casual_sam" / "BA_full")
    k = np.array([[50.0, 0, 4], [0, 50.0, 3], [0, 0, 1]], np.float32)
    dv = _mkdir(tmp_path / "dvd" / "test" / "scene_flow_motion_field_x" / "epoch5_test")
    for i in range(3):
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        np.savez(cs / f"{i:04d}.npz", disp=rng.uniform(0.1, 1.0, (6, 8)).astype(np.float32),
                 R=rot, t=rng.normal(size=3).astype(np.float32), K=k)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3], c2w[:3, 3] = rot, rng.normal(size=3)
        np.savez(dv / f"batch{i:04d}.npz", depth=rng.uniform(1, 5, (1, 1, 6, 8)).astype(np.float32),
                 cam_c2w=c2w[None], K=k.T[None, None, None])
    for kind, base in (("casual_sam", tmp_path / "casual_sam"), ("dyn_video_depth",
                                                                 tmp_path / "dvd")):
        for pkg, mod in (("jax", j_depth_converters), ("port", depth_converters)):
            mod.main([kind, "--base-dir", str(base), "--rgb-dir", str(rgb_dir),
                      "--save-dir", str(tmp_path / f"{kind}_{pkg}")])
        for sub, keys in (("poses", ("c2w", "K")), ("depths", ("depth",))):
            for i in range(3):
                got, ref = (np.load(tmp_path / f"{kind}_{pkg}" / sub / f"{i:05d}.npz")
                            for pkg in ("port", "jax"))
                for key in keys:
                    np.testing.assert_array_equal(got[key], ref[key])


def test_dycheck_extract_matches_jax(tmp_path):
    root = tmp_path / "capture"
    chip_smoke.write_iphone_capture(root, hw=(24, 32), n_train=6, gap=3)
    data_dir = root / "raw"
    scene = chip_smoke.IPHONE_SCENE
    n_ref = j_dycheck_extract.extract_scene(data_dir, tmp_path / "jax", scene, factor=2)
    dycheck_extract.main(["--data_dir", str(data_dir), "--save_dir", str(tmp_path / "port"),
                          "--scene_id", scene, "--factor", "2"])
    got_dir, ref_dir = tmp_path / "port" / scene, tmp_path / "jax" / scene
    rgbs = sorted(p.name for p in (ref_dir / "rgbs").iterdir())
    assert sorted(p.name for p in (got_dir / "rgbs").iterdir()) == rgbs and len(rgbs) == n_ref
    for name in rgbs:
        got = read_image(got_dir / "rgbs" / name)
        assert got.shape == (24, 32, 3)
        np.testing.assert_array_equal(got, read_image(ref_dir / "rgbs" / name))
        stem = name[:-4]
        np.testing.assert_array_equal(np.load(got_dir / "depths" / f"{stem}.npy"),
                                      np.load(ref_dir / "depths" / f"{stem}.npy"))
    got, ref = np.load(got_dir / "camera.npz"), np.load(ref_dir / "camera.npz")
    for key in ("all_K", "all_w2c"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-6)
