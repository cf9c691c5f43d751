"""The port's NVIDIA evaluation reader and what it calls, against the JAX
package's.

The scene is the JAX package's own fixture (``build_fake_scene`` of
tests/test_datasets.py, 6 frames at 48x64), in four variants: its JPEG
frames read as they are (the port's JPEG decoder against PIL's); and,
re-saved as PNG with PIL, at the eval size; with every raw image, mask and
disparity at 2x (the target takes the LANCZOS resize, the sources
INTER_AREA's fast path, depth and masks the nearest ones); and at 1.5x
(INTER_AREA's general path). Every contract key
of every item is held against the JAX reader at 1e-5 (rtol and atol),
``depth_range`` included, over the options: the four spatial-ranking
metrics, the track sources, ZoeDepth fixed and "moe" (the zoe files are
written here). Then ``ZipReader``, the crop helpers, the LLFF loader, the
pose math, ``CombinedDataset`` and ``PrefetchLoader`` (the cases of
tests/test_loader.py) against the JAX package, and the loader's CPU staging.
"""

import pickle
import threading
import time
import zipfile

import cv2
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from pgdvs_tpu.core import geometry as jgeo
from pgdvs_tpu.data import base as jbase
from pgdvs_tpu.data import llff as jllff
from pgdvs_tpu.data.nvidia_eval import NvidiaEvalDataset as JNvidiaEvalDataset
from pgdvs_tpu_torch.core import geometry as tgeo
from pgdvs_tpu_torch.data import base as tbase
from pgdvs_tpu_torch.data import llff as tllff
from pgdvs_tpu_torch.data.combined import CombinedDataset
from pgdvs_tpu_torch.data.contract import RENDER_CONTRACT_KEYS
from pgdvs_tpu_torch.data.image_io import encode_png
from pgdvs_tpu_torch.data.loader import (
    PrefetchLoader,
    contract_to_device,
    to_device_prefetch,
)
from pgdvs_tpu_torch.data.nvidia_eval import ZOE_PRINCIPLES, NvidiaEvalDataset
from test_datasets import H, W, build_fake_scene

TOL = dict(rtol=1e-5, atol=1e-5)
SCENE = "Balloon1"
DIRS = dict(raw_data_dir="raw", depth_data_dir="depths", mask_data_dir="flowmask",
            flow_data_dir="flowmask", tgt_height=H)


def _upscale_raw(root, factor):
    """Every raw image, eval mask, dynamic mask and disparity of the scene
    at ``factor`` times the eval size (bilinear; the 1-bit masks nearest)."""
    hh, ww = int(round(H * factor)), int(round(W * factor))
    dense = root / "raw" / SCENE / "dense"
    pngs = [*(dense / "mv_images").rglob("*.png"), *(dense / "mv_masks").rglob("*.png"),
            *(root / "flowmask" / SCENE / "dense/masks/final").glob("*.png")]
    for f in pngs:
        with PIL.Image.open(f) as im:
            im.load()
        im.resize((ww, hh), PIL.Image.Resampling.BILINEAR).save(f)
    for f in (root / "depths" / SCENE / "disp").glob("*.npy"):
        np.save(f, cv2.resize(np.load(f), (ww, hh), interpolation=cv2.INTER_LINEAR))


def _write_zoe(root):
    """ZoeDepth predictions with scale / shift and |mean error| diagnostics
    per variant (n, k, nk) and principle, from a seed."""
    rng = np.random.default_rng(5)
    for zt in ("n", "k", "nk"):
        d = root / "zoe" / SCENE / f"dense/zoe_depths_{zt}"
        d.mkdir(parents=True)
        for i in range(6):
            disp = np.load(root / "depths" / SCENE / "disp" / f"{i:05d}.npy")
            keys = {"depth_pred": (1.0 / disp * rng.uniform(0.9, 1.1, disp.shape))
                    .astype(np.float32)}
            for zp, (scale_k, shift_k) in ZOE_PRINCIPLES.items():
                keys[zp] = np.float32(rng.uniform(-0.2, 0.2))
                keys[scale_k] = np.float32(rng.uniform(0.8, 1.2))
                keys[shift_k] = np.float32(rng.uniform(-0.01, 0.01))
            np.savez(d / f"{i:05d}.npz", **keys)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """variant -> scene root, each built once: "jpeg" (the JPEG frames as
    written), "eval", "raw2x", "raw1.5x" (re-saved as PNG)."""
    built = {}

    def get(variant):
        if variant not in built:
            root = build_fake_scene(tmp_path_factory.mktemp(f"nvidia_{variant}"))
            for f in (root / "raw" / SCENE / "dense/mv_images").rglob("*.jpg"):
                if variant == "jpeg":
                    continue
                with PIL.Image.open(f) as im:
                    im.save(f.with_suffix(".png"))
                f.unlink()
            if variant not in ("eval", "jpeg"):
                _upscale_raw(root, {"raw2x": 2.0, "raw1.5x": 1.5}[variant])
            _write_zoe(root)
            built[variant] = root
        return built[variant]

    return get


VARIANTS = ["jpeg", "eval", "raw2x", "raw1.5x"]


def _assert_items_equal(got, ref, where):
    assert sorted(got) == sorted(ref), where
    for key, r in ref.items():
        g = got[key]
        if key == "misc":
            assert sorted(g) == sorted(r), where
            for mk, mv in r.items():
                if isinstance(mv, np.ndarray):
                    np.testing.assert_allclose(g[mk], mv, **TOL, err_msg=f"{where} misc {mk}")
                else:
                    assert g[mk] == mv, (where, mk)
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, (where, key, g.dtype, g.shape, r.shape)
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"{where} {key}")


OPTIONS = {
    "dist": {},
    "vector": {"spatial_dist_method": "vector"},
    "matrix": {"spatial_dist_method": "matrix"},
    "dist_matrix": {"spatial_dist_method": "dist_matrix"},
    "track": {"with_track_sources": True},
    "zoe_fixed": {"use_zoe_depth": "nk_me_trim_indiv", "zoe_depth_data_path": "zoe"},
    "zoe_moe": {"use_zoe_depth": "moe", "zoe_depth_data_path": "zoe"},
}


@pytest.mark.parametrize("variant,option", [
    *(("eval", option) for option in OPTIONS),
    ("raw2x", "dist"), ("raw2x", "track"), ("raw1.5x", "dist"), ("raw1.5x", "zoe_moe"),
    ("jpeg", "dist"), ("jpeg", "track")])
def test_reader_matches_jax(scenes, variant, option):
    """Every item (6 in the mono video, 6 held out), every contract key,
    against the JAX reader at 1e-5: every option at the eval size, a few at
    the raw sizes (the resizes are what differs there) and on the JPEG
    frames."""
    kw = dict(data_root=str(scenes(variant)), n_src_views_spatial=3, **DIRS, **OPTIONS[option])
    ours, ref = NvidiaEvalDataset(**kw), JNvidiaEvalDataset(**kw)
    assert ours.items == ref.items and len(ours) == 12
    held_out = 0
    for i in range(len(ref)):
        got = ours[i]
        _assert_items_equal(got, ref[i], f"{variant} {option} item {i}")
        held_out += got["misc"]["tgt_frame_id"] != got["misc"]["tgt_cam_id"]
    assert held_out == 6


@pytest.mark.parametrize("variant", VARIANTS)
def test_reader_emits_contract_shapes(scenes, variant):
    """One in-mono item with both temporal neighbours: every contract key
    of the non-geo branch at the shape data/contract.py gives (S = 3,
    T = 2, K = 5; seq_ids 1 + S + T), the depth range bracketing the
    scene's depths (3 to 6)."""
    ds = NvidiaEvalDataset(data_root=str(scenes(variant)), n_src_views_spatial=3,
                           with_track_sources=True, **DIRS)
    item = ds[2]  # frame 1 seen by camera 1, its mono camera
    assert item["misc"]["tgt_frame_id"] == 1 and item["misc"]["tgt_cam_id"] == 1
    assert item["misc"]["n_actual_temporal"] == 2
    dims = {"H": H, "W": W, "S": 3, "T": 2, "K": 5}
    for key, shape in RENDER_CONTRACT_KEYS.items():
        if key.startswith("st_pcl"):
            continue
        want = (6,) if key == "seq_ids" else tuple(dims.get(d, d) for d in shape)
        assert item[key].shape == want, (variant, key, item[key].shape, want)
    lo, hi = item["depth_range"]
    assert 0 < lo < 3.0 and hi > 6.0 * 0.9


def test_jpeg_frames_raise_naming_the_file(tmp_path):
    """The JPEG frames decode (the "jpeg" variant above); a progressive
    one, which the decoder does not take, raises, naming the file."""
    root = build_fake_scene(tmp_path)
    f = root / "raw" / SCENE / "dense/mv_images/00000/cam01.jpg"
    with PIL.Image.open(f) as im:
        im.load()
    im.save(f, progressive=True)
    ds = NvidiaEvalDataset(data_root=str(root), n_src_views_spatial=3, **DIRS)
    with pytest.raises(NotImplementedError, match=r"cam01\.jpg: progressive JPEG"):
        ds[0]


def test_zip_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (8, 10, 3)).astype(np.uint8)
    arr = rng.normal(size=(4, 5)).astype(np.float32)
    zpath = tmp_path / "data.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        import io

        buf = io.BytesIO()
        PIL.Image.fromarray(img).save(buf, format="PNG")
        zf.writestr("scene/img.png", buf.getvalue())
        zf.writestr("scene/ours.png", encode_png(img, "cycle"))
        buf = io.BytesIO()
        PIL.Image.fromarray(img).save(buf, format="JPEG", quality=90)
        zf.writestr("scene/img.jpg", buf.getvalue())
        zf.writestr("scene/cut.jpg", buf.getvalue()[:200])
        buf = io.BytesIO()
        np.savez(buf, flow=arr)
        zf.writestr("scene/f.npz", buf.getvalue())
        buf = io.BytesIO()
        np.save(buf, arr)
        zf.writestr("scene/a.npy", buf.getvalue())
    ours, ref = tbase.ZipReader(zpath), jbase.ZipReader(zpath)
    assert ours.namelist() == ref.namelist()
    for name in ("scene/img.png", "scene/ours.png", "scene/img.jpg"):
        np.testing.assert_array_equal(ours.read_image(name), ref.read_image(name))
    np.testing.assert_array_equal(ours.read_npz("scene/f.npz")["flow"],
                                  ref.read_npz("scene/f.npz")["flow"])
    np.testing.assert_array_equal(ours.read_npy("scene/a.npy"), ref.read_npy("scene/a.npy"))
    assert ours.exists("scene/img.png") and not ours.exists("nope")
    with pytest.raises(ValueError, match=r"data\.zip:scene/cut\.jpg: truncated"):
        ours.read_image("scene/cut.jpg")
    state = pickle.dumps(ours)  # the open handle is dropped
    assert ours._zf is not None and b"ZipFile" not in state
    ours2 = pickle.loads(state)
    assert ours2._zf is None
    np.testing.assert_array_equal(ours2.read_npy("scene/a.npy"), arr)
    ours.close()
    ours2.close()
    ref.close()


@pytest.mark.parametrize("crop", [(64, 64), (96, 100), (50, 200)])
def test_crop_helpers_match_jax(crop):
    raw_h, raw_w = 96, 128
    k = np.array([[100.0 / raw_w, 0, 64.0 / raw_w], [0, 100.0 / raw_h, 48.0 / raw_h],
                  [0, 0, 1]])
    img = np.arange(raw_h * raw_w * 3).reshape(raw_h, raw_w, 3)
    got, info = tbase.center_crop(img, *crop)
    want, info_j = jbase.center_crop(img, *crop)
    np.testing.assert_array_equal(got, want)
    assert info == info_j
    args = (k, (raw_h, raw_w), (info["h_start"], info["w_start"]),
            (info["crop_h"], info["crop_w"]))
    np.testing.assert_array_equal(tbase.modify_K_wrt_crop(*args), jbase.modify_K_wrt_crop(*args))


def test_llff_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "poses_bounds_cvd.npy"
    np.save(path, rng.normal(size=(7, 17)))
    for got, want in zip(tllff.load_poses_bounds(path), jllff.load_poses_bounds(path)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for shape in (None, (48, 64), (288, 550)):
        np.testing.assert_array_equal(tllff.hwf_to_intrinsics4([576, 1100, 880.0], shape),
                                      jllff.hwf_to_intrinsics4([576, 1100, 880.0], shape))


def _rotations(n, seed=11):
    from scipy.spatial.transform import Rotation

    return Rotation.random(n, random_state=seed).as_matrix()


def test_pose_math_matches_jax():
    rots = _rotations(6)
    rng = np.random.default_rng(1)
    for r in rots:
        q = tgeo.rotmat_to_qvec(r)
        np.testing.assert_array_equal(q, jgeo.rotmat_to_qvec(r))
        np.testing.assert_array_equal(tgeo.qvec_to_rotmat(q), jgeo.qvec_to_rotmat(q))
    q0, q1 = jgeo.rotmat_to_qvec(rots[0]), jgeo.rotmat_to_qvec(rots[1])
    for t in (0.0, 0.3, 1.0):
        for shortest in (True, False):
            np.testing.assert_array_equal(tgeo.quat_slerp(q0, -q1, t, shortest),
                                          jgeo.quat_slerp(q0, -q1, t, shortest))
        np.testing.assert_array_equal(tgeo.quat_slerp(q0, q0, t), jgeo.quat_slerp(q0, q0, t))
    c2ws = np.tile(np.eye(4), (6, 1, 1))
    c2ws[:, :3, :3] = rots
    c2ws[:, :3, 3] = rng.normal(size=(6, 3))
    for t in (0.25, 0.8):
        for a, b in zip(tgeo.linear_pose_interp(c2ws[0, :3, 3], rots[0], c2ws[1, :3, 3],
                                                rots[1], t),
                        jgeo.linear_pose_interp(c2ws[0, :3, 3], rots[0], c2ws[1, :3, 3],
                                                rots[1], t)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tgeo.interpolate_c2w(c2ws[2], c2ws[3], t),
                                      jgeo.interpolate_c2w(c2ws[2], c2ws[3], t))
    np.testing.assert_array_equal(tgeo.average_pose(c2ws), jgeo.average_pose(c2ws))
    np.testing.assert_array_equal(tgeo.recenter_poses(c2ws), jgeo.recenter_poses(c2ws))
    np.testing.assert_array_equal(tgeo.rotation_geodesic_dist(rots[0], rots),
                                  jgeo.rotation_geodesic_dist(rots[0], rots))


@pytest.mark.parametrize("metric", ["dist", "vector", "matrix", "geodesic", "dist_matrix"])
@pytest.mark.parametrize("tgt_id", [-1, 2])
def test_sort_poses_matches_jax(metric, tgt_id):
    c2ws = np.tile(np.eye(4), (9, 1, 1))
    c2ws[:, :3, :3] = _rotations(9, seed=4)
    c2ws[:, :3, 3] = np.random.default_rng(2).normal(size=(9, 3))
    args = (c2ws[4], c2ws, metric, (0.1, -0.2, 3.0), tgt_id)
    got = tgeo.sort_poses_wrt_ref(*args)
    np.testing.assert_array_equal(got, jgeo.sort_poses_wrt_ref(*args))
    if tgt_id >= 0:
        assert got[-1] == tgt_id
    with pytest.raises(ValueError, match="metric"):
        tgeo.sort_poses_wrt_ref(c2ws[0], c2ws, "nope")


def test_unproject_depth_matches_jax():
    """float32 through the port's get_rays on CPU tensors, against JAX's at
    HIGHEST precision."""
    rng = np.random.default_rng(8)
    depth = rng.uniform(1.0, 9.0, (30, 41)).astype(np.float32)
    k = tllff.hwf_to_intrinsics4([30, 41, 35.0]).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = _rotations(1, seed=9)[0]
    c2w[:3, 3] = [0.3, -0.2, 0.5]
    got = tgeo.unproject_depth(depth, k, c2w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (30, 41, 3)
    want = np.asarray(jgeo.unproject_depth(jnp.asarray(depth), k, c2w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_combined_dataset(scenes):
    kw = dict(data_root=str(scenes("eval")), n_src_views_spatial=3, **DIRS)
    combined = CombinedDataset([("nvidia_eval", kw), ("nvidia_eval", kw)])
    single = NvidiaEvalDataset(**kw)
    assert len(combined) == 2 * len(single)
    np.testing.assert_array_equal(combined[len(single) + 3]["rgb_tgt"], single[3]["rgb_tgt"])
    with pytest.raises(IndexError):
        combined[-1]
    geo = CombinedDataset([("nvidia_eval_pure_geo", kw)])
    assert type(geo.datasets[0]).__name__ == "NvidiaPureGeoEvalDataset"
    # the readers of the vis and DyCheck slice (tests/test_torch_port_vis.py,
    # tests/test_torch_port_dycheck.py hold them against JAX's)
    vis = CombinedDataset([("nvidia_vis", {**kw, "n_render_frames": 3,
                                          "vis_center_time": 2, "vis_time_interval": 1})])
    assert type(vis.datasets[0]).__name__ == "NvidiaVisDataset" and len(vis) == 3
    for name, cls in (("mono_vis", "MonoVisDataset"),
                      ("dycheck_iphone_eval", "DyCheckIPhoneEvalDataset")):
        ds = CombinedDataset([(name, {"data_root": str(scenes("eval")), "scene_ids": []})])
        assert type(ds.datasets[0]).__name__ == cls and len(ds) == 0
    with pytest.raises(KeyError, match="unknown dataset"):
        CombinedDataset([("nope", {})])


# ------------------------------------------------ loader (tests/test_loader.py)


class _SlowDataset:
    def __init__(self, n=10, delay=0.02):
        self.n = n
        self.delay = delay
        self.calls = []
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        with self.lock:
            self.calls.append(i)
        return {"idx": i, "arr": np.full((4,), i, np.float32), "misc": {"name": f"item{i}"}}


def test_loader_order_preserved_with_workers():
    ds = _SlowDataset(12)
    out = [item["idx"] for item in PrefetchLoader(ds, n_workers=3)]
    assert out == list(range(12))
    assert sorted(ds.calls) == list(range(12))


def test_loader_indices_striding():
    ds = _SlowDataset(10)
    assert [it["idx"] for it in PrefetchLoader(ds, indices=range(1, 10, 3))] == [1, 4, 7]
    assert len(PrefetchLoader(ds, indices=range(1, 10, 3))) == 3


def test_loader_lookahead_bounds_materialization():
    ds = _SlowDataset(20, delay=0.0)
    it = iter(PrefetchLoader(ds, n_workers=2, lookahead=3))
    next(it)
    time.sleep(0.1)
    assert len(ds.calls) <= 1 + 3 + 2  # + in-flight worker slack


def test_loader_prefetch_overlaps_work():
    ds = _SlowDataset(8, delay=0.03)
    t0 = time.time()
    for _ in PrefetchLoader(ds, n_workers=2, lookahead=4):
        time.sleep(0.03)
    overlapped = time.time() - t0
    t0 = time.time()
    for _ in PrefetchLoader(ds, n_workers=0):
        time.sleep(0.03)
    serial = time.time() - t0
    assert overlapped < serial * 0.85, (overlapped, serial)


def test_loader_iterable_pipeline_and_error_propagation():
    def gen():
        yield {"idx": 0}
        yield {"idx": 1}
        raise RuntimeError("boom")

    it = iter(PrefetchLoader(gen(), n_workers=2))
    assert next(it)["idx"] == 0
    assert next(it)["idx"] == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_to_device_prefetch_on_cpu():
    """On the CPU: a plain iterator of items with tensors in place of the
    arrays (same values and dtype, order kept), misc passed through."""
    ds = _SlowDataset(5, delay=0.0)
    out = list(to_device_prefetch(PrefetchLoader(ds, n_workers=2), device="cpu"))
    assert [int(o["idx"]) for o in out] == list(range(5))
    assert out[3]["arr"].dtype == torch.float32
    assert torch.equal(out[3]["arr"], torch.full((4,), 3.0))
    assert out[3]["misc"] == {"name": "item3"}
    item = contract_to_device({"a": np.arange(3, dtype=np.int64), "s": "x", "misc": {"k": 1}},
                              "cpu")
    assert item["a"].dtype == torch.int64 and item["s"] == "x" and item["misc"] == {"k": 1}


def test_to_device_prefetch_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        list(to_device_prefetch([{"a": np.zeros(2)}]))
    with pytest.raises(RuntimeError, match="cuda"):
        contract_to_device({"a": np.zeros(2)})
