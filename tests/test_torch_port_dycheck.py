"""The port's DyCheck iPhone entry point against the JAX package's.

``data.kmeans.KMeans`` against ``sklearn.cluster.KMeans(random_state=0,
n_init="auto")`` (the call the JAX reader makes): labels equal and centres
at 1e-5 over seeds and sizes, float32 camera paths as the reader gives it,
train sets larger than the cluster count and one smaller. Then
``DyCheckIPhoneEvalDataset`` against JAX's on every contract key at 1e-5,
under the three ``spatial_src_view_type``s, with and without track sources,
on a capture in the layout of tests/test_dycheck_ab.py (random content,
rotated cameras, masks and covisible masks), the fixture copied here. Then
``benchmark --dataset-family dycheck_iphone`` through the port's CLI and
the JAX CLI on ``chip_smoke.write_iphone_capture`` at 24x32 (two val items,
one JAX render of 8 samples on the exact preset, one reference checkpoint):
the pickles' keys, ``summary.json``'s mPSNR / mSSIM within CLI_TOL of JAX's.
"""

import json
import pickle
import warnings

import numpy as np
import PIL.Image
import pytest

import chip_smoke
from pgdvs_tpu.data.dycheck_iphone import DyCheckIPhoneEvalDataset as JDataset
from pgdvs_tpu_torch import run as trun
from pgdvs_tpu_torch.data.dycheck_iphone import DyCheckIPhoneEvalDataset
from pgdvs_tpu_torch.data.kmeans import KMeans
from test_torch_port_lk import one_thread
from test_torch_port_reader import _assert_items_equal


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's renders here are many small ops: on one thread they do not
    wait on a pool that parallel test workers oversubscribe."""
    with one_thread():
        yield


# ------------------------------------------------------------------ KMeans


def _camera_path(rng, n, dtype):
    """A handheld capture's camera centres: a noisy arc."""
    t = np.linspace(0, 1, n)
    path = np.stack([np.sin(3 * t), 0.2 * t, np.cos(2 * t)], 1)
    return (path + rng.normal(scale=0.02, size=(n, 3))).astype(dtype)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n,k", [(24, 10), (40, 10), (64, 10), (300, 10), (6, 10), (17, 3)])
def test_kmeans_matches_sklearn(seed, n, k):
    from sklearn.cluster import KMeans as SKMeans

    rng = np.random.default_rng(seed)
    x = _camera_path(rng, n, np.float32) if seed % 2 == 0 else rng.normal(size=(n, 3))
    kk = min(k, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = SKMeans(n_clusters=kk, random_state=0, n_init="auto").fit(x)
    got = KMeans(kk, random_state=0).fit(x)
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, rtol=1e-5, atol=1e-5)
    assert got.cluster_centers_.dtype == ref.cluster_centers_.dtype


def test_kmeans_relocates_empty_clusters_as_sklearn():
    """Duplicated points leave clusters empty; sklearn relocates them to the
    samples farthest from their centres."""
    from sklearn.cluster import KMeans as SKMeans

    x = np.repeat(np.random.default_rng(3).integers(0, 3, (12, 3)).astype(np.float32), 3, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = SKMeans(n_clusters=9, random_state=0, n_init="auto").fit(x)
    got = KMeans(9, random_state=0).fit(x)
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    np.testing.assert_allclose(got.cluster_centers_, ref.cluster_centers_, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="n_clusters"):
        KMeans(5).fit(x[:3])


# ------------------------------------------------- the reader (test_dycheck_ab)

H, W = 30, 24  # factor-2 (processed) resolution
FACTOR = 2
N_TRAIN = 8
N_SPATIAL = 3
N_TRACK = 2
SCENE = "paper-windmill"


def _write_camera(path, rng, i):
    """Full-resolution camera json (the parser rescales by 1/factor)."""
    ang = 0.05 * i + 0.01 * rng.uniform()
    ca, sa = np.cos(ang), np.sin(ang)
    orientation = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float64)
    position = [0.1 * i + 0.02 * rng.uniform(), -0.05 * i, -1.0 + 0.03 * i]
    cam = {
        "orientation": orientation.tolist(),
        "position": position,
        "focal_length": 2 * 28.0 + i,
        "principal_point": [W * FACTOR / 2 + 0.3, H * FACTOR / 2 - 0.2],
        "image_size": [W * FACTOR, H * FACTOR],
        "skew": 0.0,
        "pixel_aspect_ratio": 1.0,
        "radial_distortion": [0.0, 0.0, 0.0],
        "tangential_distortion": [0.0, 0.0],
    }
    with open(path, "w") as f:
        json.dump(cam, f)


@pytest.fixture(scope="module")
def iphone_root(tmp_path_factory):
    """Train: camera 0 at times 0..8 but 4; val: camera 1 at times 1 (a
    train time), 4 (between two) and 9 (past the end); flows between the
    train frames either side of 4 (interval_1) and 0 and 2 (interval_2)."""
    rng = np.random.default_rng(31)
    root = tmp_path_factory.mktemp("dycheck")
    scene = root / "raw" / SCENE
    for sub in ("splits", "camera", f"rgb/{FACTOR}x", f"depth/{FACTOR}x",
                f"covisible/{FACTOR}x/val"):
        (scene / sub).mkdir(parents=True)
    mask_dir = root / "masks" / SCENE / "masks" / "final"
    mask_dir.mkdir(parents=True)
    train = [(t, 0) for t in (0, 1, 2, 3, 5, 6, 7, 8)]
    val = [(1, 1), (4, 1), (9, 1)]
    frames = train + val
    names = [f"{c}_{t:05d}" for t, c in frames]
    with open(scene / "scene.json", "w") as f:
        json.dump({"center": [0.05, -0.02, 0.4], "scale": 0.5, "near": 0.01, "far": 8.0}, f)
    with open(scene / "dataset.json", "w") as f:
        json.dump({"count": len(frames), "ids": names}, f)
    with open(scene / "metadata.json", "w") as f:
        json.dump({n: {"warp_id": t, "camera_id": c, "appearance_id": t}
                   for n, (t, c) in zip(names, frames)}, f)
    with open(scene / "extra.json", "w") as f:
        json.dump({"factor": FACTOR, "fps": 30, "bbox": [[-1, -1, -1], [1, 1, 1]],
                   "lookat": [0, 0, 0], "up": [0, 1, 0]}, f)
    with open(scene / "splits" / "train.json", "w") as f:
        json.dump({"frame_names": [names[i] for i in range(N_TRAIN)],
                   "time_ids": [t for t, _ in train], "camera_ids": [c for _, c in train]}, f)
    with open(scene / "splits" / "val.json", "w") as f:
        json.dump({"frame_names": [names[N_TRAIN + i] for i in range(len(val))],
                   "time_ids": [t for t, _ in val], "camera_ids": [c for _, c in val]}, f)
    for n, (t, c) in zip(names, frames):
        _write_camera(scene / "camera" / f"{n}.json", rng, t + 10 * c)
        rgb = rng.integers(0, 255, (H, W, 3), np.uint8)
        alpha = np.full((H, W, 1), 255, np.uint8)
        PIL.Image.fromarray(np.concatenate([rgb, alpha], -1)).save(
            scene / f"rgb/{FACTOR}x" / f"{n}.png")
        depth = rng.uniform(1.0, 6.0, (H, W, 1)).astype(np.float32)
        np.save(scene / f"depth/{FACTOR}x" / f"{n}.npy", depth)
        if c == 0:
            m = rng.uniform(size=(H, W)) > 0.7
            if t == 5:  # one mask at another size: PIL's NEAREST resize
                m = rng.uniform(size=(2 * H, 2 * W)) > 0.7
            if t != 6:  # one missing: all dynamic
                PIL.Image.fromarray(m).save(mask_dir / f"{n}_final.png")
        else:
            m = (rng.uniform(size=(H, W)) > 0.3).astype(np.uint8) * 255
            PIL.Image.fromarray(m).save(scene / f"covisible/{FACTOR}x/val" / f"{n}.png")
    for interval, (a, b) in ((1, (3, 5)), (2, (0, 2))):
        d = root / "masks" / SCENE / "flows" / f"interval_{interval}"
        d.mkdir(parents=True, exist_ok=True)
        for i, j in ((a, b), (b, a)):
            np.savez(d / f"0_{i:05d}_0_{j:05d}.npz",
                     flow=rng.uniform(-2, 2, (H, W, 2)).astype(np.float32),
                     coord_diff=rng.uniform(-0.8, 0.8, (H, W, 2)).astype(np.float32))
    return root


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("view_type,n_clusters", [("clustered", None), ("clustered", 6),
                                                  ("closest_wo_temporal", None),
                                                  ("closest_with_temporal", None)])
def test_reader_matches_jax(iphone_root, view_type, n_clusters, track):
    """Every val item (a train time, one between two, one past the end),
    every contract key, the per-pixel depth range included, against the
    JAX reader at 1e-5."""
    kw = dict(data_root=str(iphone_root / "raw"), scene_ids=[SCENE],
              n_src_views_spatial=N_SPATIAL, mask_data_dir=str(iphone_root / "masks"),
              flow_data_dir=str(iphone_root / "masks"), spatial_src_view_type=view_type,
              n_src_views_spatial_cluster=n_clusters,
              n_src_views_temporal_track_one_side=N_TRACK, with_track_sources=track)
    ours, ref = DyCheckIPhoneEvalDataset(**kw), JDataset(**kw)
    assert ours.items == ref.items and len(ours) == 3
    pinned = 0
    for i in range(len(ref)):
        got = ours[i]
        _assert_items_equal(got, ref[i], f"{view_type} {n_clusters} track={track} item {i}")
        dr = got["depth_range"]
        assert dr.shape == (H, W, 2) and got["misc"]["quant_type"] == "dycheck"
        pinned += int(np.isclose(dr[..., 1] - dr[..., 0], 2e-4, atol=1e-6).sum())
    assert pinned > 0
    assert [ours[i]["misc"]["n_actual_temporal"] for i in range(3)] == [1, 2, 1]


def test_reader_refuses_an_unknown_view_type(iphone_root):
    with pytest.raises(ValueError, match="spatial_src_view_type"):
        DyCheckIPhoneEvalDataset(iphone_root / "raw", [SCENE], spatial_src_view_type="nearest")


# ---------------------------------------------------------------------- CLI

CAPTURE_HW = (24, 32)
# summary means, port against JAX on the exact preset (float32 networks);
# the CLI tests' bound (test_torch_port_cli.CLI_TOL) where a GNT renders
CLI_TOL = dict(rtol=0.0, atol=5e-3)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("iphone_capture")
    chip_smoke.write_iphone_capture(root, hw=CAPTURE_HW, n_train=12, gap=5)
    return root


def test_benchmark_dycheck_family_matches_the_jax_cli(capture, tmp_path, monkeypatch):
    """The refusal of ``--dataset-family dycheck_iphone`` before the DyCheck
    slice, now a run of both val items: the pickles carry mPSNR / mSSIM (no
    LPIPS weights here), the summary means against the JAX CLI's. The JAX
    benchmark subcommand takes no --dataset-arg: the bundle's dataset
    arguments carry the capture's there. The port renders item i with the
    softsplat noise JAX's evaluator draws for it (``PRNGKey(i)``), so the
    means differ by the networks' arithmetic alone."""
    import jax
    import torch

    import pgdvs_tpu.configs.benchmarks as jbench
    from pgdvs_tpu_torch.engines import evaluator as tev
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models
    from test_torch_port_cli import _jax_cli

    real = tev.render_novel_view

    def render(models, data, cfg, generator=None, **kw):
        shape = tuple(data["rgb_src_temporal"].shape[1:])
        key = jax.random.PRNGKey(generator.initial_seed())
        return real(models, data, cfg, noise=torch.from_numpy(
            np.array(jax.random.normal(key, shape))), **kw)

    monkeypatch.setattr(tev, "render_novel_view", render)

    ckpt = tmp_path / "gnt" / "model_720000.pth"
    chip_smoke.save_reference_checkpoint(init_gnt_models(seed=0, device="cpu"), ckpt)
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(tmp_path / "none"))
    dargs = {"mask_data_dir": str(capture / "masks"), "flow_data_dir": str(capture / "flows"),
             "n_src_views_spatial": 3}
    argv = ["benchmark", "--benchmark-type", "default", "--dataset-family", "dycheck_iphone",
            "--perf-preset", "exact", "--data-root", str(capture / "raw"), "--scene-ids",
            chip_smoke.IPHONE_SCENE, "--gnt-ckpt", str(ckpt)]
    knobs = ["n_coarse_samples_per_ray=8", "ray_tile=256"]
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    res_t = trun.main([*argv, "--device", "cpu", "--dataset-arg",
                       *(f"{k}={v}" for k, v in dargs.items()), "--out-dir", str(out_t),
                       "--render-cfg", *knobs])
    spec = jbench.BENCHMARK_TYPES["default"]
    monkeypatch.setitem(jbench.BENCHMARK_TYPES, "default", {**spec, "dataset_args": dargs})
    _jax_cli().main([*argv, "--devices", "1", "--gnt-dtype", "float32", "--out-dir", str(out_j),
                     "--render-cfg", *knobs, "use_pallas_gnt=false", "knn_tile=256"])
    res_j = json.loads((out_j / "summary.json").read_text())
    assert res_t["count"] == res_j["count"] == 2
    assert sorted(res_t["mean"]) == sorted(res_j["mean"]) == ["mpsnr", "mssim", "render_wall_s"]
    assert json.loads((out_t / "summary.json").read_text()) == json.loads(json.dumps(res_t))
    for key in ("mpsnr", "mssim"):
        np.testing.assert_allclose(res_t["mean"][key], res_j["mean"][key], **CLI_TOL,
                                   err_msg=key)
    for i in range(2):
        rec = pickle.loads((out_t / f"{i:06d}.pkl").read_bytes())
        assert sorted(rec) == ["mpsnr", "mssim", "render_wall_s", "scene_id"]
        assert (out_t / f"{i:06d}_combined.png").is_file()
