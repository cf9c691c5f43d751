"""The port's visualization entry points against the JAX package's.

``create_bt_poses`` over frame counts, amplitudes and scene scales at 1e-12;
``utils.vis`` (the flow wheel and ``colorize_depth`` bit for bit, with
matplotlib's ``turbo`` on the JAX side; the PLY writer byte for byte); the
NVIDIA vis reader on ``chip_smoke.write_reader_scene`` at 24x32 (8 frames,
flows between all of them) and the monocular reader on a DAVIS-layout scene
written here (its masks at twice the frame size, so PIL's NEAREST resize
runs): trajectory times equal and poses at 1e-6, every contract key of
every item at 1e-5, with and without track sources; the debug dumps' files
against JAX's (PNG pixels equal, the point cloud at 1e-5); then the CLI:
``benchmark --benchmark-type visualize_nvidia_max_disp_32`` and ``vis
--dataset mono_vis`` against the JAX CLI on the exact preset with one
reference checkpoint (two JAX renders of two frames each at 24x32 and 8
samples; the PNGs within one uint8 level, see VIS_TOL), ``vis --dataset
nvidia_vis`` equal bit for bit to the bundle's frames, ``eval --dataset
nvidia_vis`` running as JAX's does (no ground truth: render_wall_s only),
``vis --help``; and the port's imports in a fresh interpreter.
"""

import json
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest
import torch

import chip_smoke
from pgdvs_tpu.data import mono_vis as jmono
from pgdvs_tpu.data import nvidia_vis as jvis
from pgdvs_tpu.utils import vis as jutil
from pgdvs_tpu_torch import run as trun
from pgdvs_tpu_torch.data import mono_vis as tmono
from pgdvs_tpu_torch.data import nvidia_vis as tvis
from pgdvs_tpu_torch.data.image_io import read_image, write_png
from pgdvs_tpu_torch.utils import vis as tutil
from test_torch_port_lk import one_thread
from test_torch_port_reader import _assert_items_equal

H, W = 24, 32
N_FRAMES = 8
SCENE = chip_smoke.READER_SCENE
MONO_SCENE = "lady-running"
POSE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's renders here are many small ops: on one thread they do not
    wait on a pool that parallel test workers oversubscribe."""
    with one_thread():
        yield


# ------------------------------------------------------------ bullet time


@pytest.mark.parametrize("num_frames", [1, 7, 25])
@pytest.mark.parametrize("max_disp,sc", [(32.0, None), (64.0, None), (32.0, 0.37),
                                         (64.0, 2.5)])
def test_create_bt_poses_matches_jax(num_frames, max_disp, sc):
    got = tvis.create_bt_poses(480.0, num_frames=num_frames, max_disp=max_disp, sc=sc)
    ref = jvis.create_bt_poses(480.0, num_frames=num_frames, max_disp=max_disp, sc=sc)
    assert len(got) == len(ref) == num_frames
    np.testing.assert_allclose(np.stack(got), np.stack(ref), rtol=1e-12, atol=1e-12)
    assert tvis.N_BT_REPS == jvis.N_BT_REPS


# ---------------------------------------------------------------- utils.vis


@pytest.mark.parametrize("seed,clip", [(0, None), (1, None), (2, 3.0), (3, 0.5)])
def test_flow_to_color_bit_for_bit(seed, clip):
    rng = np.random.default_rng(seed)
    flow = rng.normal(size=(31, 45, 2)) * rng.uniform(0.1, 20)
    flow[0, :4] = 0.0
    got, ref = tutil.flow_to_color(flow, clip), jutil.flow_to_color(flow, clip)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    # the radius > 1 branch, reachable by direct callers
    u, v = flow[..., 0] / 3.0, flow[..., 1] / 3.0
    np.testing.assert_array_equal(tutil.flow_uv_to_colors(u, v), jutil.flow_uv_to_colors(u, v))


@pytest.mark.parametrize("case", ["plain", "mask", "nonfinite", "constant", "empty", "quantiles"])
def test_colorize_depth_bit_for_bit(case):
    """matplotlib's turbo lookup, its 1.0 -> N - 1 rule and the truncating
    uint8 cast, against the JAX package's (which calls matplotlib)."""
    rng = np.random.default_rng(7)
    d = rng.uniform(0.5, 12.0, (40, 52))
    mask, kw = None, {}
    if case == "mask":
        mask = rng.uniform(size=d.shape) > 0.3
    elif case == "nonfinite":
        d[rng.uniform(size=d.shape) < 0.1] = np.nan
        d[0, :3] = [np.inf, -np.inf, np.nan]
    elif case == "constant":
        d[:] = 3.0
    elif case == "empty":
        mask = np.zeros(d.shape, bool)
    else:
        kw = dict(q_lo=0.0, q_hi=1.0)
    got, ref = tutil.colorize_depth(d, mask, **kw), jutil.colorize_depth(d, mask, **kw)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_turbo_table_and_lookup_equal_matplotlib():
    import matplotlib

    cm = matplotlib.colormaps["turbo"]
    np.testing.assert_array_equal(tutil.TURBO, cm(np.arange(256))[:, :3])
    x = np.concatenate([np.linspace(0, 1, 4097), [np.nan, 255 / 256, 1 / 256, 1.0]])
    np.testing.assert_array_equal(tutil.colormap_lookup(x), cm(x)[:, :3])
    with pytest.raises(ValueError, match="turbo"):
        tutil.colorize_depth(np.ones((2, 2)), cmap="viridis")


@pytest.mark.parametrize("colors", [False, True])
def test_ply_and_frustum_byte_for_byte(tmp_path, colors):
    rng = np.random.default_rng(11)
    w2c = np.eye(4)
    w2c[:3, 3] = rng.normal(size=3)
    pts = np.concatenate([tutil.camera_frustum_points(w2c, 0.2, 9),
                          rng.normal(size=(20, 3)).astype(np.float32)])
    np.testing.assert_array_equal(pts[:72], jutil.camera_frustum_points(w2c, 0.2, 9))
    cols = rng.uniform(-0.1, 1.1, (len(pts), 3)) if colors else None
    tutil.save_ply_points(tmp_path / "t.ply", pts, cols)
    jutil.save_ply_points(tmp_path / "j.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("src,tgt", [("0_1", "0_255"), ("-1_1", "0_1"), ("0_255", "-1_1"),
                                     ("0_1", "0_1")])
def test_modify_rgb_range(src, tgt):
    img = np.random.default_rng(2).uniform(size=(5, 6, 3))
    np.testing.assert_array_equal(tutil.modify_rgb_range(img, src, tgt),
                                  jutil.modify_rgb_range(img, src, tgt))


# ------------------------------------------------------------------ readers


@pytest.fixture(scope="module")
def vis_scene(tmp_path_factory):
    """An 8-frame NVIDIA-layout scene at 24x32 with flows between all its
    frames (intervals 1 and 2)."""
    root = tmp_path_factory.mktemp("vis_scene")
    chip_smoke.write_reader_scene(root, raw_hw=(H, W), eval_hw=(H, W), n_frames=N_FRAMES,
                                  items=(), flow_frames=((0, N_FRAMES),))
    return root


def write_mono_scene(root, h=H, w=W, n=6, seed=41):
    """A DAVIS-layout scene (the preprocessing's output) from ``seed``:
    PNG frames, K 3x3 on even frames and 4x4 on odd ones, smooth depths,
    1-bit masks at twice the frame size on odd frames, flows at intervals 1
    and 2 with a coord_diff that marks some pixels occluded."""
    rng = np.random.default_rng(seed)
    scene = root / MONO_SCENE
    for sub in ("rgbs", "poses", "depths", "masks/final", "flows/interval_1",
                "flows/interval_2"):
        (scene / sub).mkdir(parents=True)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    for i in range(n):
        name = f"{i:05d}"
        k = np.eye(3) if i % 2 == 0 else np.eye(4)
        k[0, 0] = k[1, 1] = 35.0
        k[0, 2], k[1, 2] = w / 2, h / 2
        ang = 0.02 * rng.uniform(-1, 1, 3)
        c2w = np.eye(4)
        c2w[:3, :3] = _rotvec(ang)
        c2w[:3, 3] = [0.05 * i + 0.01 * rng.uniform(), -0.02 * i, 0.01 * i]
        np.savez(scene / "poses" / f"{name}.npz", K=k, c2w=c2w)
        write_png(scene / "rgbs" / f"{name}.png", rng.integers(0, 255, (h, w, 3), np.uint8))
        a, b, c = rng.uniform(-1, 1, 3)
        depth = (3.0 + a * xx + b * yy + 0.3 * c * np.sin(6 * xx)).astype(np.float32)
        np.savez(scene / "depths" / f"{name}.npz", depth=depth)
        mh, mw = (h, w) if i % 2 == 0 else (2 * h, 2 * w)
        write_png(scene / "masks/final" / f"{name}_final.png", rng.uniform(size=(mh, mw)) > 0.75)
    for interval in (1, 2):
        for i in range(n - interval):
            for a, b in ((i, i + interval), (i + interval, i)):
                np.savez(scene / f"flows/interval_{interval}" / f"{a:05d}_{b:05d}.npz",
                         flow=rng.uniform(-2, 2, (h, w, 2)).astype(np.float32),
                         coord_diff=rng.uniform(-0.8, 0.8, (h, w, 2)).astype(np.float32))
    return root


def _rotvec(v):
    """Rodrigues' rotation of a rotation vector."""
    theta = np.linalg.norm(v)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) / theta
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * k @ k


@pytest.fixture(scope="module")
def mono_scene(tmp_path_factory):
    return write_mono_scene(tmp_path_factory.mktemp("mono_scene"))


TRAJ = dict(n_render_frames=6, vis_center_time=3, vis_time_interval=3, vis_bt_max_disp=32)
MONO_TRAJ = dict(n_render_frames=5, vis_center_time=2, vis_time_interval=2, vis_bt_max_disp=64)


@pytest.mark.parametrize("fmt", ["png", "jpeg", "other"])
def test_image_hw_reads_the_header(fmt):
    """The vis reader's frame size, from the header alone, as PIL sees it."""
    import io

    from pgdvs_tpu_torch.data.image_io import image_hw

    buf = io.BytesIO()
    img = PIL.Image.fromarray(np.zeros((37, 53, 3), np.uint8))
    if fmt == "other":
        img.save(buf, format="BMP")
        with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
            image_hw(buf.getvalue())
        return
    img.save(buf, format=fmt.upper())
    assert image_hw(buf.getvalue()) == (37, 53)


def _assert_traj_equal(got, ref):
    assert len(got.traj) == len(ref.traj)
    for (gs, gt, gi, gc), (rs, rt, ri, rc) in zip(got.traj, ref.traj):
        assert (gs, gt, gi) == (rs, rt, ri)
        np.testing.assert_allclose(gc, rc, **POSE_TOL)


@pytest.mark.parametrize("track", [False, True])
def test_nvidia_vis_reader_matches_jax(vis_scene, track):
    """The trajectory from t = 0 (one temporal source, duplicated) to
    t = 6, every item against the JAX reader."""
    kw = dict(data_root=str(vis_scene), n_src_views_spatial=3, tgt_height=H,
              n_src_views_temporal_track_one_side=2, with_track_sources=track, **TRAJ)
    ours, ref = tvis.NvidiaVisDataset(**kw), jvis.NvidiaVisDataset(**kw)
    _assert_traj_equal(ours, ref)
    assert len(ours) == TRAJ["n_render_frames"]
    for i in range(len(ref)):
        got = ours[i]
        _assert_items_equal(got, ref[i], f"nvidia_vis track={track} item {i}")
        assert got["flat_cam_tgt"][:2].tolist() == [H, W]
    assert ours[0]["misc"]["n_actual_temporal"] == 1


@pytest.mark.parametrize("track", [False, True])
def test_mono_vis_reader_matches_jax(mono_scene, track):
    kw = dict(data_root=str(mono_scene), scene_ids=[MONO_SCENE], n_src_views_spatial=3,
              n_src_views_temporal_track_one_side=2, with_track_sources=track, **MONO_TRAJ)
    ours, ref = tmono.MonoVisDataset(**kw), jmono.MonoVisDataset(**kw)
    _assert_traj_equal(ours, ref)
    for i in range(len(ref)):
        _assert_items_equal(ours[i], ref[i], f"mono_vis track={track} item {i}")


# --------------------------------------------------------------- debug dumps


def test_debug_dumps_match_jax(vis_scene, tmp_path):
    """The three dumps of one vis item, port and JAX: every PNG's pixels
    equal (the render dict is random, the same for both), the PLY points
    and colours at 1e-5."""
    import jax.numpy as jnp

    from pgdvs_tpu.engines import debug as jdebug
    from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
    from pgdvs_tpu_torch.engines import debug as tdebug
    from pgdvs_tpu_torch.renderers.config import RenderConfig

    kw = dict(data_root=str(vis_scene), n_src_views_spatial=3, tgt_height=H, **TRAJ)
    data = tvis.NvidiaVisDataset(**kw)[2]
    rng = np.random.default_rng(3)
    out = {"combined_rgb": rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32),
           "dyn_mask": (rng.uniform(size=(H, W, 1)) > 0.5).astype(np.float32),
           "weights": rng.uniform(size=(H * W, 8)).astype(np.float32)}
    tdebug.dump_render_intermediates({k: torch.from_numpy(v) for k, v in out.items()},
                                     {**data, "rgb_tgt": data["rgb_src_temporal"][0]},
                                     tmp_path / "t")
    jdebug.dump_render_intermediates({k: jnp.asarray(v) for k, v in out.items()},
                                     {**data, "rgb_tgt": data["rgb_src_temporal"][0]},
                                     tmp_path / "j")
    tcfg, jcfg = RenderConfig(dyn_pcl_remove_outlier=False), JRenderConfig(
        dyn_pcl_remove_outlier=False)
    tpcl = tdebug.dump_dynamic_pointclouds(data, tcfg, tmp_path / "t", device="cpu")
    jdebug.dump_dynamic_pointclouds(data, jcfg, tmp_path / "j")
    tdebug.dump_epipolar_overlay(data, tmp_path / "t", n_samples=16, device="cpu")
    jdebug.dump_epipolar_overlay(data, tmp_path / "j", n_samples=16)
    pngs = sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert pngs == sorted(p.name for p in (tmp_path / "t").glob("*.png"))
    assert "debug_combined_rgb.png" in pngs and "epi_src_02.png" in pngs
    for name in pngs:
        with PIL.Image.open(tmp_path / "j" / name) as im:
            ref = np.array(im)
        np.testing.assert_array_equal(read_image(tmp_path / "t" / name), ref, err_msg=name)
    got, ref = (np.loadtxt(tmp_path / d / "dyn_pcl_all.ply", skiprows=10, ndmin=2)
                for d in ("t", "j"))
    assert got.shape == ref.shape and got.shape[0] == int(tpcl["valid"].sum()) > 0
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=1e-5, atol=1e-5)
    assert np.abs(got[:, 3:] - ref[:, 3:]).max() <= 1


# ----------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference GNT checkpoint of the port's random models (seed 0),
    which both CLIs load."""
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    path = tmp_path_factory.mktemp("vis_ckpt") / "gnt" / "model_720000.pth"
    chip_smoke.save_reference_checkpoint(init_gnt_models(seed=0, device="cpu"), path)
    return path


def _jax_cli():
    from test_torch_port_cli import _jax_cli as load

    return load()


def use_jax_noise(mp):
    """Make the port's Visualizer render frame i with the softsplat noise
    JAX's draws for it (``jax.random.normal(PRNGKey(i))``), so the frames
    differ by the networks' arithmetic alone."""
    import jax

    from pgdvs_tpu_torch.engines.visualizer import Visualizer
    from pgdvs_tpu_torch.renderers.compose import render_novel_view

    def render(self, data, seed):
        shape = tuple(data["rgb_src_temporal"].shape[1:])
        noise = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)))
        return render_novel_view(self.models, data, self.cfg, static_mode=self.static_mode,
                                 noise=noise.to(data["flat_cam_tgt"].device))

    mp.setattr(Visualizer, "render", render)


@pytest.fixture
def jax_noise(monkeypatch):
    use_jax_noise(monkeypatch)


KNOBS = ["n_coarse_samples_per_ray=8", "ray_tile=256"]
JAX_ONLY = ["use_pallas_gnt=false", "knn_tile=256"]
# port (float32 network on the CPU) against JAX (flax float32) on the exact
# preset: the PNGs agree within one uint8 level, on at most this share of
# the values (the CLI tests see ~2.5 % of quantised values move by one)
VIS_TOL = 0.05


def _frames(out):
    files = sorted(out.glob("*_combined.png"))
    return [f.name for f in files], [read_image(f).astype(int) for f in files]


def _assert_frames_close(out_t, out_j, n):
    names_t, t = _frames(out_t)
    names_j, j = _frames(out_j)
    assert names_t == names_j == [f"{i:06d}_combined.png" for i in range(n)]
    for name, a, b in zip(names_t, t, j):
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() <= VIS_TOL, (name, diff.max(),
                                                                  (diff > 0).mean())


# fractional trajectory times: at an integer time the dynamic cloud is the
# frame's own, and the bullet-time offset of a short trajectory moves the
# camera along y only, so every point lands on a pixel column's edge and
# the splat's coverage there hangs on the last bit
VIS_ARGS = ["n_render_frames=2", "vis_center_time=3", "vis_time_interval=0.75",
            "n_src_views_spatial=2"]


@pytest.fixture(scope="module")
def bundle_frames(vis_scene, ckpt, tmp_path_factory):
    """``benchmark --benchmark-type visualize_nvidia_max_disp_32`` (exact
    preset) through the port's CLI and the JAX CLI: (port out dir, JAX out
    dir, the port's Visualizer). The JAX benchmark subcommand takes no
    --dataset-arg, so the bundle's dataset arguments carry the scene's
    there."""
    import pgdvs_tpu.configs.benchmarks as jbench

    tmp = tmp_path_factory.mktemp("vis_bundle")
    name = "visualize_nvidia_max_disp_32"
    argv = ["benchmark", "--benchmark-type", name, "--perf-preset", "exact",
            "--data-root", str(vis_scene), "--scene-ids", SCENE, "--gnt-ckpt", str(ckpt)]
    spec = jbench.BENCHMARK_TYPES[name]
    with pytest.MonkeyPatch.context() as mp:
        use_jax_noise(mp)
        vis = trun.main([*argv, "--device", "cpu", "--dataset-arg", *VIS_ARGS,
                         "--out-dir", str(tmp / "port"), "--render-cfg", *KNOBS])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jbench.BENCHMARK_TYPES, name, {**spec, "dataset_args": {
            **spec["dataset_args"], **{k: trun._coerce(v) for k, v in
                                       (a.split("=") for a in VIS_ARGS)}}})
        _jax_cli().main([*argv, "--gnt-dtype", "float32", "--out-dir", str(tmp / "jax"),
                         "--render-cfg", *KNOBS, *JAX_ONLY])
    return tmp / "port", tmp / "jax", vis


def test_benchmark_visualize_bundle_matches_the_jax_cli(bundle_frames):
    """The refusal of the visualize_nvidia_max_disp_32 bundle before the vis
    slice, now a run: the frames against the JAX CLI's, the video skipped
    without imageio-ffmpeg as JAX's is."""
    out_t, out_j, vis = bundle_frames
    _assert_frames_close(out_t, out_j, 2)
    assert len(vis.frame_seconds) == 2
    assert vis.video_written == (out_t / "video_combined.mp4").is_file()


def test_vis_subcommand_nvidia_equals_the_bundle(vis_scene, ckpt, bundle_frames, tmp_path,
                                                 jax_noise):
    """``vis --dataset nvidia_vis`` with the bundle's settings writes the
    bundle's frames bit for bit."""
    out_t, _, _ = bundle_frames
    trun.main(["vis", "--dataset", "nvidia_vis", "--perf-preset", "exact", "--device", "cpu",
               "--data-root", str(vis_scene), "--scene-ids", SCENE, "--gnt-ckpt", str(ckpt),
               "--dataset-arg", *VIS_ARGS, "vis_bt_max_disp=32", "--out-dir",
               str(tmp_path), "--render-cfg", *KNOBS, "gnt_use_dyn_mask=true"])
    for a, b in zip(_frames(tmp_path)[1], _frames(out_t)[1]):
        np.testing.assert_array_equal(a, b)


def test_vis_subcommand_mono_matches_the_jax_cli(mono_scene, ckpt, tmp_path, jax_noise):
    argv = ["vis", "--dataset", "mono_vis", "--perf-preset", "exact",
            "--data-root", str(mono_scene), "--scene-ids", MONO_SCENE, "--gnt-ckpt", str(ckpt),
            "--dataset-arg", "n_render_frames=2", "vis_center_time=2", "vis_time_interval=0.5",
            "n_src_views_spatial=2"]
    trun.main([*argv, "--device", "cpu", "--out-dir", str(tmp_path / "port"),
               "--render-cfg", *KNOBS])
    _jax_cli().main([*argv, "--gnt-dtype", "float32", "--out-dir", str(tmp_path / "jax"),
                     "--render-cfg", *KNOBS, *JAX_ONLY])
    _assert_frames_close(tmp_path / "port", tmp_path / "jax", 2)


def test_eval_on_a_vis_reader_runs(vis_scene, ckpt, tmp_path):
    """The refusal of ``eval --dataset nvidia_vis`` before the vis slice:
    the JAX CLI's eval runs on a vis reader and scores nothing (its items
    carry no rgb_tgt), and so does the port's."""
    result = trun.main(["eval", "--dataset", "nvidia_vis", "--device", "cpu",
                        "--data-root", str(vis_scene), "--scene-ids", SCENE,
                        "--gnt-ckpt", str(ckpt), "--dataset-arg", *VIS_ARGS,
                        "--out-dir", str(tmp_path), "--render-cfg", *KNOBS])
    assert result["count"] == 2 and sorted(result["mean"]) == ["render_wall_s"]
    assert json.loads((tmp_path / "summary.json").read_text()) == json.loads(json.dumps(result))


def test_vis_needs_an_out_dir(vis_scene):
    with pytest.raises(SystemExit, match="out-dir"):
        trun.main(["vis", "--dataset", "nvidia_vis", "--device", "cpu",
                   "--data-root", str(vis_scene), "--dataset-arg", *VIS_ARGS])


def test_vis_help_parses(capsys):
    """The refusal of the vis subcommand before the vis slice: it parses."""
    with pytest.raises(SystemExit) as exc:
        trun.main(["vis", "--help"])
    assert exc.value.code == 0
    assert "--dataset" in capsys.readouterr().out


# ------------------------------------------------------------------- imports

FORBIDDEN = ("jax", "jaxlib", "flax", "pgdvs_tpu", "sklearn", "matplotlib", "PIL", "cv2",
             "imageio")


def test_port_and_smoke_import_nothing_the_card_lacks():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter without JAX, the JAX package, scikit-learn, matplotlib,
    PIL, OpenCV or imageio (which only ``images_to_video`` tries, lazily)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import pgdvs_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pgdvs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(chip_smoke.__file__).rsplit("/", 1)[0])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
