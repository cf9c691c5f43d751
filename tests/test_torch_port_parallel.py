"""The port's multi-process scaling (``pgdvs_tpu_torch.parallel`` and the
evaluator's mesh mode and cross-process sum) against one process and
against the JAX package.

``mesh_shape`` raises where JAX's ``make_mesh`` raises, for the same (n,
dp, rp) on the 8 CPU devices of tests/conftest.py. Then two gloo ranks on
the CPU (``tests/torch_port_dist_worker.py``, launched once for the module
as two fresh interpreters that import no JAX) and, held here against one
process: the mesh layouts; ``sharded_render_rays`` on patch (4x2 blocks)
and exact (a padded share) against ``render_image_gnt``; the mesh evaluator
over five items (three on one rank, two on the other) against the
single-device one, with a pickle for each item;
``make_sharded_eval_fn``'s batch of two views against one process's
renders of each; the cross-process sum over three items,
with ``max_items`` and with one rank's shard empty, on both ranks; the train
step of one batch of two views on a dp = 2, an rp = 2 and a one-rank mesh,
against each other (1e-6 / 1e-5) and against JAX's dp = 2 step on two CPU
devices within tests/test_torch_port_trainer.py's float32 bounds. Last,
``python -m torch.distributed.run --nproc-per-node 2 -m pgdvs_tpu_torch.run
eval --distributed --devices 2 --device cpu --dist-backend gloo`` against
the one-process CLI's ``summary.json``, and ``train --distributed`` with
its checkpoints. Each launch takes a free port and has a time
limit of its own."""

import json
import os
import pathlib
import pickle
import re
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_port_dist_worker as worker
from pgdvs_tpu.parallel.mesh import make_mesh as j_make_mesh
from pgdvs_tpu.parallel.sharded import make_train_step as j_make_train_step
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.static_gnt import make_gnt_models
from pgdvs_tpu_torch import run as trun
from pgdvs_tpu_torch.engines.evaluator import Evaluator
from pgdvs_tpu_torch.parallel.mesh import mesh_shape
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models, render_image_gnt
from test_torch_port_lk import one_thread
from test_torch_port_trainer import (
    GRAD_TOL,
    LOSS_RTOL,
    N_RAYS,
    assert_grads,
    grad_catcher,
    init_jax_params,
    state_dicts,
    train_batch,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LAUNCH_TIMEOUT_S = 240
# the meshes against one rank: the same arithmetic but the order of sums
MESH_LOSS_RTOL = 1e-6
MESH_GRAD_TOL = 1e-5
H, W = 24, 32             # the CLI scene


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("PYTEST_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1", **extra)
    return env


def _join(procs, timeout=LAUNCH_TIMEOUT_S):
    """Wait for every process within ``timeout`` s in all; kill the rest and
    fail on a timeout or a non-zero exit, with the output's end."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    return outs


def launch_workers(in_dir, out_dir, n=2):
    env = _env(MASTER_PORT=str(free_port()), WORLD_SIZE=str(n))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_port_dist_worker.py"),
                               str(in_dir), str(out_dir)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    _join(procs)
    return ([json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(n)],
            [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(n)])


def torchrun(argv, n=2):
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                             str(n), "--master-addr", "127.0.0.1", "--master-port",
                             str(free_port()), *argv], env=_env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return _join([proc])[0]


# --- make_mesh ----------------------------------------------------------------

@pytest.mark.parametrize("n,dp,rp", [
    (8, None, 1), (8, None, 2), (8, 4, 2), (8, 2, 4), (8, None, 3), (8, 3, None), (8, 3, 2),
    (6, None, 4), (4, 4, 1), (4, 2, 1), (2, None, 2), (1, None, 1), (1, None, 2)])
def test_mesh_shape_raises_as_jax_make_mesh(n, dp, rp):
    rp = 1 if rp is None else rp
    try:
        m = j_make_mesh(n_devices=n, dp=dp, rp=rp)
        want = (m.shape["dp"], m.shape["rp"])
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh_shape(n, dp, rp)
        return
    assert mesh_shape(n, dp, rp) == want


def test_one_process_mesh_has_no_collectives():
    from pgdvs_tpu_torch.parallel.mesh import all_gather, all_reduce_sum, make_mesh

    m = make_mesh(n_devices=4, device="cpu")
    assert (m.dp, m.rp, m.rank, m.coord, m.ranks, m.index, m.count) == (1, 1, 0, (0, 0), (0,),
                                                                       0, 1)
    assert m.group is None and m.dp_group is None and m.rp_group is None
    t = torch.arange(3.0)
    assert torch.equal(all_reduce_sum(t), t) and torch.equal(all_gather(t, m.group)[0], t)
    with pytest.raises(ValueError, match="not divisible by rp=2"):
        make_mesh(rp=2)


# --- two ranks ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dp2():
    """JAX's dp = 2 step on two CPU devices from PRNGKey(0) weights, its
    gradients kept as the optimizer's state: (params, batch, loss, grads as
    the port's state-dict names). The batch: two held-out source views of
    64 rays off the border (``test_torch_port_trainer.train_batch``)."""
    models = make_gnt_models(dtype="float32")
    params = init_jax_params()
    catch = grad_catcher()
    mesh = j_make_mesh(n_devices=2, dp=2, rp=1)
    cfg = JRenderConfig(n_coarse_samples_per_ray=worker.S, ray_tile=320, knn_tile=256)
    step, _ = j_make_train_step(mesh, models, cfg, catch, N_RAYS)
    batch = train_batch(n_views=2)
    with mesh:
        _, grads, loss = step(params, catch.init(params), {k: jnp.asarray(v)
                                                            for k, v in batch.items()})
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return np_params, batch, float(loss), state_dicts(jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def ranks(jax_dp2, tmp_path_factory):
    np_params, batch, _, _ = jax_dp2
    in_dir = tmp_path_factory.mktemp("dist_in")
    blob = {f"sd.{k}": v for k, v in state_dicts(np_params).items()}
    blob.update({f"batch.{k}": v for k, v in batch.items()})
    np.savez(in_dir / "train.npz", **blob)
    out_dir = tmp_path_factory.mktemp("dist_out")
    res, arrays = launch_workers(in_dir, out_dir)
    return res, arrays, out_dir


def test_ranks_join_one_world_and_lay_meshes_row_major(ranks):
    res, _, _ = ranks
    for r, rec in enumerate(res):
        assert rec["world"] == [r, 2]
        assert rec["mesh_dp2"] == {"dp": 2, "rp": 1, "rank": r, "coord": [r, 0], "ranks": [0, 1],
                                   "index": 0, "count": 1, "groups": [True, True, False]}
        assert rec["mesh_rp2"] == {"dp": 1, "rp": 2, "rank": r, "coord": [0, r], "ranks": [0, 1],
                                   "index": 0, "count": 1, "groups": [True, False, True]}
        assert rec["mesh_one"] == {"dp": 1, "rp": 1, "rank": 0, "coord": [0, 0], "ranks": [r],
                                   "index": r, "count": 2, "groups": [False, False, False]}
        assert rec["gathered"] == [1.0, 1.0, 2.0, 2.0] and rec["summed"] == [3.0, 3.0]


@pytest.mark.parametrize("mode", sorted(worker.RENDER_CASES))
def test_sharded_render_equals_one_rank(ranks, mode):
    _, arrays, _ = ranks
    h, w = worker.RENDER_CASES[mode]
    d = {k: torch.from_numpy(v) for k, v in worker.render_data(mode).items()
         if isinstance(v, np.ndarray)}
    ref = render_image_gnt(init_gnt_models(seed=0, device="cpu"), d["flat_cam_tgt"],
                           d["flat_cam_src_spatial"], d["static_rgb_src_spatial"], (h, w),
                           d["depth_range"], worker.render_cfg(mode))
    for r in range(2):
        for k in ("rgb", "depth", "weights", "inbound_cnt"):
            got = arrays[r][f"render_{mode}_{k}"]
            assert got.shape == tuple(ref[k].shape), k
            np.testing.assert_allclose(got, ref[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


def _single(items, **kw):
    models = init_gnt_models(seed=0, device="cpu")
    return Evaluator(models, worker.eval_cfg(), device="cpu", **kw).run(items)


def _assert_summary(got, want):
    assert got["count"] == want["count"]
    assert sorted(got["mean"]) == sorted(want["mean"])
    for k, v in want["mean"].items():
        if k != "render_wall_s":
            assert got["mean"][k] == pytest.approx(v, rel=1e-9, abs=1e-12), k
            assert got["sum"][k] == pytest.approx(want["sum"][k], rel=1e-9, abs=1e-12), k


def test_mesh_evaluator_equals_single_device(ranks, tmp_path):
    res, _, out_dir = ranks
    want = _single(worker.eval_items(5), out_dir=str(tmp_path))
    assert want["count"] == 5
    for rec in res:
        _assert_summary(rec["mesh_eval"], want)
    names = sorted(p.name for p in (out_dir / "mesh_eval").glob("*.pkl"))
    assert names == [f"{i:06d}.pkl" for i in range(5)]
    for name in names:
        got = pickle.loads((out_dir / "mesh_eval" / name).read_bytes())
        ref = pickle.loads((tmp_path / name).read_bytes())
        assert {k: v for k, v in got.items() if k != "render_wall_s"} == pytest.approx(
            {k: v for k, v in ref.items() if k != "render_wall_s"}, rel=1e-12)


def test_sharded_eval_fn_gathers_each_ranks_view(ranks):
    """The batch on every rank is [item 0's render, item 1's], each as
    ``render_novel_view`` renders it on one process with its seed."""
    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.renderers.compose import render_novel_view

    _, arrays, _ = ranks
    models = init_gnt_models(seed=0, device="cpu")
    want = np.stack([render_novel_view(models, contract_to_device(d, "cpu"), worker.eval_cfg(),
                                       generator=torch.Generator().manual_seed(i))[
                                           "combined_rgb"].numpy()
                     for i, d in enumerate(worker.eval_items(2))])
    for r in range(2):
        np.testing.assert_allclose(arrays[r]["sharded_eval_combined_rgb"], want, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("case,items", [("sum_full", 3), ("sum_max_items", 2),
                                        ("sum_empty_shard", 1)])
def test_cross_process_sum_on_every_rank(ranks, case, items):
    """Each rank sums its stride of the items; both return the dataset's
    summary, the rank with an empty shard too."""
    res, _, _ = ranks
    want = _single(worker.eval_items(3)[:items])
    for rec in res:
        _assert_summary(rec[case], want)


@pytest.mark.parametrize("mesh", ["dp2", "rp2", "one"])
def test_train_step_equals_jax_dp2(ranks, jax_dp2, mesh):
    """Float32 bounds of tests/test_torch_port_trainer.py (the float32
    step is ill-conditioned: JAX's own float32 gradients lie up to ~1e-2 of
    a leaf's largest entry from their float64 value)."""
    res, arrays, _ = ranks
    _, _, loss, grads = jax_dp2
    for r in range(2):
        assert res[r][f"loss_{mesh}"] == pytest.approx(loss, rel=LOSS_RTOL)
        assert_grads({k: arrays[r][f"grad_{mesh}.{k}"] for k in grads}, grads, GRAD_TOL, 1e-6,
                     f"{mesh} rank {r}")


@pytest.mark.parametrize("mesh", ["dp2", "rp2"])
def test_mesh_step_equals_one_rank(ranks, mesh):
    """dp = 2 and rp = 2 against one rank with both views: the gradients
    summed over ranks are the one rank's, the same arithmetic summed in
    another order."""
    res, arrays, _ = ranks
    one = {k[len("grad_one."):]: v for k, v in arrays[0].items() if k.startswith("grad_one.")}
    for r in range(2):
        assert res[r][f"loss_{mesh}"] == pytest.approx(res[0]["loss_one"], rel=MESH_LOSS_RTOL)
        assert_grads({k: arrays[r][f"grad_{mesh}.{k}"] for k in one}, one, MESH_GRAD_TOL, 1e-3,
                     f"{mesh} rank {r}")


# --- the CLI under torchrun ---------------------------------------------------------

@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_dist_scene")
    chip_smoke.write_reader_scene(root, raw_hw=(H, W), eval_hw=(H, W), n_frames=3, items=(),
                                  flow_frames=((0, 3),))
    return root


def _cli_argv(cmd, root, out, *extra):
    return [cmd, "--device", "cpu", "--data-root", str(root), "--scene-ids",
            chip_smoke.READER_SCENE, "--dataset-arg", f"tgt_height={H}", "n_src_views_spatial=2",
            "--out-dir", str(out), "--render-cfg", "n_coarse_samples_per_ray=8", "ray_tile=256",
            *extra]


def test_distributed_cli_eval_equals_one_process(cli_scene, tmp_path):
    one = tmp_path / "one"
    trun.main(_cli_argv("eval", cli_scene, one))
    two = tmp_path / "two"
    torchrun(["-m", "pgdvs_tpu_torch.run",
              *_cli_argv("eval", cli_scene, two, "--distributed", "--devices", "2",
                         "--dist-backend", "gloo")])
    want = json.loads((one / "summary.json").read_text())
    got = json.loads((two / "summary.json").read_text())
    assert want["count"] == 3
    _assert_summary(got, want)
    assert sorted(p.name for p in two.glob("*.pkl")) == [f"{i:06d}.pkl" for i in range(3)]


def test_distributed_cli_train(cli_scene, tmp_path):
    """Two epochs over 3 items at dp = 2: two steps each, the second the
    remainder cycled; a checkpoint per epoch, written once."""
    from pgdvs_tpu_torch.engines.checkpoint import list_checkpoints

    out = tmp_path / "ft"
    log = torchrun(["-m", "pgdvs_tpu_torch.run",
                    *_cli_argv("train", cli_scene, out, "--distributed", "--dist-backend", "gloo",
                               "--n-rays", "32", "--gnt-dtype", "float32", "--epochs", "2")])
    assert log.count('{"epochs": 2, "steps": 4') == 1
    assert [(e, s) for e, s, _ in list_checkpoints(out)] == [(1, 2), (2, 4)]
    assert json.loads((out / "config.json").read_text())["render_cfg"][
        "n_coarse_samples_per_ray"] == 8
