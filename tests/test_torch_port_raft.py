"""The port's RAFT and flow preprocessing against the JAX package's, on the
CPU, from one fake princeton-vl state dict (the key layout of
tests/test_raft.py's ``_fake_raft_sd``, copied here): the JAX side through
``port_raft``, the port's through a ``.pth`` written to a temporary
directory and ``load_raft_checkpoint``; ``raft_params_from_jax`` gives the
port's state dict back from JAX's params.

  * the two encoders, the correlation pyramid and its lookup (taps past
    the border, levels one pixel wide), the update block and the convex
    upsampling: 1e-4 relative to the output's scale (float32, other
    convolution and summation orders);
  * RAFTFlow at 35x45 (padded to 40x48, the pad split across both sides),
    2 iterations, both directions and ``one_way``: flows within 1e-5 of
    their largest magnitude (~45 px with these weights; the largest
    difference seen is ~8e-5 px);
  * ``compute_scene_flows`` on 3 PNG frames at 35x45 with the same
    RAFT, interval 1 and 2: the npz files of both packages, the flows
    within 1e-5 of their largest magnitude, and each coord_diff within
    1e-5 px of JAX's ``flow_roundtrip`` of the port's two flows (against
    JAX's own coord_diff the flows' differences come back amplified where
    the backward flow is steep: up to ~8e-4 px of ~50 at these random
    weights); the CLI in-process with ``--device cpu
    from ``$PGDVS_CKPT_DIR``; without the checkpoint FileNotFoundError with
    JAX's message; without ``--device`` on a machine with no card it fails
    instead of running on the CPU.

JAX's RAFTFlow is compiled once for the module (one shape, 2 iterations).
The port runs on one torch thread.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.models.flow import raft as jraft
from pgdvs_tpu.models.flow.raft_port import port_raft
from pgdvs_tpu.preprocess.compute_flow import compute_scene_flows as j_compute_scene_flows
from pgdvs_tpu.preprocess.flow_consistency import flow_roundtrip as j_flow_roundtrip
from pgdvs_tpu_torch.data.image_io import write_png
from pgdvs_tpu_torch.models.flow import raft
from pgdvs_tpu_torch.models.flow.raft_port import (load_raft_checkpoint, make_raft_flow,
                                                   raft_params_from_jax, raft_state_dict)
from pgdvs_tpu_torch.preprocess import compute_flow

HW = (35, 45)
ITERS = 2
REL = 1e-4
FLOW_REL = 1e-5


def _fake_raft_sd():
    """princeton-vl raft-things key layout with random values."""
    rng = np.random.default_rng(2)
    sd = {}

    def add(name, *shape):
        sd["module." + name] = rng.normal(size=shape).astype(np.float32) * 0.05

    def enc(prefix, out_dim, batch):
        add(f"{prefix}.conv1.weight", 64, 3, 7, 7)
        add(f"{prefix}.conv1.bias", 64)
        if batch:
            for stat in ("weight", "bias", "running_mean"):
                add(f"{prefix}.norm1.{stat}", 64)
            sd[f"module.{prefix}.norm1.running_var"] = np.abs(
                rng.normal(size=64).astype(np.float32)) + 1.0
        chans = {1: (64, 64), 2: (64, 96), 3: (96, 128)}
        for li in (1, 2, 3):
            cin, planes = chans[li]
            for bi in (0, 1):
                t = f"{prefix}.layer{li}.{bi}"
                c0 = cin if bi == 0 else planes
                add(f"{t}.conv1.weight", planes, c0, 3, 3)
                add(f"{t}.conv1.bias", planes)
                add(f"{t}.conv2.weight", planes, planes, 3, 3)
                add(f"{t}.conv2.bias", planes)
                if batch:
                    for nn_ in ("norm1", "norm2"):
                        for stat in ("weight", "bias", "running_mean"):
                            add(f"{t}.{nn_}.{stat}", planes)
                        sd[f"module.{t}.{nn_}.running_var"] = (
                            np.abs(rng.normal(size=planes).astype(np.float32)) + 1.0)
                if bi == 0 and li > 1:
                    add(f"{t}.downsample.0.weight", planes, c0, 1, 1)
                    add(f"{t}.downsample.0.bias", planes)
                    if batch:
                        for stat in ("weight", "bias", "running_mean"):
                            add(f"{t}.downsample.1.{stat}", planes)
                        sd[f"module.{t}.downsample.1.running_var"] = (
                            np.abs(rng.normal(size=planes).astype(np.float32)) + 1.0)
        add(f"{prefix}.conv2.weight", out_dim, 128, 1, 1)
        add(f"{prefix}.conv2.bias", out_dim)

    enc("fnet", 256, batch=False)
    enc("cnet", 256, batch=True)
    add("update_block.encoder.convc1.weight", 256, 4 * 81, 1, 1)
    add("update_block.encoder.convc1.bias", 256)
    add("update_block.encoder.convc2.weight", 192, 256, 3, 3)
    add("update_block.encoder.convc2.bias", 192)
    add("update_block.encoder.convf1.weight", 128, 2, 7, 7)
    add("update_block.encoder.convf1.bias", 128)
    add("update_block.encoder.convf2.weight", 64, 128, 3, 3)
    add("update_block.encoder.convf2.bias", 64)
    add("update_block.encoder.conv.weight", 126, 256, 3, 3)
    add("update_block.encoder.conv.bias", 126)
    for s_, kern in (("1", (1, 5)), ("2", (5, 1))):
        for g in ("z", "r", "q"):
            add(f"update_block.gru.conv{g}{s_}.weight", 128, 384, *kern)
            add(f"update_block.gru.conv{g}{s_}.bias", 128)
    add("update_block.flow_head.conv1.weight", 256, 128, 3, 3)
    add("update_block.flow_head.conv1.bias", 256)
    add("update_block.flow_head.conv2.weight", 2, 256, 3, 3)
    add("update_block.flow_head.conv2.bias", 2)
    add("update_block.mask.0.weight", 256, 128, 3, 3)
    add("update_block.mask.0.bias", 256)
    add("update_block.mask.2.weight", 576, 256, 1, 1)
    add("update_block.mask.2.bias", 576)
    return sd


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fake_sd():
    return _fake_raft_sd()


@pytest.fixture(scope="module")
def jparams(fake_sd):
    return {"params": jax.tree_util.tree_map(jnp.asarray, port_raft(fake_sd))}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory, fake_sd):
    root = tmp_path_factory.mktemp("ckpts")
    (root / "raft" / "models").mkdir(parents=True)
    torch.save({k: torch.from_numpy(v) for k, v in fake_sd.items()},
               root / "raft" / "models" / "raft-things.pth")
    return root


@pytest.fixture(scope="module")
def model(ckpt_dir):
    return load_raft_checkpoint(str(ckpt_dir / "raft" / "models" / "raft-things.pth"),
                                device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, HW + (3,)).astype(np.float32)
    return [np.roll(base, 2 * i, axis=1) for i in range(3)]


def _close(got, ref, rel=REL, err_msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1.0),
                               err_msg=err_msg)


def _nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def test_params_from_jax_equals_the_checkpoint(model, jparams):
    sd = raft_params_from_jax(jparams)
    ref = model.state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k


def test_checkpoint_search_and_refusal(ckpt_dir, tmp_path, monkeypatch, fake_sd):
    """$PGDVS_CKPT_DIR/raft/models/raft-things.pth as JAX's loader finds it;
    None without it, and make_raft_flow raises. The released file's extra
    entries (``norm3`` twins of ``downsample.1``, ``num_batches_tracked``)
    load too."""
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(ckpt_dir))
    assert load_raft_checkpoint(device="cpu") is not None
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(tmp_path))
    assert load_raft_checkpoint(device="cpu") is None
    with pytest.raises(FileNotFoundError, match="RAFT checkpoint not found"):
        make_raft_flow(device="cpu")
    released = dict(fake_sd)
    for k in list(fake_sd):
        if ".downsample.1." in k:
            released[k.replace(".downsample.1.", ".norm3.")] = fake_sd[k]
        if k.endswith("running_var"):
            released[k.replace("running_var", "num_batches_tracked")] = np.array(7)
    m = raft.RAFT()
    m.load_state_dict(raft_state_dict(released))


@pytest.mark.parametrize("which", ["fnet", "cnet"])
def test_encoders_match_jax(model, jparams, which):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    norm = "instance" if which == "fnet" else "batch"
    out_dim = 256
    ref = jraft.BasicEncoderRAFT(out_dim, norm).apply({"params": jparams["params"][which]},
                                                     jnp.asarray(x))
    with torch.no_grad():
        got = getattr(model, which)(_nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == (2, 5, 6, out_dim)
    _close(got, ref)


@pytest.mark.parametrize("hw", [(6, 8), (5, 7)])
def test_corr_pyramid_and_lookup_match_jax(hw):
    """Four levels down to one pixel (6x8 -> 3x4 -> 1x2 -> 1x1; odd sizes
    drop a row / column); coordinates past every border."""
    h8, w8 = hw
    rng = np.random.default_rng(h8)
    f1 = rng.normal(size=(h8, w8, 32)).astype(np.float32)
    f2 = rng.normal(size=(h8, w8, 32)).astype(np.float32)
    coords = rng.uniform(-3, [w8 + 2, h8 + 2], (h8, w8, 2)).astype(np.float32)
    pyr_j = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    pyr = raft.build_corr_pyramid(_nchw(f1[None]), _nchw(f2[None]))
    for lvl, (a, b) in enumerate(zip(pyr, pyr_j)):
        assert a.shape[1:] == b.shape, lvl
        _close(a[0], b, err_msg=f"level {lvl}")
    ref = jraft.lookup_corr(pyr_j, jnp.asarray(coords))
    got = raft.lookup_corr(pyr, torch.from_numpy(coords)[None])
    _close(got[0].permute(1, 2, 0), ref)


def test_update_block_and_upsample_match_jax(model, jparams):
    rng = np.random.default_rng(4)
    h8, w8 = 5, 6
    hid = np.tanh(rng.normal(size=(1, h8, w8, 128))).astype(np.float32)
    ctx = np.maximum(rng.normal(size=(1, h8, w8, 128)), 0).astype(np.float32)
    corr = rng.normal(size=(1, h8, w8, 324)).astype(np.float32)
    flow = rng.normal(0, 2, (1, h8, w8, 2)).astype(np.float32)
    ref = jraft.UpdateBlock().apply({"params": jparams["params"]["update_block"]},
                                    *map(jnp.asarray, (hid, ctx, corr, flow)))
    with torch.no_grad():
        got = model.update_block(*map(_nchw, (hid, ctx, corr, flow)))
    for name, g, r in zip(("h", "mask", "delta"), got, ref):
        _close(g.permute(0, 2, 3, 1), r, err_msg=name)
    up_ref = jraft.convex_upsample(jnp.asarray(flow[0]), ref[1][0])
    up = raft.convex_upsample(_nchw(flow), torch.from_numpy(np.array(ref[1])).permute(0, 3, 1, 2))
    _close(up[0].permute(1, 2, 0), up_ref)


@pytest.fixture(scope="module")
def jflows(jparams, frames):
    """JAX's RAFTFlow on the frame pairs (0, 1) and (0, 2): one compile."""
    fn = jraft.RAFTFlow(params=jparams, iters=ITERS)
    return {(i, j): [np.asarray(f) for f in fn(jnp.asarray(frames[i]), jnp.asarray(frames[j]))]
            for i, j in ((0, 1), (0, 2))}


def test_raft_flow_matches_jax(model, frames, jflows):
    fn = raft.RAFTFlow(model, iters=ITERS)
    f12, f21 = fn(frames[0], frames[1])
    ref12, ref21 = jflows[(0, 1)]
    assert f12.shape == HW + (2,) and float(np.abs(ref12).max()) > 1.0
    _close(f12, ref12, FLOW_REL)
    _close(f21, ref21, FLOW_REL)
    _close(fn.one_way(frames[0], frames[1]), ref12, FLOW_REL)
    # RAFT.forward on the padded pair (multiples of 8) equals the contract
    both, (sy, sx) = fn._padded(frames[0], frames[1])
    with torch.no_grad():
        _close(model(both[0], both[1], ITERS)[sy, sx], ref12, FLOW_REL)


def _write_frames(rgb_dir, frames):
    rgb_dir.mkdir()
    for i, f in enumerate(frames):
        write_png(rgb_dir / f"{i:05d}.png", np.round(f * 255).astype(np.uint8))


def test_compute_scene_flows_matches_jax(tmp_path, model, jparams, frames, monkeypatch,
                                         ckpt_dir):
    rgb_dir = tmp_path / "rgbs"
    _write_frames(rgb_dir, frames)
    n_ref = j_compute_scene_flows(rgb_dir, tmp_path / "jax", intervals=(1, 2),
                                  flow_fn=jraft.RAFTFlow(params=jparams, iters=ITERS))
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(ckpt_dir))
    compute_flow.main(["--rgb-dir", str(rgb_dir), "--save-dir", str(tmp_path / "port"),
                       "--intervals", "1", "2", "--iters", str(ITERS), "--device", "cpu"])
    ref_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npz"))
    got_files = sorted(p.relative_to(tmp_path / "port")
                       for p in (tmp_path / "port").rglob("*.npz"))
    assert got_files == ref_files and len(ref_files) == n_ref == 6
    for rel in ref_files:
        ref, got = np.load(tmp_path / "jax" / rel), np.load(tmp_path / "port" / rel)
        assert set(got.files) == {"flow", "coord_diff"}
        for key in ("flow", "coord_diff"):
            assert got[key].dtype == np.float32 and got[key].shape == HW + (2,)
        _close(got["flow"], ref["flow"], FLOW_REL, err_msg=str(rel))
        a, b = rel.stem.split("_")
        back = np.load(tmp_path / "port" / rel.parent / f"{b}_{a}.npz")["flow"]
        ref_cd = np.asarray(j_flow_roundtrip(jnp.asarray(got["flow"]), jnp.asarray(back))[0])
        np.testing.assert_allclose(got["coord_diff"], ref_cd, rtol=0, atol=1e-5,
                                   err_msg=str(rel))


def test_compute_flow_refuses_without_checkpoint_or_card(tmp_path, frames, monkeypatch,
                                                         ckpt_dir):
    rgb_dir = tmp_path / "rgbs"
    _write_frames(rgb_dir, frames)
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(tmp_path / "none"))
    args = ["--rgb-dir", str(rgb_dir), "--save-dir", str(tmp_path / "out"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match=re.escape(
            "RAFT checkpoint not found; set PGDVS_CKPT_DIR with raft/models/raft-things.pth")):
        compute_flow.main(args)
    with pytest.raises(FileNotFoundError) as jerr:
        j_compute_scene_flows(rgb_dir, tmp_path / "jout")
    with pytest.raises(FileNotFoundError) as perr:
        compute_flow.compute_scene_flows(rgb_dir, tmp_path / "out", device="cpu")
    assert str(perr.value) == str(jerr.value)
    if not torch.cuda.is_available():
        monkeypatch.setenv("PGDVS_CKPT_DIR", str(ckpt_dir))
        with pytest.raises((RuntimeError, AssertionError)):
            compute_flow.main(args[:-2])
        assert not (tmp_path / "out" / "interval_1").exists()
