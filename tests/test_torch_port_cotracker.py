"""The port's CoTracker against the JAX package's flax CoTracker, on the CPU,
at the published widths (128-channel encoder, 384 wide, 6 time + 6 space
blocks, S = 8, stride 4) and tiny inputs, from the same numpy inputs and the
same weights: ``init_cotracker_weights`` (seed 0, the update head damped)
exported in the reference's key layout and carried into flax by the JAX
package's own ``port_cotracker``. The port runs on one torch thread.

Tolerances (absolute; both sides float32):
  * the embeddings 1e-5 (positions up to 40: an ulp of a frequency, which
    XLA's pow and torch's may round apart, moves a phase of 40 rad by
    ~4e-6; ~3.8e-6 seen), the support grid equal;
  * the encoder on 2x64x96 frames 5e-5 (features up to ~2; ~5e-6 seen);
  * ``UpdateFormer`` on [12, 8, 456] 1e-6 (the damped head's output is
    ~3e-2; ~3e-8 seen);
  * one ``window`` (two refinements, mixed first frames): coordinates 1e-4
    px, vis logits 1e-4;
  * the windowed forward at T = 10 (two windows, first frames in both; the
    32x48 frames give a 1x1 last pyramid level): the zero-trajectory
    positions equal, coordinates 1e-4 px, logits 1e-4 (~2e-6 and ~5e-6
    seen);
  * ``CoTrackerTracker(chunk=None)`` against ``_cotracker_track`` at
    ``interp_hw=(64, 96)``, ``iters=2``, T = 10: tracks 1e-4 px (~4e-6
    seen), visibility equal (about half the tracks visible).

The chunked tracker equals one-set calls on each chunk's valid rows, and a
chunk as large as the valid rows equals one set on them, bit for bit (the
same computation on the same shapes). ``cotracker_state_dict`` on the flax
tree equals ``load_cotracker_checkpoint`` on the ``.pth`` written with
``torch.save``, and so do their forwards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.models.tracking import cotracker as jct
from pgdvs_tpu.models.tracking.cotracker_port import port_cotracker
from pgdvs_tpu_torch.models.tracking import cotracker as tct
from pgdvs_tpu_torch.models.tracking.cotracker import (CoTrackerModel, CoTrackerTracker,
                                                        init_cotracker_weights)
from pgdvs_tpu_torch.models.tracking.cotracker_port import load_cotracker_checkpoint
from pgdvs_tpu_torch.models.tracking.params_from_jax import cotracker_state_dict
from test_torch_port_lk import one_thread

EMB_ATOL = 1e-5
ENC_ATOL = 5e-5
UF_ATOL = 1e-6
COORD_ATOL = 1e-4
LOGIT_ATOL = 1e-4
T, HW = 10, (24, 32)
INTERP = (64, 96)
ITERS = 2


# the seeded weights' vis logits lie near 0.5 after two refinements, all
# below the threshold's logit(0.9) = 2.197: the head's bias is raised so
# that about half the test clip's tracks are visible and the threshold is
# exercised both ways
VIS_BIAS_SHIFT = 1.7


@pytest.fixture(scope="module")
def models():
    model = init_cotracker_weights(CoTrackerModel(), seed=0).eval()
    with torch.no_grad():
        model.vis_predictor[0].bias += VIS_BIAS_SHIFT
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = {"params": jax.tree_util.tree_map(jnp.asarray, port_cotracker(sd))}
    return model, jct.CoTrackerModel(), params


def _queries(n, t_n, hw, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, t_n, n), rng.uniform(1, hw[1] - 2, n),
                     rng.uniform(1, hw[0] - 2, n)], axis=-1).astype(np.float32)


def test_embeddings_match_jax():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-3, 40, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(tct.sincos_pos_embed_1d(456, torch.from_numpy(pos)).numpy(),
                               np.asarray(jct.sincos_pos_embed_1d(456, jnp.asarray(pos))),
                               rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(tct.sincos_pos_embed_2d(456, 6, 9).numpy(),
                               np.asarray(jct.sincos_pos_embed_2d(456, 6, 9)), rtol=0,
                               atol=EMB_ATOL)
    xy = rng.normal(scale=4.0, size=(3, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tct.embedding_2d_interleaved(torch.from_numpy(xy), 64).numpy(),
        np.asarray(jct.embedding_2d_interleaved(jnp.asarray(xy), 64)), rtol=0, atol=EMB_ATOL)
    for g, hw in ((6, (384, 512)), (6, INTERP), (3, (24, 32))):
        np.testing.assert_array_equal(tct.support_grid_points(g, hw),
                                      jct._support_grid_points(g, hw))


def test_encoder_matches_jax(models):
    model, jm, params = models
    frames = np.random.default_rng(1).uniform(0, 255, (2, 64, 96, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, f: jm.apply(p, f, method=jm.encode))(
        params, jnp.asarray(frames)))
    with one_thread(), torch.no_grad():
        got = model.encode(torch.from_numpy(frames)).numpy()
    assert got.shape == ref.shape == (2, 16, 24, 128)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ENC_ATOL)


def test_updateformer_matches_jax(models):
    model, _, params = models
    x = np.random.default_rng(2).normal(size=(12, 8, 456)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jct.UpdateFormerF().apply(p, v))(
        {"params": params["params"]["updateformer"]}, jnp.asarray(x)))
    with one_thread(), torch.no_grad():
        got = model.updateformer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=UF_ATOL)


def test_window_matches_jax(models):
    """One window, two refinements, on random feature maps; points whose
    first frames lie before, inside and after the window, carried
    coordinates and raw vis logits for those started before it."""
    model, jm, params = models
    rng = np.random.default_rng(3)
    s, n, (h8, w8) = 8, 10, (16, 24)
    fmaps = rng.normal(size=(s, h8, w8, 128)).astype(np.float32)
    coords = np.stack([rng.uniform(0, w8 - 1, (s, n)), rng.uniform(0, h8 - 1, (s, n))],
                      axis=-1).astype(np.float32)
    feat = np.broadcast_to(rng.normal(size=(1, n, 128)), (s, n, 128)).astype(np.float32)
    first = np.array([-3, -1, 0, 0, 2, 3, 5, 7, 9, 12], np.float32)
    vis_init = np.where(first[None, :, None] < 0, rng.normal(size=(s, n, 1)) * 3,
                        10.0).astype(np.float32)
    tgrid = np.arange(s, dtype=np.float32)[:, None]
    track_mask = ((tgrid >= first[None]) & (tgrid >= np.where(first < 0, 4.0, 0.0)[None]))
    args = (fmaps, coords, feat, vis_init, track_mask.astype(np.float32)[..., None])
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, ITERS, method=jm.window))(
        params, *map(jnp.asarray, args))
    with one_thread(), torch.no_grad():
        got = model.window(*map(torch.from_numpy, args), ITERS)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=COORD_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=LOGIT_ATOL)


def test_forward_matches_jax(models):
    """The windowed forward at T = 10 (windows at 0 and 4, the second's
    tail frames repeating the last): first frames in both windows, so the
    carry, the track mask and the commit rule all run."""
    model, jm, params = models
    frames = np.random.default_rng(4).uniform(0, 255, (T, 32, 48, 3)).astype(np.float32)
    q = _queries(16, T, (32, 48), seed=5)
    assert (q[:, 0] < 4).any() and (q[:, 0] >= 8).any()
    ref = jax.jit(lambda p, f, qq: jm.apply(p, f, qq, iters=ITERS))(
        params, jnp.asarray(frames), jnp.asarray(q))
    ref = [np.asarray(r) for r in ref]
    with one_thread(), torch.no_grad():
        got = [g.numpy() for g in model(torch.from_numpy(frames), torch.from_numpy(q),
                                        iters=ITERS)]
    np.testing.assert_array_equal(got[0] == 0.0, ref[0] == 0.0)
    assert (ref[0] == 0.0).any() and (ref[0] != 0.0).any()
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=COORD_ATOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=LOGIT_ATOL)


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(6)
    frames = rng.uniform(0, 1, (T,) + HW + (3,)).astype(np.float32)
    return frames, _queries(24, T, HW, seed=7)


def test_tracker_one_set_matches_jax(models, clip):
    model, _, params = models
    frames, q = clip
    valid = np.arange(q.shape[0]) % 3 != 0  # ignored by the one-set tracker
    ref_tr, ref_vis = (np.asarray(r) for r in jct._cotracker_track(
        params, jnp.asarray(frames), jnp.asarray(q), 8, 4, ITERS, INTERP, 6, 0.9))
    tracker = CoTrackerTracker(model, chunk=None, iters=ITERS, interp_hw=INTERP)
    assert tracker.one_set
    with one_thread():
        tr, vis = tracker(torch.from_numpy(frames), torch.from_numpy(q),
                          torch.from_numpy(valid))
    assert tr.shape == (24, T, 2) and vis.dtype == torch.bool
    np.testing.assert_allclose(tr.numpy(), ref_tr, rtol=0, atol=COORD_ATOL)
    assert (tr.numpy() >= 0).all() and 0 < ref_vis.mean() < 1
    np.testing.assert_array_equal(vis.numpy(), ref_vis)


def test_chunks_equal_one_set_calls(models, clip):
    """chunk=k tracks the valid rows in consecutive chunks of k (the last
    one short), each with the support grid: equal to one-set calls on each
    chunk's valid rows; invalid rows zero and invisible; a chunk as large as
    the valid rows equals one set on them."""
    model, _, _ = models
    frames, q = clip
    frames, q = torch.from_numpy(frames), torch.from_numpy(q)
    valid = torch.from_numpy(np.random.default_rng(8).uniform(size=q.shape[0]) < 0.7)
    rows = torch.nonzero(valid)[:, 0]
    kw = dict(iters=1, interp_hw=INTERP)
    with one_thread():
        tr, vis = CoTrackerTracker(model, chunk=6, **kw)(frames, q, valid)
        one = CoTrackerTracker(model, **kw)
        for i in range(0, rows.numel(), 6):
            sel = rows[i:i + 6]
            ref_tr, ref_vis = one(frames, q[sel])
            assert torch.equal(tr[sel], ref_tr) and torch.equal(vis[sel], ref_vis)
        big = CoTrackerTracker(model, chunk=rows.numel(), **kw)(frames, q, valid)
        whole = one(frames, q[rows])
    assert rows.numel() % 6 and not tr[~valid].any() and not vis[~valid].any()
    assert torch.equal(big[0][rows], whole[0]) and torch.equal(big[1][rows], whole[1])
    assert not CoTrackerTracker(model, chunk=6).one_set


def test_params_from_jax_match_the_pth_loader(models, tmp_path, monkeypatch):
    """The flax tree carried by cotracker_state_dict and the .pth read by
    load_cotracker_checkpoint (from $PGDVS_CKPT_DIR, a "model" wrapper
    unwrapped) give equal state dicts and equal forwards; no file, None."""
    model, _, params = models
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(tmp_path))
    assert load_cotracker_checkpoint() is None
    path = tmp_path / "cotracker" / "cotracker_stride_4_wind_8.pth"
    path.parent.mkdir()
    torch.save({"model": model.state_dict()}, path)
    loaded = load_cotracker_checkpoint()
    bridged = cotracker_state_dict(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(loaded) == sorted(bridged) == sorted(model.state_dict())
    for k, v in loaded.items():
        assert torch.equal(v, bridged[k]), k
    frames = np.random.default_rng(9).uniform(0, 255, (4, 32, 48, 3)).astype(np.float32)
    q = _queries(6, 4, (32, 48), seed=10)
    outs = []
    for sd in (loaded, bridged):
        m = CoTrackerModel()
        m.load_state_dict(sd)
        with one_thread(), torch.no_grad():
            outs.append(m(torch.from_numpy(frames), torch.from_numpy(q), iters=1))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
