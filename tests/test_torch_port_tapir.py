"""The port's TAPIR against the JAX package's flax TAPIR, on the CPU, module
by module and whole, from the same numpy inputs and the same weights.

A flax ``Tapir(num_pips_iter=2, num_mixer_blocks=2, mixer_hidden_dim=16)``
is initialised on a 32x32 clip of three frames (not at 256x256, which is
why the JAX package's own TAPIR tests are marked slow) and its params are
carried into the port by ``params_from_jax``. In order: the ResNet grids,
the query features, the cost-volume initialisation, one PIPs iteration, the
whole forward, at 32x32 (flax's asymmetric "SAME" padding at stride 2: 7x7
pads (2, 3), 3x3 (0, 1)) and at 30x46 (15x23 after the first conv, whose odd
sizes the 3x3 stride-2 convs pad (1, 1)); then ``TapirTracker(keep_raw_res=True)`` on 24x32
frames, the resize the 256x256 tracker applies, and the released haiku
checkpoint's loader against ``remap_haiku_params`` on a fake checkpoint of
the real architecture (tests/test_tapir.py builds it).

Tolerances (absolute): grids and query features 1e-5; tracks 1e-4 pixels,
occlusion and expected-distance logits 1e-4 (both sides run float32; the
largest differences seen are ~2.5e-5 px and ~1e-5). The tracker's
visibility may differ only where the port's score (1 - sigmoid(occ)) *
(1 - sigmoid(expd)) lies within 1e-4 of 0.5 (none does here). Chunked
tracking equals one call within 1e-4. On the fake haiku checkpoint, whose
unit-normal weights blow the activations up, the forwards agree within
1e-4 relative.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.models.tracking.tapir import Tapir as JTapir
from pgdvs_tpu.models.tracking.tapir import TapirTracker as JTapirTracker
from pgdvs_tpu.models.tracking.tapir_port import remap_haiku_params as j_remap
from pgdvs_tpu_torch.configs.benchmarks import make_tracker
from pgdvs_tpu_torch.core.interpolate import resize
from pgdvs_tpu_torch.models.tracking import LucasKanadeTracker
from pgdvs_tpu_torch.models.tracking.params_from_jax import tapir_state_dict
from pgdvs_tpu_torch.models.tracking.tapir import Tapir, TapirTracker
from pgdvs_tpu_torch.models.tracking.tapir_port import load_tapir_checkpoint, remap_haiku_params
from test_tapir import _fake_haiku_ckpt

KW = dict(num_pips_iter=2, num_mixer_blocks=2, mixer_hidden_dim=16)
T, NQ = 3, 8
FEAT_ATOL = 1e-5
TRACK_ATOL = 1e-4
LOGIT_ATOL = 1e-4
VIS_MARGIN = 1e-4
# the fake checkpoint's weights are unit normal, so activations grow by
# orders of magnitude through the network and its float32 error is relative
# (~6e-6 of tracks of 60-70 px)
CKPT_RTOL = 1e-4


def _clip(hw, seed=0, n=NQ):
    rng = np.random.default_rng(seed)
    video = rng.uniform(-1, 1, (T,) + hw + (3,)).astype(np.float32)
    q = np.stack([rng.integers(0, T, n), rng.uniform(0, hw[0] - 1, n),
                  rng.uniform(0, hw[1] - 1, n)], axis=-1).astype(np.float32)
    return video, q


@pytest.fixture(scope="module")
def models():
    jm = JTapir(**KW)
    video, q = _clip((32, 32))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(video), jnp.asarray(q))
    m = Tapir(**KW)
    m.load_state_dict(tapir_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m.eval()


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module", params=[(32, 32), (30, 46)], ids=["32x32", "30x46"])
def stages(request, models):
    """Each stage of both networks on the same clip, the port's stage fed
    its own previous stage (as the forward feeds it)."""
    jm, params, m = models
    hw = request.param
    video, q = _clip(hw, seed=1)
    tv, tq = torch.from_numpy(video), torch.from_numpy(q)
    out = {"hw": hw}
    with torch.no_grad():
        g = m.feature_grids(tv)
        jg = jm.apply(params, jnp.asarray(video), method=jm.feature_grids)
        qf = m.query_features(g, tq, hw)
        jqf = jm.apply(params, jg, jnp.asarray(q), hw, method=jm.query_features)
        cv = m.tracks_from_cost_volume(qf[1], g[1], tq, hw)
        jcv = jm.apply(params, jqf[1], jg[1], jnp.asarray(q), hw,
                       method=jm.tracks_from_cost_volume)
        pips = m.refine_pips(qf, g, *cv)
        jpips = jm.apply(params, jqf, jg, *jcv, method=jm.refine_pips)
        full = m(tv, tq)
        jfull = jm.apply(params, jnp.asarray(video), jnp.asarray(q))
        chunked = m(tv, tq, chunk=3)
    for name, got, ref in (("grids", g, jg), ("query_features", qf, jqf), ("cost_volume", cv, jcv),
                           ("pips", pips, jpips), ("forward", full, jfull)):
        out[name] = ([x.numpy() for x in got], [_np(x) for x in ref])
    out["chunked"] = [x.numpy() for x in chunked]
    return out


def test_tapir_feature_grids_match_jax(stages):
    h, w = stages["hw"]
    got, ref = stages["grids"]
    assert got[0].shape == (T, -(-h // 4), -(-w // 4), 128)
    assert got[1].shape == (T, -(-h // 8), -(-w // 8), 256)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=FEAT_ATOL)


def test_tapir_query_features_match_jax(stages):
    for a, b in zip(*stages["query_features"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=FEAT_ATOL)


@pytest.mark.parametrize("stage", ["cost_volume", "pips", "forward"])
def test_tapir_tracks_and_logits_match_jax(stages, stage):
    """Tracks [N, T, 2], occlusion and expected-distance logits [N, T] (and
    the PIPs iteration's features [N, T, 384])."""
    got, ref = stages[stage]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=TRACK_ATOL)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL)


def test_cost_volume_init_reproduces_query_points(stages):
    _, q = _clip(stages["hw"], seed=1)
    pts = stages["cost_volume"][0][0]
    np.testing.assert_allclose(pts[np.arange(NQ), q[:, 0].astype(int)], q[:, [2, 1]], atol=1e-6)


def test_tapir_chunked_equals_one_call(stages):
    for a, b in zip(stages["chunked"], stages["forward"][0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TRACK_ATOL)


def test_tapir_tracker_matches_jax(models):
    """keep_raw_res on 24x32 frames in [0, 1], queries (t, x, y), the last
    two invalid."""
    jm, params, m = models
    rng = np.random.default_rng(2)
    frames = rng.uniform(0, 1, (T, 24, 32, 3)).astype(np.float32)
    n = NQ
    q = np.stack([rng.integers(0, T, n), rng.uniform(0, 31, n), rng.uniform(0, 23, n)],
                 axis=-1).astype(np.float32)
    valid = np.arange(n) < n - 2
    ref_tracks, ref_vis = JTapirTracker(params=params, model=jm, keep_raw_res=True)(
        jnp.asarray(frames), jnp.asarray(q), jnp.asarray(valid))
    tracker = TapirTracker(m, keep_raw_res=True)
    tracks, vis = tracker(torch.from_numpy(frames), torch.from_numpy(q), torch.from_numpy(valid))
    np.testing.assert_allclose(tracks.numpy(), _np(ref_tracks), rtol=0, atol=TRACK_ATOL)
    video = torch.from_numpy(frames) * 2 - 1
    qq = torch.from_numpy(q[:, [0, 2, 1]])
    with torch.no_grad():
        _, occ, expd = m(video, qq)
    score = ((1 - torch.sigmoid(occ)) * (1 - torch.sigmoid(expd))).numpy()
    flips = vis.numpy() != _np(ref_vis)
    assert not (flips & (np.abs(score - 0.5) >= VIS_MARGIN)).any()
    assert not vis.numpy()[~valid].any()


def test_tapir_resize_matches_jax():
    """The 256x256 tracker's input: ``jax.image.resize(..., "bilinear")``
    (antialiased when it shrinks) against the port's linear resize."""
    frames = np.random.default_rng(3).uniform(0, 1, (2, 300, 550, 3)).astype(np.float32)
    ref = _np(jax.image.resize(jnp.asarray(frames), (2, 256, 256, 3), "bilinear"))
    flat = torch.from_numpy(frames).permute(1, 2, 0, 3).reshape(300, 550, 6)
    got = resize(flat, 256, 256, "linear").reshape(256, 256, 2, 3).permute(2, 0, 1, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def haiku_ckpt():
    return _fake_haiku_ckpt()


def test_haiku_loader_matches_jax_remap(haiku_ckpt, tmp_path, monkeypatch, caplog):
    """The fake checkpoint of the real architecture (12 mixer blocks, 512
    wide), saved as the released .npy under $PGDVS_CKPT_DIR: the port's
    loader and JAX's remap each load it, and the forwards agree."""
    path = tmp_path / "tapnet" / "tapir_checkpoint_panning.npy"
    path.parent.mkdir()
    np.save(path, {"params": haiku_ckpt}, allow_pickle=True)
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(tmp_path))
    with caplog.at_level(logging.WARNING):
        tracker = make_tracker("tapir_raw_res", device="cpu")
    assert not caplog.records and tracker.keep_raw_res
    sd = load_tapir_checkpoint()
    assert sorted(sd) == sorted(Tapir().state_dict())
    video, q = _clip((32, 32), seed=4)
    jm = JTapir()
    ref = jm.apply({"params": j_remap(haiku_ckpt)}, jnp.asarray(video), jnp.asarray(q))
    with torch.no_grad():
        got = tracker.model(torch.from_numpy(video), torch.from_numpy(q))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=CKPT_RTOL, atol=TRACK_ATOL)


def test_haiku_loader_lists_every_unmatched_entry(haiku_ckpt):
    bad = dict(haiku_ckpt)
    bad["tapir/~/mystery_head"] = {"w": np.zeros((2, 2), np.float32)}
    bad["tapir/~/occlusion_out"] = {**bad["tapir/~/occlusion_out"],
                                    "gamma": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="(?s)mystery_head.*occlusion_out:gamma"):
        remap_haiku_params(bad)


def test_make_tracker_names(monkeypatch, tmp_path, caplog):
    """None / "none" -> no tracker, "lk" -> LK; without a checkpoint TAPIR
    warns and takes the same seeded random weights every time; CoTracker
    raises naming its ROADMAP item; any other name KeyError; TAPIR goes
    on the card unless the CPU is asked for."""
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(tmp_path))
    assert make_tracker(None) is None and make_tracker("none") is None
    assert isinstance(make_tracker("lk"), LucasKanadeTracker)
    with caplog.at_level(logging.WARNING):
        a, b = make_tracker("tapir", device="cpu"), make_tracker("tapir", device="cpu")
    assert any("random" in r.getMessage() for r in caplog.records)
    assert not a.keep_raw_res
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    # without a device the trackers are built on the card, as Evaluator's
    # renders run (an entry point runs on the CPU only when asked)
    moved = []
    monkeypatch.setattr(TapirTracker, "to", lambda self, device: moved.append(device) or self)
    make_tracker("tapir")
    make_tracker("tapir_raw_res", device="cpu")
    assert moved == ["cuda", "cpu"]
    with pytest.raises(ValueError, match="ROADMAP.md.*CoTracker"):
        make_tracker("cotracker")
    with pytest.raises(KeyError):
        make_tracker("tapir_v2")
