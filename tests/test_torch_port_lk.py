"""The port's pyramidal Lucas-Kanade tracker against the JAX package's, on
the CPU, from the same numpy inputs: five frames of the synthetic scene at
32x48 (a moving camera and the moving square), 300 queries at random
positions (some past the border) on random home frames, a tenth of them
invalid.

Tracks agree within 1e-3 pixels (the chains run the same float32 ops; the
largest difference seen is ~9e-5). A visibility may differ only where the
port's windowed photometric error lies within VIS_MARGIN of
``vis_err_thres`` or its position within 1e-3 of the image's edge (none
does at these seeds). Chunking the queries changes nothing: the port's
chunked call equals its one call bit for bit, and tracking only the valid
queries, compacted, gives their rows of the uncompacted call.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.data import synthetic
from pgdvs_tpu.models.tracking import LucasKanadeTracker as JLucasKanadeTracker
from pgdvs_tpu_torch.models.tracking import LucasKanadeTracker
from pgdvs_tpu_torch.models.tracking.lk import _sample_window, _to_gray, _window_offsets

H, W, T, N = 32, 48, 5, 300
TRACK_ATOL = 1e-3
VIS_MARGIN = 1e-4


@contextlib.contextmanager
def one_thread():
    """The port's LK is thousands of small ops: on one thread they do not
    wait on a pool that parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    times = np.linspace(0.3, 0.7, T)
    frames = np.stack([synthetic.render_frame(H, W, synthetic.camera_pose(i + 1, 10),
                                              times[i])["rgb"] for i in range(T)])
    rng = np.random.default_rng(0)
    queries = np.stack([rng.integers(0, T, N), rng.uniform(-1, W, N),
                        rng.uniform(-1, H, N)], axis=-1).astype(np.float32)
    valid = rng.random(N) > 0.1
    return frames.astype(np.float32), queries, valid


@pytest.fixture(scope="module")
def runs(clip):
    frames, queries, valid = clip
    ref = JLucasKanadeTracker()(jnp.asarray(frames), jnp.asarray(queries), jnp.asarray(valid))
    with one_thread():
        got = LucasKanadeTracker()(torch.from_numpy(frames), torch.from_numpy(queries),
                                   torch.from_numpy(valid))
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_lk_tracks_match_jax(runs):
    (ref_tracks, _), (tracks, _) = runs
    assert tracks.shape == ref_tracks.shape == (N, T, 2)
    np.testing.assert_allclose(tracks, ref_tracks, rtol=0, atol=TRACK_ATOL)


def test_lk_visibles_match_jax(clip, runs):
    """Flips only within VIS_MARGIN of the threshold or at the edge."""
    frames, queries, valid = clip
    (_, ref_vis), (tracks, vis) = runs
    assert vis.dtype == bool and 0.3 < vis.mean() < 0.9
    gray = _to_gray(torch.from_numpy(frames))
    ox, oy = _window_offsets(LucasKanadeTracker.radius, "cpu")
    home = queries[:, 0].astype(int)
    home_patch = torch.stack([
        _sample_window(gray[t], torch.tensor(queries[i:i + 1, 1]),
                       torch.tensor(queries[i:i + 1, 2]), ox, oy)[0]
        for i, t in enumerate(home)])
    excused = np.zeros_like(vis)
    for t in range(T):
        pos = torch.from_numpy(tracks[:, t])
        err = torch.mean(torch.abs(_sample_window(gray[t], pos[:, 0], pos[:, 1], ox, oy)
                                   - home_patch), dim=1).numpy()
        near_thres = np.abs(err - LucasKanadeTracker.vis_err_thres) < VIS_MARGIN
        edge = np.abs(np.stack([tracks[:, t, 0], tracks[:, t, 0] - (W - 1),
                                tracks[:, t, 1], tracks[:, t, 1] - (H - 1)])).min(0) < 1e-3
        excused[:, t] = near_thres | edge
    flips = vis != ref_vis
    assert not (flips & ~excused).any(), np.argwhere(flips & ~excused)
    assert not vis[~valid].any()
    assert vis[np.arange(N), home][valid].all()


def test_lk_compacted_and_chunked_equal_one_call(clip, runs):
    frames, queries, valid = clip
    _, (tracks, vis) = runs
    tracker = LucasKanadeTracker(query_chunk_size=37)
    with one_thread():
        t_c, v_c = tracker(torch.from_numpy(frames), torch.from_numpy(queries[valid]))
    np.testing.assert_array_equal(t_c.numpy(), tracks[valid])
    np.testing.assert_array_equal(v_c.numpy(), vis[valid])
