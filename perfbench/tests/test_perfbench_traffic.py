"""The traffic generators: one seed gives the same views, two seeds differ."""

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
# one thread per test process: the tests run in several workers at once
torch.set_num_threads(1)

from perfbench.harness.disk_scene import DiskScene  # noqa: E402
from perfbench.harness.scene import Scene  # noqa: E402

SMALL = dict(hw=(24, 32), n_frames=6, n_targets=4, n_spatial=3, device="cpu")


def _views(seed):
    return Scene(seed, **SMALL).targets


@pytest.mark.parametrize("key", ["rgb_src_spatial", "flat_cam_tgt", "flow_fwd", "noise",
                                 "time_tgt", "dyn_mask_src_temporal"])
def test_scene_same_seed_same_views(key):
    a, b = _views(2 ** 31 + 5), _views(2 ** 31 + 5)
    for va, vb in zip(a, b):
        assert torch.equal(va[key], vb[key])


@pytest.mark.parametrize("key", ["rgb_src_spatial", "flat_cam_tgt", "noise", "time_tgt"])
def test_scene_seeds_differ(key):
    a, b = _views(11), _views(12)
    assert not all(torch.equal(va[key], vb[key]) for va, vb in zip(a, b))


def test_scene_same_work_every_seed():
    """Every seed: the same number of targets and sources, the square whole in
    every frame (the same dynamic pixel count up to its edge pixels)."""
    counts = []
    for seed in (1, 2, 3, -7, 2 ** 33):
        views = Scene(seed, hw=(288, 550), n_frames=4, n_targets=2, n_spatial=3,
                      device="cpu").targets
        assert len(views) == 2
        counts += [float(v["dyn_mask_src_temporal"][0].sum()) for v in views]
    assert max(counts) - min(counts) <= 2 * 178 + 1
    assert 0.18 < min(counts) / (288 * 550) < 0.21


def test_scene_targets_between_frames():
    for v in _views(3):
        t = float(v["time_tgt"][0])
        t1, t2 = (float(x) for x in v["time_src_temporal"])
        assert t1 < t < t2


def test_disk_scene_same_seed_same_files(tmp_path):
    outs = []
    for k in range(2):
        root = tmp_path / f"s{k}"
        DiskScene(77, 5, (32, 48), (16, 24)).write(root, 95, 0.6, 77)
        outs.append({p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
                     if p.is_file()})
    assert outs[0] == outs[1]
    other = tmp_path / "o"
    DiskScene(78, 5, (32, 48), (16, 24)).write(other, 95, 0.6, 78)
    jpg = [p for p in outs[0] if p.suffix == ".jpg"][0]
    assert (other / jpg).read_bytes() != outs[0][jpg]


def test_disk_scene_layout(tmp_path):
    DiskScene(5, 5, (32, 48), (16, 24)).write(tmp_path, 95, 0.6, 5)
    dense = tmp_path / "nvidia_long/Balloon1/dense"
    assert len(list((dense / "mv_images").glob("*/cam*.jpg"))) == 5
    assert np.load(dense / "poses_bounds_cvd.npy").shape == (5, 17)
    flows = sorted((tmp_path / "nvidia_long_flow_mask/Balloon1/dense/flows/interval_2").glob("*"))
    assert len(flows) == 2 * 3
