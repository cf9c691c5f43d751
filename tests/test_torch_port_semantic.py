"""The port's semantic-mask aggregation against the JAX package's, on the
CPU: OneFormer-style query decompositions (seeded class and mask logits)
through ``semantic_scores_from_queries`` (float32 scores within 1e-6
relative), ``semantic_map_from_scores`` and ``semantic_dynamic_union``
(equal, excusing only pixels whose float64 scores lie within 1e-9 of a tie
or of the 0.1 threshold; each case holds a class that ties another but
for one query, ~4e-7 apart where that query dominates, and pixels 1e-6
above and below the threshold, which must agree),
the upsampled seg maps of ``oneformer_semantic_seg`` with a stand-in model
and processor, the SAM segment stacks with a stand-in generator, the ID
lists, and the CLI's refusals: no images, no ``transformers``, no
checkpoint in the local cache (``local_files_only``, the hub switched
offline; nothing is downloaded) — it exits with the error and writes no
mask.
"""

import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pgdvs_tpu.preprocess import semantic_masks as jsem
from pgdvs_tpu_torch.data.image_io import write_png
from pgdvs_tpu_torch.preprocess import semantic_masks as sem

TIE_EXCUSE = 1e-9


def _scores64(cls, msk):
    """The JAX package's float64 scores, before its float32 cast."""
    c = cls.astype(np.float64)
    p = np.exp(c - c.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True))[:, :-1]
    return np.einsum("qc,qhw->chw", p, 1.0 / (1.0 + np.exp(-msk.astype(np.float64))))


def _logits(seed, q, c, hw):
    """Seeded logits. Class 1 is a copy of class 0 (raised to lead at many
    pixels) but for one query's logit, 2 float32 ulps higher: wherever
    they lead, they lead by a near-tie, ~4e-7 at pixel (0, 0), where that
    query's mask dominates.
    Pixels (0, 1) / (0, 2) hold 0.1 + / - 1e-6 (every query's mask logit
    there set to one value)."""
    rng = np.random.default_rng(seed)
    cls = rng.normal(0, 2, (q, c + 1)).astype(np.float32)
    msk = rng.normal(0, 3, (q,) + hw).astype(np.float32)
    cls[:, 0] += 1.5
    cls[0, 0] = cls[0].max() + 3.0
    cls[:, 1] = cls[:, 0]
    cls[0, 1] = np.nextafter(np.nextafter(cls[0, 1], np.float32(np.inf)), np.float32(np.inf))
    msk[:, 0, 0] = -20.0
    msk[0, 0, 0] = 5.0
    p = np.exp(cls.astype(np.float64))
    best = (p / p.sum(-1, keepdims=True))[:, :-1].sum(0).max()
    for col, target in ((1, 0.1 + 1e-6), (2, 0.1 - 1e-6)):
        msk[:, 0, col] = np.float32(np.log(target / (best - target)))
    return cls, msk


def _agree(got, ref, s64, thres=sem.SEM_SEG_PROB_THRES):
    """got == ref except where the float64 scores sit within TIE_EXCUSE of a
    tie of the top two or of the threshold."""
    top2 = np.sort(s64, axis=0)[-2:]
    excused = ((top2[1] - top2[0]) <= TIE_EXCUSE) | (np.abs(top2[1] - thres) <= TIE_EXCUSE)
    np.testing.assert_array_equal(np.where(excused, 0, got), np.where(excused, 0, ref))
    return excused


@pytest.mark.parametrize("q,c,hw", [(20, 10, (24, 32)), (100, 150, (12, 16)),
                                    (100, 133, (12, 16))], ids=["small", "ade20k", "coco"])
def test_aggregation_matches_jax(q, c, hw):
    cls, msk = _logits(q + c, q, c, hw)
    ref_scores = jsem.semantic_scores_from_queries(cls, msk)
    got_scores = sem.semantic_scores_from_queries(torch.from_numpy(cls), torch.from_numpy(msk))
    assert got_scores.dtype == torch.float32 and got_scores.shape == (c,) + hw
    np.testing.assert_allclose(got_scores.numpy(), ref_scores, rtol=1e-6, atol=0)

    s64 = _scores64(cls, msk)
    assert set(np.argsort(s64[:, 0, 0])[-2:]) == {0, 1}
    assert 1e-7 < s64[1, 0, 0] - s64[0, 0, 0] < 1e-6
    assert s64[:, 0, 1].max() > 0.1 > s64[:, 0, 2].max()
    ref_map = jsem.semantic_map_from_scores(ref_scores)
    got_map = sem.semantic_map_from_scores(got_scores).numpy()
    assert got_map.dtype == np.int64
    excused = _agree(got_map, ref_map, s64)
    assert not excused[0, :3].any() and got_map[0, 2] == -1 and got_map[0, 1] >= 0
    assert got_map[0, 0] == 1 and ((got_map == 1) | (got_map == 0)).sum() > 10
    assert (got_map == -1).any() and (got_map >= 0).any()

    other = np.roll(ref_map, 1, axis=1)
    np.testing.assert_array_equal(
        sem.semantic_dynamic_union(torch.from_numpy(got_map), torch.from_numpy(other)).numpy(),
        jsem.semantic_dynamic_union(ref_map, other))


def test_union_on_every_id_matches_jax():
    """Every ADE20K / COCO index, -1 and an off-by-one neighbour."""
    ade = np.arange(-1, 151).reshape(8, 19)
    coco = np.arange(-1, 151)[::-1].copy().reshape(8, 19)
    got = sem.semantic_dynamic_union(torch.from_numpy(ade), torch.from_numpy(coco)).numpy()
    ref = jsem.semantic_dynamic_union(ade, coco)
    assert got.dtype == bool and ref.any() and not ref.all()
    np.testing.assert_array_equal(got, ref)


def test_id_lists_equal_jax():
    assert sem.DYNAMIC_IDS_ADE20K == jsem.DYNAMIC_IDS_ADE20K
    assert sem.DYNAMIC_IDS_COCO == jsem.DYNAMIC_IDS_COCO
    assert sem.SEM_SEG_PROB_THRES == jsem.SEM_SEG_PROB_THRES == 0.1
    assert (sem.ONEFORMER_ADE20K, sem.ONEFORMER_COCO, sem.SAM_VIT_H) == (
        jsem.ONEFORMER_ADE20K, jsem.ONEFORMER_COCO, jsem.SAM_VIT_H)


class _StandInOneFormer(torch.nn.Module):
    """Returns fixed query logits whatever the image (the real model's
    output fields); one parameter tells the port its device."""

    def __init__(self, cls, msk):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.cls, self.msk = torch.from_numpy(cls)[None], torch.from_numpy(msk)[None]
        self.seen = []

    def forward(self, pixel_values, task_inputs):
        self.seen.append((tuple(pixel_values.shape), task_inputs))
        return types.SimpleNamespace(class_queries_logits=self.cls,
                                     masks_queries_logits=self.msk)


def _stand_in_processor(images, task_inputs, return_tensors):
    assert task_inputs == ["semantic"] and return_tensors == "pt"
    img = torch.from_numpy(np.asarray(images, np.float32)).permute(2, 0, 1)[None]
    return {"pixel_values": F.interpolate(img, size=(32, 32)),
            "task_inputs": torch.zeros(1, 7, dtype=torch.long)}


def test_oneformer_semantic_seg_matches_jax():
    """The model's outputs -> scores -> bilinear resize to the image ->
    map, with a stand-in model and processor on both packages."""
    cls, msk = _logits(5, 30, 150, (20, 28))
    image = np.random.default_rng(1).integers(0, 255, (80, 110, 3)).astype(np.uint8)
    model = _StandInOneFormer(cls, msk)
    ref = jsem.oneformer_semantic_seg(image, model, _stand_in_processor)
    got = sem.oneformer_semantic_seg(image, model, _stand_in_processor)
    assert got.shape == (80, 110) and model.seen[0][0] == model.seen[1][0] == (1, 3, 32, 32)
    s64 = F.interpolate(torch.from_numpy(_scores64(cls, msk))[None], size=(80, 110),
                        mode="bilinear", align_corners=False)[0].numpy()
    _agree(got.numpy(), ref, s64)
    assert (ref == -1).any() and (ref >= 0).any()


def test_sam_segments_match_jax():
    """A stand-in mask generator: thresholds of the red channel; the
    stacks, area order and min_area filter as JAX's."""
    image = np.random.default_rng(2).integers(0, 255, (30, 40, 3)).astype(np.uint8)

    def generator(pil_image):
        red = np.asarray(pil_image)[..., 0]
        return {"masks": [red > t for t in (200, 50, 250, 120)]}

    for min_area in (0, 100):
        ref = jsem.sam_everything_segments(image, generator, min_area=min_area)
        got = sem.sam_everything_segments(image, generator, min_area=min_area)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, ref)
    empty = sem.sam_everything_segments(image, lambda _: {"masks": []})
    assert empty.shape == (0, 30, 40)


@pytest.fixture
def offline_hub(tmp_path, monkeypatch):
    """An empty HF cache, the hub offline: nothing can be fetched."""
    for var in ("HF_HOME", "HF_HUB_CACHE", "TRANSFORMERS_CACHE"):
        monkeypatch.setenv(var, str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    write_png(img_dir / "00000.png", np.zeros((8, 12, 3), np.uint8))
    return img_dir


def test_cli_refuses_without_checkpoints(offline_hub, tmp_path):
    out = tmp_path / "masks"
    args = ["--image-dir", str(offline_hub), "--out-dir", str(out), "--device", "cpu"]
    with pytest.raises(SystemExit, match="OneFormer / SAM unavailable"):
        sem.main(args)
    with pytest.raises(SystemExit, match="OneFormer / SAM unavailable"):
        sem.main(args + ["--no-sam"])
    assert not out.exists() or not list(out.iterdir())
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no images"):
        sem.main(["--image-dir", str(empty), "--out-dir", str(out)])


def test_cli_refuses_without_transformers(offline_hub, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    out = tmp_path / "masks"
    with pytest.raises(SystemExit, match="import of transformers halted"):
        sem.main(["--image-dir", str(offline_hub), "--out-dir", str(out), "--device", "cpu"])
    assert not out.exists()
