"""Semantic "potentially dynamic" masks: OneFormer union + SAM segments.

Counterpart of ``pgdvs_tpu.preprocess.semantic_masks`` (the reference's
``compute_mask.py`` semantic mode, ``:71-127, 363-381, 726-761``): two
OneFormer semantic segmentations (ADE20K and COCO), each argmax'd with
low-confidence pixels marked invalid, unioned over the movable-class ID
lists, then fed with SAM everything-mode segments into ``combine_masks``.

The networks are HuggingFace ``transformers``' OneFormer DiNAT-L and SAM
ViT-H, imported when they are loaded; without ``transformers`` or without
the checkpoints in the local cache the CLI exits with the error instead
of writing masks. The aggregation that defines the output
(``semantic_scores_from_queries``: query masks x class probabilities,
``semantic_map_from_scores``: argmax and confidence threshold,
``semantic_dynamic_union``) is torch on the logits' device, the scores in
float64 as the JAX package's numpy computes them, then float32, so the
argmax and the 0.1 threshold fall on the same pixels. Frames are read
with ``data/image_io.read_rgb``.

  python -m pgdvs_tpu_torch.preprocess.semantic_masks --image-dir <dir> \\
      --out-dir <dir> [--no-sam] [--device cuda] [--allow-download]
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pgdvs_tpu_torch.data.image_io import read_rgb

# fmt: off
# Movable-class IDs, 1-indexed exactly as the reference lists them
# (compute_mask.py:70-127; the match subtracts 1 because the seg maps are
# 0-indexed).
DYNAMIC_IDS_ADE20K = [
    13,   # person
    21,   # car
    77,   # boat
    81,   # bus
    84,   # truck
    91,   # airplane
    93,   # dress/clothes
    103,  # van
    104,  # ship
    109,  # toy
    116,  # bag
    117,  # motorbike
    118,  # cradle
    120,  # ball
    127,  # animal
    128,  # bicycle
    140,  # fan
    150,  # flag
]
DYNAMIC_IDS_COCO = [
    1,   # person
    2,   # bicycle
    3,   # car
    4,   # motorcycle
    5,   # airplane
    6,   # bus
    7,   # train
    8,   # truck
    9,   # boat
    15,  # bird
    16,  # cat
    17,  # dog
    18,  # horse
    19,  # sheep
    20,  # cow
    21,  # elephant
    22,  # bear
    23,  # zebra
    24,  # giraffe
    26,  # umbrella
    31,  # ski
    32,  # snowboard
    37,  # skateboard
    38,  # surfboard
    39,  # tennis racket
]
# fmt: on

SEM_SEG_PROB_THRES = 0.1  # compute_mask.py:137


def semantic_scores_from_queries(class_queries_logits, masks_queries_logits) -> torch.Tensor:
    """Per-pixel class scores from query decompositions (MaskFormer-family
    semantic inference): softmax of each query's class logits without the
    trailing null class, times the sigmoid of its mask, summed over the
    queries: ``scores[c, h, w] = sum_q p_q(c) * sigma(m_q(h, w))``.

    class_queries_logits [Q, C+1], masks_queries_logits [Q, H, W] (tensors
    or numpy) -> [C, H, W] float32 on the class logits' device (computed
    in float64)."""
    cls = torch.as_tensor(class_queries_logits).double()
    msk = torch.as_tensor(masks_queries_logits, device=cls.device).double()
    p = torch.softmax(cls, dim=-1)[:, :-1]
    return torch.einsum("qc,qhw->chw", p, torch.sigmoid(msk)).float()


def semantic_map_from_scores(scores: torch.Tensor,
                             prob_thres: float = SEM_SEG_PROB_THRES) -> torch.Tensor:
    """argmax seg map [H, W] int64 (the first class on a tie) with the
    pixels whose best score is below ``prob_thres`` set to -1, so that they
    match no movable class (compute_mask.py:729-761)."""
    seg = torch.argmax(scores, dim=0)
    return torch.where(torch.amax(scores, dim=0) < prob_thres, torch.full_like(seg, -1), seg)


def semantic_dynamic_union(sem_seg_ade20k: torch.Tensor,
                           sem_seg_coco: torch.Tensor) -> torch.Tensor:
    """Union of the movable classes over both vocabularies (compute_mask.py:
    367-381; the lists are 1-indexed, the seg maps 0-indexed)."""
    def movable(seg, ids):
        return torch.isin(seg, torch.tensor([i - 1 for i in ids], device=seg.device))

    return movable(sem_seg_ade20k, DYNAMIC_IDS_ADE20K) | movable(sem_seg_coco, DYNAMIC_IDS_COCO)


def semantic_seg_from_queries(class_queries_logits, masks_queries_logits, hw,
                              prob_thres: float = SEM_SEG_PROB_THRES) -> torch.Tensor:
    """OneFormer's outputs of one image -> its [H, W] seg map: the scores,
    bilinearly resized (align_corners=False) to ``hw`` in float32, then the
    argmax and the threshold."""
    scores = semantic_scores_from_queries(class_queries_logits, masks_queries_logits)
    scores = F.interpolate(scores[None], size=tuple(hw), mode="bilinear",
                           align_corners=False)[0]
    return semantic_map_from_scores(scores, prob_thres)


# --------------------------------------------------------------------------
# transformers wiring (imported when a model is loaded)
# --------------------------------------------------------------------------

ONEFORMER_ADE20K = "shi-labs/oneformer_ade20k_dinat_large"
ONEFORMER_COCO = "shi-labs/oneformer_coco_dinat_large"
SAM_VIT_H = "facebook/sam-vit-huge"


def load_oneformer(model_name: str, local_only: bool = True, device="cuda"):
    """(model in eval mode on ``device``, processor); from the local cache
    only unless ``local_only`` is False."""
    from transformers import OneFormerForUniversalSegmentation, OneFormerProcessor

    proc = OneFormerProcessor.from_pretrained(model_name, local_files_only=local_only)
    model = OneFormerForUniversalSegmentation.from_pretrained(
        model_name, local_files_only=local_only).eval().to(device)
    return model, proc


def oneformer_semantic_seg(image_rgb: np.ndarray, model, processor,
                           prob_thres: float = SEM_SEG_PROB_THRES) -> torch.Tensor:
    """[H, W] int64 semantic map (-1 = low confidence) of one uint8 RGB
    image, on the model's device."""
    device = next(model.parameters()).device
    with torch.no_grad():
        inputs = processor(images=image_rgb, task_inputs=["semantic"], return_tensors="pt")
        out = model(**{k: v.to(device) if isinstance(v, torch.Tensor) else v
                       for k, v in inputs.items()})
        return semantic_seg_from_queries(out.class_queries_logits[0],
                                         out.masks_queries_logits[0], image_rgb.shape[:2],
                                         prob_thres)


def sam_everything_segments(image_rgb: np.ndarray, generator, min_area: int = 0) -> np.ndarray:
    """[N, H, W] bool segment stack from a transformers mask-generation
    pipeline (the reference's SamAutomaticMaskGenerator everything mode,
    compute_mask.py:619-640), area-sorted descending."""
    from transformers.image_transforms import to_pil_image

    out = generator(to_pil_image(image_rgb))
    masks = [np.asarray(m, bool) for m in out["masks"]]
    masks = [m for m in masks if m.sum() >= min_area]
    masks.sort(key=lambda m: int(m.sum()), reverse=True)
    if not masks:
        return np.zeros((0,) + image_rgb.shape[:2], bool)
    return np.stack(masks)


def main(argv: Optional[Sequence[str]] = None):
    """Produce the raw semantic masks + SAM stacks consumed by
    ``combine_masks.py``'s CLI: for each image writes ``<name>.npy``
    (movable-class union), ``<name>_sam.npy`` ([N, H, W] segments) and the
    two seg maps for inspection."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--ade20k-model", default=ONEFORMER_ADE20K)
    ap.add_argument("--coco-model", default=ONEFORMER_COCO)
    ap.add_argument("--sam-model", default=SAM_VIT_H)
    ap.add_argument("--no-sam", action="store_true")
    ap.add_argument("--prob-thres", type=float, default=SEM_SEG_PROB_THRES)
    ap.add_argument("--device", default="cuda", help="torch device (default the card)")
    ap.add_argument("--allow-download", action="store_true",
                    help="permit fetching checkpoints from the HF hub")
    args = ap.parse_args(argv)

    image_dir = pathlib.Path(args.image_dir)
    out_dir = pathlib.Path(args.out_dir)
    images = sorted(p for p in image_dir.iterdir()
                    if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if not images:
        raise SystemExit(f"no images under {image_dir}")

    local_only = not args.allow_download
    try:
        ade_model, ade_proc = load_oneformer(args.ade20k_model, local_only, args.device)
        coco_model, coco_proc = load_oneformer(args.coco_model, local_only, args.device)
        generator = None
        if not args.no_sam:
            from transformers import pipeline

            generator = pipeline("mask-generation", model=args.sam_model, device=args.device,
                                 model_kwargs={"local_files_only": local_only})
    except (ImportError, OSError, ValueError) as e:  # transformers or checkpoints missing
        raise SystemExit(
            f"OneFormer / SAM unavailable ({type(e).__name__}: {e}); install transformers "
            "and provision the HF cache, or pass --allow-download. Masks can instead be "
            "supplied precomputed.")

    out_dir.mkdir(parents=True, exist_ok=True)
    for img_path in images:
        rgb = read_rgb(img_path)
        seg_ade = oneformer_semantic_seg(rgb, ade_model, ade_proc, args.prob_thres)
        seg_coco = oneformer_semantic_seg(rgb, coco_model, coco_proc, args.prob_thres)
        union = semantic_dynamic_union(seg_ade, seg_coco).cpu().numpy()
        stem = img_path.stem
        np.save(out_dir / f"{stem}_semseg_ade20k.npy", seg_ade.cpu().numpy())
        np.save(out_dir / f"{stem}_semseg_coco.npy", seg_coco.cpu().numpy())
        np.save(out_dir / f"{stem}.npy", union)
        if generator is not None:
            np.save(out_dir / f"{stem}_sam.npy", sam_everything_segments(rgb, generator))
        print(f"{stem}: dynamic {union.mean():.3%}")


if __name__ == "__main__":
    main()
