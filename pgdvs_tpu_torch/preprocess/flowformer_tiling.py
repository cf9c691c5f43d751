"""FlowFormer-protocol tiled flow inference (model-agnostic).

Counterpart of ``pgdvs_tpu.preprocess.flowformer_tiling`` (the reference's
FlowFormer driver math, ``pgdvs/preprocess/compute_flow.py:61-212``): the
released FlowFormer weights are trained at a fixed 432x960 patch size, so
large frames are processed as overlapping patches blended with a centred
Gaussian weight map, and small frames are resized up to the train size
(the flow scaled back). The grid, the weights and the blending are numpy,
as in the JAX package; ``adaptive_flow`` resizes through
``core.interpolate.resize`` ("cubic", then "linear"), which is
``jax.image.resize``'s cubic and bilinear.

The flow model is any ``model_fn(img1, img2) -> flow`` over [H, W, 3]
float images (``RAFTFlow.one_way``, or another model); its flow may be a
numpy array or a tensor on any device.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from pgdvs_tpu_torch.core.interpolate import resize

FLOWFORMER_TRAIN_SIZE = (432, 960)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def compute_grid_indices(
    image_shape: Tuple[int, int],
    patch_size: Tuple[int, int] = FLOWFORMER_TRAIN_SIZE,
    min_overlap: int = 20,
) -> list:
    """Top-left corners of overlapping patches covering the image (the
    reference's compute_grid_indices; the last patch flush with the
    border)."""
    if min_overlap >= patch_size[0] or min_overlap >= patch_size[1]:
        raise ValueError(
            f"Overlap should be less than size of patch (got {min_overlap}"
            f" for patch size {patch_size})."
        )
    if image_shape[0] == patch_size[0]:
        hs = list(range(0, image_shape[0], patch_size[0]))
    else:
        hs = list(range(0, image_shape[0], patch_size[0] - min_overlap))
    if image_shape[1] == patch_size[1]:
        ws = list(range(0, image_shape[1], patch_size[1]))
    else:
        ws = list(range(0, image_shape[1], patch_size[1] - min_overlap))
    hs[-1] = image_shape[0] - patch_size[0]
    ws[-1] = image_shape[1] - patch_size[1]
    return [(h, w) for h in hs for w in ws]


def compute_adaptive_image_size(image_size: Tuple[int, int]):
    """(w, h) resize target and scale for frames smaller than the train
    size (the reference's compute_adaptive_image_size; note the (w, h))."""
    target = FLOWFORMER_TRAIN_SIZE
    scale = max(target[0] / image_size[0], target[1] / image_size[1])
    return (int(image_size[1] * scale), int(image_size[0] * scale)), scale


def gaussian_patch_weight(
    patch_size: Tuple[int, int] = FLOWFORMER_TRAIN_SIZE, sigma: float = 1.0
) -> np.ndarray:
    """Centred Gaussian blending weight over one patch (compute_weight)."""
    h, w = np.meshgrid(np.arange(patch_size[0]), np.arange(patch_size[1]), indexing="ij")
    h = h / float(patch_size[0]) - 0.5
    w = w / float(patch_size[1]) - 0.5
    r = np.sqrt(h**2 + w**2) / sigma
    denorm = 1.0 / (sigma * math.sqrt(2 * math.pi))
    return (denorm * np.exp(-0.5 * r**2)).astype(np.float32)


def tiled_flow(
    model_fn: Callable,
    img1: np.ndarray,
    img2: np.ndarray,
    patch_size: Tuple[int, int] = FLOWFORMER_TRAIN_SIZE,
    sigma: float = 1.0,
    min_overlap: int = 20,
) -> np.ndarray:
    """Weighted-overlap tiled inference: img* [H, W, 3] with H, W at least
    the patch size -> [H, W, 2] flow (numpy)."""
    img1, img2 = _numpy(img1), _numpy(img2)
    h_img, w_img = img1.shape[:2]
    assert h_img >= patch_size[0] and w_img >= patch_size[1], (
        f"image {img1.shape} smaller than patch {patch_size}; resize with "
        "compute_adaptive_image_size and run un-tiled instead"
    )
    hws = compute_grid_indices((h_img, w_img), patch_size, min_overlap)
    w_patch = gaussian_patch_weight(patch_size, sigma)[..., None]

    flows = np.zeros((h_img, w_img, 2), np.float32)
    count = np.zeros((h_img, w_img, 1), np.float32)
    for (h, w) in hws:
        sl = np.s_[h:h + patch_size[0], w:w + patch_size[1]]
        flows[sl] += _numpy(model_fn(img1[sl], img2[sl])) * w_patch
        count[sl] += w_patch
    return flows / count


def adaptive_flow(
    model_fn: Callable,
    img1: np.ndarray,
    img2: np.ndarray,
    patch_size: Tuple[int, int] = FLOWFORMER_TRAIN_SIZE,
) -> np.ndarray:
    """Un-tiled path: resize up to the train size (cubic), predict, resize
    the flow back (linear) and divide it by the scale (numpy)."""
    img1, img2 = _numpy(img1), _numpy(img2)
    h_img, w_img = img1.shape[:2]
    (dw, dh), scale = compute_adaptive_image_size((h_img, w_img))

    def rs(im):
        return resize(torch.from_numpy(im), dh, dw, "cubic").numpy()

    f = _numpy(model_fn(rs(img1), rs(img2)))
    f = resize(torch.from_numpy(f), h_img, w_img, "linear").numpy()
    return f / scale
