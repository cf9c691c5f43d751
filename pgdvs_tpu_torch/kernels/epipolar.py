"""The exact and quad-masked epipolar samplers as one hand-written CUDA
kernel (``csrc/epipolar_sample.cu``), templated on the operand mode.

Replaces no TPU kernel: the JAX package samples in XLA. The plain versions,
which the kernel is held against, are ``models/gnt/projector.py``'s
``epipolar_sample_plain`` and ``epipolar_sample_quad_masked_plain``; the
public samplers there take them for CPU tensors and this module's
wrappers for CUDA tensors:

    sample_exact(pts [R, S, 3] f32, tgt_cam [34], src_cams [V, 34],
                 src_rgbs [V, H, W, 3] bf16, src_feats [V, Hf, Wf, F] bf16,
                 src_invalid_masks [V, H, W, 1] f32 or None)
      -> rgb_feat [V, R, S, 3+F] bf16, ray_diff [V, R, S, 4] f32
    sample_quad_masked(pts [R, S, 3] f32, proj [V, 3|4, 4],
                       fused_maps [V, H, W, C+1] bf16)
      -> rgb_feat [V, R, S, C] bf16
  both also -> mask_inbound, mask_invalid, mask [V, R, S] bool

Each (view, ray, sample) is projected, tapped, gathered and lerped in one
pass, with the plain versions' arithmetic (see the source's note), and
every output is written once. Bound by the bytes it writes: 467 MB (exact)
and 383 MB (quad) per 2048-ray tile at V = 10, S = 256, C = 35.

``launches[mode]`` counts launches per mode ("exact", "quad_masked"); each
launch also counts ``sampler.launches`` in ``utils.tracing``.
"""

from __future__ import annotations

import collections

import torch

from pgdvs_tpu_torch.core.cameras import flat_cam_c2w, flat_cam_projection
from pgdvs_tpu_torch.utils import tracing

# the output channels the kernel's staging holds (EPI_MAX_C in the .cu)
MAX_CHANNELS = 95

launches = collections.Counter()


def _row_vec(t: torch.Tensor) -> int:
    """The widest bf16 vector (8, 4, 2 or 1 elements) that every row of
    ``t`` [..., ch] starts on."""
    for vec in (8, 4, 2):
        if t.shape[-1] % vec == 0 and t.data_ptr() % (2 * vec) == 0:
            return vec
    return 1


def _check(pts, maps, dev):
    """Raise unless ``pts`` is [R, S, 3] float32 and ``maps`` (name ->
    (tensor, dtype, rank), None skipped) are of that dtype and rank, all
    contiguous on the CUDA device ``dev``."""
    if dev.type != "cuda":
        raise ValueError(f"the epipolar kernel runs on CUDA tensors, got {dev}")
    if pts.shape[-1:] != (3,):
        raise ValueError(f"pts must be [R, S, 3], got {tuple(pts.shape)}")
    for name, (t, dtype, ndim) in {"pts": (pts, torch.float32, 3), **maps}.items():
        if t is None:
            continue
        if t.dtype != dtype or t.ndim != ndim:
            raise ValueError(f"{name} must be {ndim}-d {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")


def _outputs(v, r, s, c, dev):
    """The samples [V, R, S, C] bf16 and the three masks [V, R, S] bool
    (views of one allocation)."""
    masks = torch.empty((3, v, r, s), dtype=torch.bool, device=dev)
    return torch.empty((v, r, s, c), dtype=torch.bfloat16, device=dev), masks


def _launch(mode, entry, dev, *args):
    """Call the C entry ``entry`` on ``dev``'s current stream; raise on a
    cudaError; count the launch."""
    from pgdvs_tpu_torch.kernels._build import load_library

    err = getattr(load_library().lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches[mode] += 1
    tracing.count("sampler.launches")


def _result(rgb_feat, masks, **extra):
    inbound, invalid, valid = masks.unbind(0)
    return {"rgb_feat": rgb_feat, **extra, "mask_inbound": inbound, "mask_invalid": invalid,
            "mask": valid}


def sample_exact(pts, tgt_cam, src_cams, src_rgbs, src_feats, src_invalid_masks=None,
                 out_dtype=torch.bfloat16, lerp_dtype=torch.float32):
    """``projector.epipolar_sample`` on the card: bf16 maps lerped in
    float32 into bf16 samples, the only dtypes the kernel takes."""
    dev = pts.device
    if out_dtype != torch.bfloat16 or lerp_dtype != torch.float32:
        raise ValueError("the exact kernel lerps in float32 into bfloat16 samples")
    _check(pts, {"src_rgbs": (src_rgbs, torch.bfloat16, 4),
                 "src_feats": (src_feats, torch.bfloat16, 4),
                 "src_invalid_masks": (src_invalid_masks, torch.float32, 4)}, dev)
    v, h, w, c3 = src_rgbs.shape
    _, hf, wf, f = src_feats.shape
    if c3 != 3 or src_feats.shape[0] != v or min(h, w, hf, wf) < 2 or 3 + f > MAX_CHANNELS:
        raise ValueError("src_rgbs must be [V, H, W, 3] and src_feats [V, Hf, Wf, F], "
                         f"maps of at least 2x2, 3+F <= {MAX_CHANNELS}")
    if src_invalid_masks is not None and src_invalid_masks.shape != (v, h, w, 1):
        raise ValueError("src_invalid_masks must be [V, H, W, 1] like src_rgbs")
    if tgt_cam.shape != (34,) or src_cams.shape != (v, 34) or {tgt_cam.device,
                                                                src_cams.device} != {dev}:
        raise ValueError("tgt_cam must be [34] and src_cams [V, 34] on the maps' device")
    proj = flat_cam_projection(src_cams)[:, :3, :].float().contiguous()
    centers = torch.cat([flat_cam_c2w(tgt_cam)[None, :3, 3],
                         flat_cam_c2w(src_cams)[:, :3, 3]]).float().contiguous()
    r, s = pts.shape[:2]
    rgb_feat, masks = _outputs(v, r, s, 3 + f, dev)
    ray_diff = torch.empty((v, r, s, 4), dtype=torch.float32, device=dev)
    mask = 0 if src_invalid_masks is None else src_invalid_masks.data_ptr()
    _launch("exact", "epipolar_exact", dev, pts.data_ptr(), proj.data_ptr(),
            centers.data_ptr(), src_rgbs.data_ptr(), src_feats.data_ptr(), mask,
            v, r, s, h, w, hf, wf, f, _row_vec(src_feats),
            (wf - 1.0) / (w - 1.0), (hf - 1.0) / (h - 1.0),
            rgb_feat.data_ptr(), ray_diff.data_ptr(), *[m.data_ptr() for m in masks])
    return _result(rgb_feat, masks, ray_diff=ray_diff)


def sample_quad_masked(pts, proj, fused_maps):
    """``projector.epipolar_sample_quad_masked`` on the card."""
    dev = pts.device
    _check(pts, {"fused_maps": (fused_maps, torch.bfloat16, 4)}, dev)
    v, h, w, c1 = fused_maps.shape
    if not 2 <= c1 <= MAX_CHANNELS + 1 or min(h, w) < 2:
        raise ValueError("fused_maps must be [V, H, W, C+1] with the mask channel, "
                         f"at least 2x2, C <= {MAX_CHANNELS}")
    if proj.shape[0] != v or proj.shape[-1] != 4 or proj.device != dev:
        raise ValueError("proj must be [V, 3|4, 4] on the maps' device")
    rows = proj[:, :3, :].float().contiguous()
    r, s = pts.shape[:2]
    rgb_feat, masks = _outputs(v, r, s, c1 - 1, dev)
    _launch("quad_masked", "epipolar_quad_masked", dev, pts.data_ptr(), rows.data_ptr(),
            fused_maps.data_ptr(), v, r, s, h, w, c1, _row_vec(fused_maps),
            rgb_feat.data_ptr(), *[m.data_ptr() for m in masks])
    return _result(rgb_feat, masks)
