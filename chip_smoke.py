#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pgdvs_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device: the card's name and power limit, TF32 switched off;
  2. build: the CUDA kernels compiled from ``pgdvs_tpu_torch/csrc`` with nvcc;
  3. K1 vs plain: K1 (the fused GNT transformer, validity recomputed
     in-kernel) against its plain torch version on the card at small shapes,
     at S=384 (past the old ray kernel's cap of 368) and at one main-path ray
     tile, with both times at that tile;
  3b. K2 vs plain: K2 (the same transformer with an explicit validity mask)
     likewise, including tokens whose views are all invalid from geometry
     and from the dynamic mask alone;
  3c. K3 vs plain: K3a and K3b (the split view and ray half-blocks, which
     read the ray-diff code and the mask from memory) against their plain
     versions on the same cases, then the whole split forward against its
     plain loop; per-launch times and bounds at the main tile; then K3b at
     S = 23, 256, 384 and 520 on the small rig (K3B_SAMPLE_COUNTS), and the
     ray kernel's own line (``[k_ray]``): its ms per launch at the main tile
     beside its bound, the exp floor, its shared memory and blocks per SM, and
     scaled_dot_product_attention as a yardstick for the attention core;
     and the view kernel's (``[k_view]``): its ms per launch at the main
     tile (K3a) beside its bound, the bounds of its launches inside K1 / K2,
     K3a at 1 and 32 views, its shared memory, registers, local memory and
     blocks per SM; and the prologue's (``[k_prologue]``): ``k_prologue``
     alone (``gnt_prologue``) per loader at the main tile (sampled features
     at row stride 35 and 36, patch rows on 4x2 and 2x2 blocks, quad rows),
     h and q held against ``prologue_plain``, ms per launch beside its bound
     (``prologue_cost``), registers, local memory, shared memory per block
     and blocks per SM;
  3d. K1 patch_rows vs plain: K1 fed raw patch rows and stencil
     coefficients (the combine in its prologue) against its plain version
     at both ray-block geometries (2x2 rays / 16 stencil positions, 4x2 /
     24) and at the main tile, with both times there;
  3e. K2 modes vs plain: K2 in each operand mode of
     ``gnt_fused_apply_mono3`` (MONO3_MODES: unfolded, which the exact path
     runs, on the small rig, at odd S, all invalid from geometry and from the
     dynamic mask, at S=384; fold_lerp with a separate mask and with fold_mask;
     fold_ray_diff without fold_pos_code; fold_mask without it; pre-packed;
     each at odd S and at the main tile) against its plain version, with
     both times and the bound at the main tile;
  3f. ``[epipolar]``: the exact and quad-masked samplers' kernel
     (``kernels/epipolar.py``) at the benchmark's 2048-ray tile (V = 10,
     S = 256, 288x550, 32 feature channels) against the plain samplers,
     then its ms per launch beside theirs and its byte bound;
  4. the main path (``[main]``): ``render_novel_view`` with
     ``apply_perf_preset(RenderConfig())`` (patch sampling on 4x2 ray
     blocks, K1's patch_rows mode) on the 288x550, 10-source, 256-sample
     synthetic scene with random weights from a fixed seed; the kernels'
     launch counts, finite output of the right shape, a crop of rays held
     against the plain path on the CPU, the share of taps clamped to their
     block's border, seconds per view and peak device memory;
  4b. the unmasked quad path (``[quad]``, K1 on sampled features): the same,
     then PSNR / SSIM of the patch render against it;
  5. K2 path: the same for the paper's ``default`` bundle (masked view
     attention + outlier removal of the dynamic cloud), plus the count of
     dynamic points the outlier removal keeps;
  6. K2 unfolded path (``[exact]``): the same for ``default`` on the exact
     preset (the reference-faithful sampler, on K2's unfolded mode as the
     JAX package's default runs it), plus PSNR / SSIM of its image against
     phase 5's quad render of the same view. K3a / K3b and K2's other modes
     run on no path: phases 3c and 3e are their only launches;
  7. ``[s384]``: the fast preset at 384 samples per ray (above the old cap)
     on a 64x96 view: one K1 patch_rows launch per ray tile, the crop against
     the plain path on the CPU;
  8. the renderer's other modes, each checked as the main path is (launches
     as routed, the crop against the plain path on the CPU, s/view, peak
     memory): ``[fine]``, the fast preset with 64 fine samples on 256 (two
     K1 patch_rows launches per ray tile, the clamp fraction of each pass);
     ``[fine-exact]``, `default` on the exact preset likewise (K2 unfolded
     at S = 256, then 320); ``[stride2]``, `default` quad at render stride 2
     (a 144x275 render, the dynamic layer resized to it); ``[fused]`` and
     ``[quad_i8]``, the unmasked preset with those samplers (K2 with the
     sampler's mask, K1 on the dequantized int8 samples), PSNR / SSIM
     against [quad]'s image; ``[view_std]``, a GNT made with ret_view_std at
     64x96 (the plain network on the card: no kernel launch), its view-std
     maps finite, non-zero and held against the CPU too;
  9. ``[reader]``: a 24-frame NVIDIA-layout scene of the synthetic scene
     written to a temporary directory with the port's ``write_png`` (raw
     576x1100 frames, 1-bit and 8-bit masks, disparity, flows, LLFF poses),
     three items read from disk by ``NvidiaEvalDataset`` (two in the mono
     video, one held-out camera) and their contract keys checked, the C
     PNG un-filter held against its numpy version, the items moved by
     ``to_device_prefetch`` and held against the host bit for bit, each
     rendered with ``default`` on K2 and checked as the main path is;
     host ms per reader stage, transfer ms, s/view, and the s/view of the
     same loop through ``PrefetchLoader(n_workers=2)``;
  10. ``[eval]``, on the same scene: (d) the main models written as the
     reference GNT checkpoint and loaded back onto the card by
     ``load_gnt_checkpoint`` (equal state dicts, a render crop equal bit
     for bit); (c) LPIPS with a random AlexNet and the bundled heads on the
     card against the CPU at 288x550 over the three regions, cuDNN's TF32
     switched on globally; (a) ``python -m pgdvs_tpu_torch.run eval``
     in-process over three items with that checkpoint and backbone found
     through ``$PGDVS_CKPT_DIR``: 78 K1 patch_rows launches per item, each
     pickle equal to ``compute_nvidia_metrics`` recomputed on the CPU from
     its render, ``summary.json``, each PNG the truncated render; (b)
     ``benchmark --benchmark-type default`` over the same items: 78 K2
     launches per item; (e) host ms per item by scoring stage, render and
     loop s/view, and whether scoring stays under the render;
  10b. ``[train]`` (in [eval]'s directory): fine-tuning through
     ``parallel.sharded.make_train_step`` (the plain network under
     autograd, no hand kernel): (a) at full width on the 288x550 synthetic
     scene, 9 of 10 sources, 256 exact samples, 512 rays, Adam, float32
     with TF32 off, then the GNT under bf16 autocast: ms per step (CUDA
     events), rays/s, peak memory, the losses of a warm-up and 5 steps on one
     batch falling, 0 kernel launches, ``utils.tracing`` spans around
     the sampler and the steps, one step under ``profile_trace`` (top
     kernels, trace size); (b) one SGD step at 48x64 on the card against the
     CPU, in float32 (loss, the gradient in L2 norm) and in float64 (loss and
     every gradient leaf); (c) torchrun of one rank on NCCL: ``run train
     --distributed`` over [reader]'s first 3 items for 2 epochs, then
     ``--resume`` for a third (the result lines, the checkpoints, the saved
     config);
  10c. ``[parallel]``: one torchrun of two ranks sharing the card
     over gloo (``chip_smoke.py --rank parallel``): ``sharded_render_rays``
     of the fast preset at 288x550 against the one-rank render (rays
     differing, rgb within the kernel's tolerance); a float64 train step
     at dp = 2 against one rank with both views; ``run eval --distributed
     --devices 2`` over [eval]'s 3 items (strided over the ranks: two on
     rank 0, one on rank 1) with its checkpoint, its summary.json against [eval] (a)'s; launches
     summed over the ranks, each phase's seconds. No speed-up is claimed:
     the ranks share one card;
  11. ``[jpeg]``: the C JPEG decoder built, the committed fixtures of
     tests/data/jpeg decoded to the sha256 and shape recorded from Pillow
     when they were made (the card's machine has no Pillow), the
     progressive fixture refused naming the file, host ms per megapixel on
     a 576x1100 frame written by ``encode_jpeg`` (a numpy baseline encoder:
     YCbCr 4:2:0, the Annex K tables scaled to quality 95);
  12. ``[geo]``: [reader]'s scene written anew with its frames as JPEG (each
     decode at least GEO_MIN_PSNR_DB above its source), the pure-geometry
     reader's static cloud (point count, host ms), the device ms of the KNN
     outlier removal over the whole cloud and of the point raster's taps,
     z-buffer and composite passes, each ``st_cvd_*`` bundle rendered (s/view
     after a warm-up) and held against the port on the CPU on a capped
     cloud, then ``run benchmark --benchmark-type`` of each bundle
     in-process over the first items (no kernel launches);
  13. ``[pcl]`` / ``[mesh]``: the ``..._render_point`` / ``..._render_mesh``
     bundles at 288x550 on the synthetic scene as phase 5 (78 K2 launches,
     the static crop against the CPU, s/view), their dynamic layer held
     against the CPU and the rasterizer's device ms;
  14. ``[track-eval]`` (in [eval]'s directory): ``run benchmark
     --benchmark-type st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir``
     in-process over one of [reader]'s items read with its track sources
     (TAPIR on seeded random weights): 78 K2 launches per item, checked as
     [eval] checks its runs;
  15. ``[track-lk]``: ``default`` with the track branch and the LK tracker
     at 288x550, ±5 track frames (every dynamic pixel of the 10 real track
     frames a query), through ``phase_main_path``, then taken apart
     (``track_breakdown``: query slots, valid queries, points lifted and
     kept after each filter, the tracker's device ms and launches, the
     rasterizer's ms); the branch at 48x64 held against the CPU;
  16. ``[track-tapir]``: TapirTracker on the card against the CPU on a
     small clip (grids, heads, tracks, visibility), chunked tracking against
     one call, then the ``_raw_res`` tapir bundle at 288x550 as [track-lk]
     on ±2 track frames (since PR 15), with the peak memory (the 256x256
     bundle runs in [track-eval] only);
  17. ``[track-cotracker]``: CoTracker on seeded, damped random weights:
     ``CoTrackerTracker`` one set on the card against the CPU on a T = 10
     64x96 clip at the published 384x512, six refinements (the encoder,
     the tracks, the visibility); 8192 valid queries in chunks of 4096
     equal to one-set calls on each chunk, bit for bit; the
     ``..._track_cotracker`` bundle at 288x550 on ±1 track frames as
     [track-lk] (78 K2 launches, the tracker's FLOPs, rate and the s/view
     they predict at ±5); and, in [eval]'s directory after [track-eval],
     ``run benchmark`` of the bundle over one item with the tracker's
     ``.pth`` under ``$PGDVS_CKPT_DIR``, checked as [eval] checks its runs;
  18. ``[vis]`` (in [eval]'s directory): [reader]'s scene written anew with
     flows at its 576x1100 frame size, through ``run benchmark
     --benchmark-type visualize_nvidia_max_disp_32`` in-process, the
     400-frame trajectory cut to 2 frames by ``--dataset-arg``: K2 masked
     once per 2048-ray tile of each 576x1100 frame, each PNG the frame's
     render truncated, frame 0's static layer held against the CPU on a
     crop, s/frame, host ms per item, the video written or skipped;
  19. ``[mono-vis]``: a DAVIS-layout scene at 480x854 (``write_mono_scene``,
     12 frames) through ``run vis --dataset mono_vis`` for 2 frames on the
     fast preset (K1 patch_rows), checked as [vis];
  20. ``[dycheck]``: a synthetic iPhone capture (``write_iphone_capture``,
     360x480, 24 train frames, one val frame at a train time and one
     between two) through ``run benchmark --benchmark-type default
     --dataset-family dycheck_iphone`` on the fast preset (K2 masked) and on
     exact (K2 unfolded), 10 KMeans-clustered spatial sources and per-pixel
     depth ranges: each pickle equal to the covisible metrics recomputed on
     the CPU, a crop held against the CPU, the spatial indices chosen, host
     ms per item and of the KMeans refit, s/item;
  21. ``[preprocess]``: RAFT on seeded, damped random weights on the card
     against the CPU at 96x128 (encoders, correlation window, 12-iteration
     flows); ``python -m pgdvs_tpu_torch.preprocess.compute_flow`` on a
     8-frame 576x1100 PNG clip at interval 1, 32 iterations, the weights as
     ``raft-things.pth`` under ``$PGDVS_CKPT_DIR``: the npz files, seconds
     per pair, FLOPs and TFLOP/s, peak memory, launches per pair and the
     busy share; then ``epipolar_mask`` and ``combine_masks`` on those
     flows and the clip's poses, host seconds per frame. No hand kernel
     launches there (RAFT is torch ops, as it is XLA in the JAX package);
  22. ``[depth]``: ZoeDepth (DPT-BEiT-L, 24 blocks, published widths) on
     seeded, damped random weights on the card against the CPU at 128x192
     (an 8x12 token grid: the position tables resized), single and NK
     heads; ``python -m pgdvs_tpu_torch.preprocess.compute_zoedepth`` on 8
     frames of [preprocess]'s clip with the weights written as
     ``ZoeD_M12_N.pt`` and seeded sparse MVS depth: the npz files, the net
     size (384x704), s per frame, the network's device ms, FLOPs and
     TFLOP/s, launches and busy share of one profiled frame, peak memory,
     the checkpoint's load time, the NVIDIA reader on the files; the
     semantic aggregation card against CPU at OneFormer's output shapes
     (equal seg maps and union); ``semantic_masks``' refusal without
     OneFormer. No hand kernel launches there.

The second-to-last line is a JSON object describing each kernel (its times,
its launches on its path, its launches per view / frame / item on phases 10b-10c and
17-22 and its bound on the card); the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device: without one it exits
non-zero before doing anything. Imports nothing of JAX, nor do the ranks it
starts under torchrun (``chip_smoke.py --rank parallel | cli``, each
checking ``sys.modules`` before it returns).
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# tolerances of the kernel against its plain version: bf16 operands with f32
# accumulation against the float32 plain network (rgb and count: the bounds
# the JAX package holds its own bf16 kernels to, tests/test_gnt_fused.py).
# The weights are a softmax over S samples, near 1/S each with random
# weights, so their bound is a share of that mean: 0.05 / S. On the H100 the
# error is 13x and more below it; a kernel that wrote the weights uniform,
# reversed or evens-then-odds would exceed it, which _check_against_plain
# confirms case by case.
KERNEL_TOL = {"rgb": 0.02, "weights": 0.05, "inbound_cnt_raw": 0.01}
# one half-block's q (K3a, K3b) against its plain version: atol, plus the
# same share of |q| as rgb (bf16 operands, f32 accumulation, one block deep)
Q_TOL = 0.02
# the prologue's h and q against prologue_plain: one bf16 ulp of relative
# error (2^-7) plus an atol for a hidden value rounded the other way
PRO_TOL = {"atol": 0.01, "rtol": 2.0 ** -7}
# the slice's end-to-end bounds (tests/test_gnt_model.py)
SLICE_TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02, "dyn_cnt": 0.02}
# the composited view-std maps (per-block feature stds of order 0.5-1.5)
# against the plain path on the CPU (tests/test_torch_port_view_std.py)
VIEW_STD_TOL = 0.01
SEED = 0
# NVIDIA H100 SXM data-sheet peaks (dense bf16 tensor cores, HBM3), at the
# card's full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def gnt_cost(v, r, s, c, masked):
    """(FLOP, bytes) of one GNT forward over R rays x S samples x V views
    with C input channels, as the kernels compute it: the dense products
    only (softmax, layer norms and embeddings are left out, so the bound is
    a lower one), with the weight compositions the kernels use (wk@wv,
    wk@wa0, wq@wa0, p1@wa0; exact by linearity); bytes read once (bf16
    features, f32 points / view code / centres, the uint8 mask of K2) and
    written once (f32 rgb, weights, count)."""
    n, nw, depth = r * s, 64, 8
    mac = n * v * (c * nw + nw * nw)                      # rgbfeat_fc_0/1
    mac += depth * n * v * (nw * (nw + 8) + 8 * (nw + 8) + 4 * 8 + 8 * nw)
    mac += depth * n * (nw * 8 + nw * nw + 2 * nw * 4 * nw)  # q side, out, ff
    mac += depth // 2 * n * ((nw + 126) * nw + nw * nw)   # q_fc on even blocks
    mac += depth * n * (nw * 3 * nw + nw * nw + 2 * nw * 4 * nw)  # qkv, out, ff
    mac += depth * r * 2 * s * s * nw                     # QK^T and PV, 4 heads
    mac += r * nw * 3                                     # rgb_fc
    nbytes = v * n * c * 2 + n * 3 * 4 + r * 63 * 4 + (v + 1) * 3 * 4
    nbytes += v * n if masked else v * 12 * 4             # mask, or K @ w2c
    nbytes += r * 3 * 4 + n * 4 + r * 4
    return 2 * mac, nbytes


def split_cost(kind, v, r, s):
    """(FLOP, bytes) of one K3a ("view") or K3b ("ray") launch over R rays x
    S samples x V views: the dense products and ray attention only, with
    K1's weight compositions; bytes at the function's contract (JAX's
    ``_run_view`` / ``_run_ray``), each read once (q, h and the ray-diff
    code in bf16, the mask in uint8) and written once (q in bf16, the f32
    weights row). The port's kernels keep q and the ray-diff code in f32,
    which moves more: 1.03 GB per K3a launch at the main tile, not 0.85."""
    n, nw = r * s, 64
    if kind == "view":
        # per (view, token): pos_fc_0, the composed [72 -> 72] product, attn_fc_1
        mac = n * v * (4 * 8 + (nw + 8) * (nw + 8) + 8 * nw)
        mac += n * (nw * 8 + nw * nw + 2 * nw * 4 * nw)   # wq@wa0, out, ff
        nbytes = v * n * (nw + 4) * 2 + v * n + 2 * n * nw * 2
    else:
        mac = n * (nw * 3 * nw + nw * nw + 2 * nw * 4 * nw)  # qkv, out, ff
        mac += r * 2 * s * s * nw                         # QK^T and PV, 4 heads
        nbytes = 2 * n * nw * 2 + n * 4
    return 2 * mac, nbytes


def view_block_cost(v, r, s, qfc=False, mask=False, rd16=False, pos16=False):
    """(FLOP, bytes) of one view-block launch (``k_view``) inside K1 / K2
    over R rays x S samples x V views, as the port's kernel moves them: the
    products of ``split_cost("view")``, plus q_fc on an even block (``qfc``:
    [192 -> 64 -> 64] per token); h [V, N, 64] bf16 read once, q f32 read
    and written once; the uint8 mask [V, N] (``mask``), the bf16 ray-diff
    code [V, N, 4] (``rd16``) and the bf16 point + view code [N, 126]
    (``pos16``) where the mode reads them, else f32 points (and on an even
    block the f32 view code [R, 63]) to make them from."""
    n, nw = r * s, 64
    flops, _ = split_cost("view", v, r, s)
    if qfc:
        flops += 2 * n * (3 * nw * nw + nw * nw)
    made_code = qfc and not pos16
    nbytes = v * n * nw * 2 + 2 * n * nw * 4
    nbytes += v * n if mask else 0
    nbytes += v * n * 8 if rd16 else 0
    nbytes += n * 126 * 2 if qfc and pos16 else 0
    nbytes += n * 12 if not (mask and rd16) or made_code else 0  # pts
    nbytes += r * 63 * 4 if made_code else 0
    return flops, nbytes


def bound_ms(flops, nbytes):
    """The least time the card could take: the larger of the compute and
    the memory time at the data-sheet peaks; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    log(smi)
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build():
    from pgdvs_tpu_torch.kernels._build import load_library

    t0 = time.perf_counter()
    lib = load_library()
    secs = time.perf_counter() - t0
    log(f"[build] {lib.path.name} built={lib.built} in {secs:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")
    return secs


def _rig(v, r, s, hw=(20, 28), seed=13, behind=False, device="cuda", feats=True):
    """Source cameras on a small arc and random points in front of them
    (and random features [V, R, S, 35] unless ``feats`` is False)."""
    import numpy as np
    import torch

    from pgdvs_tpu_torch.core import cameras as cam
    from pgdvs_tpu_torch.models.gnt.network import sinusoidal_embed

    rng = np.random.default_rng(seed)
    h, w = hw
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.9 * w
    k[0, 2], k[1, 2] = w / 2, h / 2
    cams = []
    for i in range(v):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.2 * i / v - 0.1, 0.1 * i / v, -0.05 * i / v]
        cams.append(cam.make_flat_cam(h, w, k, c2w))
    cams = torch.stack(cams)
    if behind:
        pts = np.full((r, s, 3), -50.0, np.float32)
    else:
        pts = rng.normal(0, 0.8, (r, s, 3)).astype(np.float32) + np.float32([0, 0, 2.5])
    ray_d = rng.normal(size=(r, 3)).astype(np.float32)
    ray_d = torch.from_numpy(ray_d)
    ops = {
        "pts": torch.from_numpy(pts),
        "view_code": sinusoidal_embed(ray_d / ray_d.norm(dim=-1, keepdim=True)),
        "centers": torch.cat([cam.flat_cam_c2w(cams[0])[None, :3, 3],
                              cam.flat_cam_c2w(cams)[:, :3, 3]]),
        "proj": cam.flat_cam_projection(cams),
    }
    if feats:
        ops["rgb_feat"] = torch.from_numpy(
            rng.normal(size=(v, r, s, 35)).astype(np.float32)).to(torch.bfloat16)
    return {k_: t.to(device) for k_, t in ops.items()}, hw


def _time_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_tol(key, s):
    """The bound of output ``key`` at S samples per ray."""
    return KERNEL_TOL[key] / s if key == "weights" else KERNEL_TOL[key]


def _wrong_weight_errs(ref):
    """The max error of a kernel that wrote the weights [R, S] uniform, in
    reversed sample order or evens then odds."""
    import torch

    s = ref.shape[-1]
    eo = torch.cat([torch.arange(0, s, 2), torch.arange(1, s, 2)]).to(ref.device)
    return {"uniform": float((ref - 1.0 / s).abs().max()),
            "reversed": float((ref - ref.flip(-1)).abs().max()),
            "evens_odds": float((ref - ref[:, eo]).abs().max())}


def _check_against_plain(name, kw, got, ref, worst, spread=None):
    """Hold the kernel's outputs (those of KERNEL_TOL's keys and "q" that
    the plain version has) to the plain version's; where the samples of a
    ray differ (``spread``, by default every case but points all at one
    place), show too that the weights bound rejects wrong weights."""
    import torch

    s = ref["weights"].shape[-1] if "weights" in ref else None
    errs = {}
    for key in [k for k in (*KERNEL_TOL, "q") if k in ref]:
        a, b = got[key], ref[key]
        tol = Q_TOL if key == "q" else kernel_tol(key, s)
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}/{key}: shape {tuple(a.shape)} "
                                 f"vs {tuple(b.shape)} or non-finite")
        err = (a - b).abs()
        bound = tol + (0.02 * b.abs() if key in ("rgb", "q") else 0.0)
        errs[key] = float(err.max())
        worst[key] = max(worst.get(key, 0.0), errs[key])
        if not bool((err <= bound).all()):
            raise AssertionError(f"{name}/{key}: max err {errs[key]} over tol {tol}"
                                 + (" + 2 %" if key in ("rgb", "q") else ""))
    if spread is None:
        spread = not kw.get("behind")
    wrong = _wrong_weight_errs(ref["weights"]) if spread and s else {}
    for label, e in wrong.items():
        if not e > kernel_tol("weights", s):
            raise AssertionError(f"{name}: weights written {label} would pass "
                                 f"the bound {kernel_tol('weights', s)} (err {e})")
    log(f"[kernel] {name} {kw}: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + (f" (weights tol {kernel_tol('weights', s):.3e}" if s else " (")
        + "".join(f", {k} {v:.3e}" for k, v in wrong.items()) + ")")


def phase_kernel_vs_plain(gnt):
    import torch

    from pgdvs_tpu_torch.kernels.gnt_fused import (
        gnt_fused_mono4, gnt_fused_mono4_plain, pack_mono4_weights,
    )

    packed = pack_mono4_weights(gnt, "cuda")
    worst = {k: 0.0 for k in KERNEL_TOL}
    cases = [
        ("small", dict(v=5, r=64, s=32)),
        ("odd_s", dict(v=5, r=64, s=23)),
        ("all_invalid", dict(v=5, r=16, s=32, behind=True)),
        ("s384", dict(v=5, r=64, s=384)),
        ("main_tile", dict(v=10, r=2048, s=256, hw=(288, 550))),
    ]
    times = {}
    for name, kw in cases:
        ops, hw = _rig(**kw)
        args = (ops["rgb_feat"], ops["pts"], ops["view_code"], ops["centers"],
                ops["proj"], hw)
        got = gnt_fused_mono4(packed, *args)
        torch.cuda.synchronize()
        ref = gnt_fused_mono4_plain(gnt, *args)
        _check_against_plain(name, kw, got, ref, worst)
        if name == "main_tile":
            v, r, s, c = ops["rgb_feat"].shape
            _time_main_tile("K1", times, (v, r, s), gnt_cost(v, r, s, c, False),
                            lambda: gnt_fused_mono4(packed, *args),
                            lambda: gnt_fused_mono4_plain(gnt, *args))
    return worst, times


def _time_main_tile(label, times, vrs, cost, kernel, plain, iters=5):
    v, r, s = vrs
    times["ms"] = _time_ms(kernel, iters)
    times["plain_ms"] = _time_ms(plain, 3)
    times["bound_ms"], times["bound_by"] = bound_ms(*cost)
    log(f"[kernel] {label} main tile R={r} S={s} V={v}: kernel {times['ms']:.3f} ms, "
        f"plain {times['plain_ms']:.3f} ms, bound {times['bound_ms']:.4f} ms "
        f"({times['bound_by']}; {times['bound_ms'] / times['ms']:.2%} of it)")


def _k2_mask(ops, hw, dyn_frac, seed=3):
    """K2's mask [V, R, S]: in bounds & in front (K1's projection test) and
    not dynamic, with a fraction of the taps dynamic."""
    import torch

    from pgdvs_tpu_torch.core.cameras import pixel_inbound, project_with

    pts, proj = ops["pts"], ops["proj"]
    uv, _z, front = project_with(proj[:, None, None], pts[None])
    inbound = pixel_inbound(uv, float(hw[0]), float(hw[1])) & front
    gen = torch.Generator(device=pts.device).manual_seed(seed)
    dyn = torch.rand(inbound.shape, generator=gen, device=pts.device) < dyn_frac
    return inbound & ~dyn


def phase_k2_vs_plain(gnt):
    import torch

    from pgdvs_tpu_torch.kernels.gnt_fused import pack_mono4_weights
    from pgdvs_tpu_torch.kernels.gnt_fused_mono3 import (
        gnt_fused_mono3, gnt_fused_mono3_plain,
    )

    packed = pack_mono4_weights(gnt, "cuda")
    worst = {k: 0.0 for k in KERNEL_TOL}
    cases = [
        ("small", dict(v=5, r=64, s=32), 0.3),
        ("odd_s", dict(v=5, r=64, s=23), 0.3),
        ("all_invalid_geometry", dict(v=5, r=16, s=32, behind=True), 0.3),
        ("all_invalid_dyn_mask", dict(v=5, r=16, s=32), 1.0),
        ("main_tile", dict(v=10, r=2048, s=256, hw=(288, 550)), 0.2),
    ]
    times = {}
    for name, kw, dyn_frac in cases:
        ops, hw = _rig(**kw)
        mask = _k2_mask(ops, hw, dyn_frac)
        if name.startswith("all_invalid") and bool(mask.any()):
            raise AssertionError(f"{name}: the rig left valid views")
        if not name.startswith("all_invalid") and not bool(mask.any()):
            raise AssertionError(f"{name}: the rig left no valid view")
        args = (ops["rgb_feat"], mask, ops["pts"], ops["view_code"], ops["centers"])
        got = gnt_fused_mono3(packed, *args)
        torch.cuda.synchronize()
        ref = gnt_fused_mono3_plain(gnt, *args)
        _check_against_plain(name, dict(kw, dyn_frac=dyn_frac), got, ref, worst)
        if name == "main_tile":
            v, r, s, c = ops["rgb_feat"].shape
            _time_main_tile("K2", times, (v, r, s), gnt_cost(v, r, s, c, True),
                            lambda: gnt_fused_mono3(packed, *args),
                            lambda: gnt_fused_mono3_plain(gnt, *args))
    return worst, times


def patch_cost(v, r, s, c, n_pos, nb):
    """(FLOP, bytes) of one K1 forward on patch rows: ``gnt_cost`` with the
    sampled features' bytes replaced by the rows' (bf16 [V, R/nb, S,
    n_pos*C], each read once) and the coefficients' (bf16 [V, R, S, n_pos]),
    plus the stencil combine, 2 * n_pos * C FLOP per (view, token), counted
    at the bf16 peak (a product the tensor cores could run, as the TPU
    kernel does)."""
    flops, nbytes = gnt_cost(v, r, s, c, False)
    nbytes += v * (r // nb) * s * n_pos * c * 2 + v * r * s * n_pos * 2 - v * r * s * c * 2
    return flops + 2 * n_pos * c * v * r * s, nbytes


PATCH_CASES = [
    ("odd_s_2x2", dict(v=5, r=64, s=23), 4, 16),
    ("odd_s_4x2", dict(v=5, r=64, s=23), 8, 24),
    ("all_invalid", dict(v=5, r=16, s=32, behind=True), 8, 24),
    ("main_tile", dict(v=10, r=2048, s=256, hw=(288, 550)), 8, 24),
]


def _patch_ops(kw, nb, n_pos, seed=21):
    """The rig's points and cameras with K1's patch_rows operands, made on
    the card: random bf16 rows [V, R/nb, S, n_pos*35] and coefficients
    [V, R/4, 4, S, n_pos], non-negative and summing to 1 per tap (like
    bilinear weights)."""
    import torch

    ops, hw = _rig(**kw, feats=False)
    v, r, s = kw["v"], kw["r"], kw["s"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randn((v, r // nb, s, n_pos * 35), generator=gen, device="cuda") * 0.5
    coef = torch.rand((v, r // 4, 4, s, n_pos), generator=gen, device="cuda")
    coef = coef / coef.sum(-1, keepdim=True)
    return (rows.to(torch.bfloat16), coef.to(torch.bfloat16), ops["pts"], ops["view_code"],
            ops["centers"], ops["proj"], hw)


def phase_patch_vs_plain(gnt):
    """K1's patch_rows mode against its plain version on PATCH_CASES; times
    and bound at the main tile."""
    import torch

    from pgdvs_tpu_torch.kernels.gnt_fused import pack_mono4_weights
    from pgdvs_tpu_torch.kernels.gnt_fused_patch import (
        gnt_fused_mono4_patch, gnt_fused_mono4_patch_plain,
    )

    packed = pack_mono4_weights(gnt, "cuda")
    worst = {k: 0.0 for k in KERNEL_TOL}
    times = {}
    for name, kw, nb, n_pos in PATCH_CASES:
        args = _patch_ops(kw, nb, n_pos)
        got = gnt_fused_mono4_patch(packed, *args)
        torch.cuda.synchronize()
        ref = gnt_fused_mono4_patch_plain(gnt, *args)
        _check_against_plain(f"K1 patch_rows {name}", dict(kw, rays_per_row=nb, n_pos=n_pos),
                             got, ref, worst)
        del ref
        if name == "main_tile":
            v, r, s = kw["v"], kw["r"], kw["s"]
            _time_main_tile("K1 patch_rows", times, (v, r, s),
                            patch_cost(v, r, s, 35, n_pos, nb),
                            lambda: gnt_fused_mono4_patch(packed, *args),
                            lambda: gnt_fused_mono4_patch_plain(gnt, *args))
    return worst, times


def mono3_cost(v, r, s, c, mode):
    """(FLOP, bytes) of one K2 forward in operand mode ``mode``
    (``gnt_fused_mono3.mode_name``): ``gnt_cost``'s products, plus with
    fold_lerp the four-tap combine (8 C FLOP per (view, token), counted at
    the bf16 peak as the patch combine is); the mode's operands at the
    function's contract, each read once: the features (bf16 [V, N, C]; C+1
    channels pre-packed; raw rows [V, N, 4C] and f32 frac [V, N, 2] with
    fold_lerp), the uint8 mask [V, N] (none pre-packed, the K @ w2c rows
    with fold_mask), the bf16 ray-diff code [V, N, 4] (f32 pts and centres
    with fold_ray_diff), the bf16 point + view code [N, 126] (the f32 view
    code [R, 63] with fold_pos_code); f32 outputs written once."""
    flops, _ = gnt_cost(v, r, s, c, True)
    n, folds = r * s, set(mode.split("+"))
    if "fold_lerp" in folds:
        nbytes = v * n * (4 * c * 2 + 2 * 4)
        flops += 2 * 4 * c * v * n
    else:
        nbytes = v * n * (c + ("pre_packed" in folds)) * 2
    if "fold_mask" in folds:
        nbytes += v * 12 * 4
    elif "pre_packed" not in folds:
        nbytes += v * n
    nbytes += n * 3 * 4 + (v + 1) * 3 * 4 if "fold_ray_diff" in folds else v * n * 4 * 2
    nbytes += r * 63 * 4 if "fold_pos_code" in folds else n * 126 * 2
    return flops, nbytes + r * 3 * 4 + n * 4 + r * 4


# K2's operand modes held against the plain version (phase 3e), each with a
# row in the kernels line: the exact path's unfolded mode and the modes only
# a direct call reaches
LERP_SEPARATE = "fold_lerp+separate_mask+fold_ray_diff+fold_pos_code"
LERP_FOLD_MASK = "fold_lerp+fold_mask+fold_ray_diff+fold_pos_code"
MONO3_MODES = ("unfolded", LERP_SEPARATE, LERP_FOLD_MASK, "fold_ray_diff",
               "fold_mask+fold_ray_diff", "pre_packed")
MAIN_TILE = dict(v=10, r=2048, s=256, hw=(288, 550))
K2_MODE_CASES = [
    ("unfolded", "small", dict(v=5, r=64, s=32), 0.3),
    ("unfolded", "odd_s", dict(v=5, r=64, s=23), 0.3),
    ("unfolded", "all_invalid_geometry", dict(v=5, r=16, s=32, behind=True), 0.3),
    ("unfolded", "all_invalid_dyn_mask", dict(v=5, r=16, s=32), 1.0),
    ("unfolded", "s384", dict(v=5, r=64, s=384), 0.3),
    ("unfolded", "main_tile", MAIN_TILE, 0.2),
] + [(mode, case, kw, 0.3 if case == "odd_s" else 0.2)
     for mode in MONO3_MODES[1:]
     for case, kw in (("odd_s", dict(v=5, r=64, s=23)), ("main_tile", MAIN_TILE))]


def _mono3_args(kw, dyn_frac, mode, seed=31, device="cuda"):
    """The rig's operands of ``gnt_fused_apply_mono3`` in ``mode``: its
    features (random raw quad rows [V, R, S, 140] bf16 and offsets in
    [-0.6, 1.6] with fold_lerp, so that the zero-pad weights clip; the mask
    as a trailing channel pre-packed), ray-diff code, K2's mask, point code
    and view code, and the keywords; with the validity it implies."""
    import torch

    from pgdvs_tpu_torch.core.cameras import pixel_inbound, project_with, ray_diff_features
    from pgdvs_tpu_torch.models.gnt.network import sinusoidal_embed

    folds = set(mode.split("+"))
    ops, hw = _rig(**kw, device=device)
    pts, ctr, proj = ops["pts"], ops["centers"], ops["proj"]
    if "fold_mask" in folds:
        uv, _z, front = project_with(proj[:, None, None], pts[None])
        valid = pixel_inbound(uv, float(hw[0]), float(hw[1])) & front
    else:
        valid = _k2_mask(ops, hw, dyn_frac)
    feats, opts = ops["rgb_feat"], dict(views_outer=True)
    if "fold_lerp" in folds:
        gen = torch.Generator(device=device).manual_seed(seed)
        v, r, s = kw["v"], kw["r"], kw["s"]
        feats = (torch.randn((v, r, s, 4 * 35), generator=gen, device=device)
                 * 0.5).to(torch.bfloat16)
        opts.update(fold_lerp=True, frac=torch.rand(
            (v, r, s, 2), generator=gen, device=device) * 2.2 - 0.6)
    if "pre_packed" in folds:
        feats = torch.cat([feats, valid[..., None].to(torch.bfloat16)], dim=-1)
    if "fold_ray_diff" in folds:
        opts.update(pts=pts, cam_centers=ctr)
    if "fold_mask" in folds:
        opts.update(fold_mask_hw=hw, proj_mats=proj)
    opts.update(separate_mask="separate_mask" in folds,
                fold_pos_code="fold_pos_code" in folds)
    args = (feats,
            None if "fold_ray_diff" in folds else ray_diff_features(
                pts[None], ctr[0], ctr[1:, None, None, :]),
            None if folds & {"fold_mask", "pre_packed"} else valid,
            None if "fold_pos_code" in folds else sinusoidal_embed(pts),
            ops["view_code"])
    return args, opts, valid


def phase_k2_modes_vs_plain(gnt):
    """K2 in each of MONO3_MODES against its plain version on
    K2_MODE_CASES; times and bound at the main tile. Returns ({mode:
    worst}, {mode: times})."""
    import torch

    from pgdvs_tpu_torch.kernels.gnt_fused import pack_mono4_weights
    from pgdvs_tpu_torch.kernels.gnt_fused_mono3 import (
        gnt_fused_apply_mono3, gnt_fused_apply_mono3_plain,
    )

    packed = pack_mono4_weights(gnt, "cuda")
    worst = {mode: {k: 0.0 for k in KERNEL_TOL} for mode in MONO3_MODES}
    times = {mode: {} for mode in MONO3_MODES}
    for mode, name, kw, dyn_frac in K2_MODE_CASES:
        args, opts, valid = _mono3_args(kw, dyn_frac, mode)
        if name.startswith("all_invalid") == bool(valid.any()):
            raise AssertionError(f"{mode} {name}: the rig's validity is wrong for the case")
        before = gnt_fused_apply_mono3.launches[mode]
        got = gnt_fused_apply_mono3(packed, *args, **opts)
        torch.cuda.synchronize()
        if gnt_fused_apply_mono3.launches[mode] != before + 1:
            raise AssertionError(f"K2 {mode}: the launch was not counted under its mode")
        ref = gnt_fused_apply_mono3_plain(gnt, *args, **opts)
        _check_against_plain(f"K2 {mode} {name}", dict(kw, dyn_frac=dyn_frac), got, ref,
                             worst[mode])
        del ref
        if name == "main_tile":
            v, r, s = kw["v"], kw["r"], kw["s"]
            _time_main_tile(f"K2 {mode}", times[mode], (v, r, s),
                            mono3_cost(v, r, s, 35, mode),
                            lambda: gnt_fused_apply_mono3(packed, *args, **opts),
                            lambda: gnt_fused_apply_mono3_plain(gnt, *args, **opts))
    return worst, times


# the fine pass's tile: 256 coarse + 64 fine samples ([fine], [fine-exact])
FINE_TILE = dict(v=10, r=2048, s=320, hw=(288, 550))


def phase_fine_tiles(gnt):
    """The kernels of the fine pass at its tile (S = 320): K1 patch_rows on
    4x2 blocks and K2 unfolded, each against its plain version, then both
    times and the bound (``patch_cost`` / ``mono3_cost``). Returns
    {kernel row name: times}."""
    import torch

    from pgdvs_tpu_torch.kernels.gnt_fused import pack_mono4_weights
    from pgdvs_tpu_torch.kernels.gnt_fused_mono3 import (
        gnt_fused_apply_mono3, gnt_fused_apply_mono3_plain,
    )
    from pgdvs_tpu_torch.kernels.gnt_fused_patch import (
        gnt_fused_mono4_patch, gnt_fused_mono4_patch_plain,
    )

    packed = pack_mono4_weights(gnt, "cuda")
    v, r, s = FINE_TILE["v"], FINE_TILE["r"], FINE_TILE["s"]
    times = {"gnt_fused_mono4_patch": {}, "gnt_fused_apply_mono3[unfolded]": {}}
    args = _patch_ops(FINE_TILE, 8, 24)
    patch = (lambda: gnt_fused_mono4_patch(packed, *args),
             lambda: gnt_fused_mono4_patch_plain(gnt, *args))
    margs, opts, _valid = _mono3_args(FINE_TILE, 0.2, "unfolded")
    unfolded = (lambda: gnt_fused_apply_mono3(packed, *margs, **opts),
                lambda: gnt_fused_apply_mono3_plain(gnt, *margs, **opts))
    for name, (kernel, plain), cost in (
            ("gnt_fused_mono4_patch", patch, patch_cost(v, r, s, 35, 24, 8)),
            ("gnt_fused_apply_mono3[unfolded]", unfolded, mono3_cost(v, r, s, 35, "unfolded"))):
        got = kernel()
        torch.cuda.synchronize()
        _check_against_plain(f"{name} fine_tile", FINE_TILE, got, plain(), {})
        _time_main_tile(f"{name} (fine pass)", times[name], (v, r, s), cost, kernel, plain)
    return times


K3_CASES = [
    ("small", dict(v=5, r=64, s=32), 0.3),
    ("odd_s", dict(v=5, r=64, s=23), 0.3),
    ("all_invalid_geometry", dict(v=5, r=16, s=32, behind=True), 0.3),
    ("all_invalid_dyn_mask", dict(v=5, r=16, s=32), 1.0),
    ("main_tile", dict(v=10, r=2048, s=256, hw=(288, 550)), 0.2),
]


def phase_k3_vs_plain(gnt, blk=2):
    """K3a and K3b (block ``blk``'s half-blocks) against their plain
    versions on random q and h and the rig's ray-diff code and mask, then
    the whole split forward against its plain loop, on K3_CASES; times at
    the main tile. Returns ({"view": worst, "ray": worst},
    {"view": times, "ray": times})."""
    import torch

    from pgdvs_tpu_torch.core.cameras import ray_diff_features
    from pgdvs_tpu_torch.kernels.gnt_fused_split import (
        gnt_fused_split, gnt_fused_split_plain, gnt_split_ray, gnt_split_view,
        pack_split_weights, split_ray_plain, split_view_plain,
    )
    from pgdvs_tpu_torch.models.gnt.network import sinusoidal_embed

    packed = pack_split_weights(gnt, "cuda")
    vblk, rblk = packed.view[blk], packed.ray[blk]
    worst = {"view": {}, "ray": {}, "forward": {}}
    times = {"view": {}, "ray": {}}
    for name, kw, dyn_frac in K3_CASES:
        ops, hw = _rig(**kw)
        mask = _k2_mask(ops, hw, dyn_frac)
        if name.startswith("all_invalid") == bool(mask.any()):
            raise AssertionError(f"{name}: the rig's mask is wrong for the case")
        pts, ctr = ops["pts"], ops["centers"]
        rd = ray_diff_features(pts[None], ctr[0], ctr[1:, None, None, :])
        v, r, s, _ = ops["rgb_feat"].shape
        gen = torch.Generator(device="cuda").manual_seed(7)
        q = torch.randn((r, s, 64), generator=gen, device="cuda")
        h = torch.randn((v, r, s, 64), generator=gen, device="cuda").to(torch.bfloat16)
        kwd = dict(kw, dyn_frac=dyn_frac)

        got = gnt_split_view(q, h, rd, mask, vblk)
        torch.cuda.synchronize()
        _check_against_plain(f"K3a {name}", kwd, {"q": got},
                             {"q": split_view_plain(q, h, rd, mask, vblk)}, worst["view"])
        got_q, got_w = gnt_split_ray(q, rblk)
        torch.cuda.synchronize()
        ref_q, ref_w = split_ray_plain(q, rblk)
        # random q spreads the weights in every case
        _check_against_plain(f"K3b {name}", kwd, {"q": got_q, "weights": got_w},
                             {"q": ref_q, "weights": ref_w}, worst["ray"], spread=True)
        args = (ops["rgb_feat"], rd, mask, sinusoidal_embed(pts), ops["view_code"])
        got = gnt_fused_split(packed, *args)
        torch.cuda.synchronize()
        _check_against_plain(f"K3 forward {name}", kwd, got,
                             gnt_fused_split_plain(gnt, *args), worst["forward"])
        if name == "main_tile":
            _time_main_tile("K3a", times["view"], (v, r, s), split_cost("view", v, r, s),
                            lambda: gnt_split_view(q, h, rd, mask, vblk),
                            lambda: split_view_plain(q, h, rd, mask, vblk), iters=20)
            _time_main_tile("K3b", times["ray"], (v, r, s), split_cost("ray", v, r, s),
                            lambda: gnt_split_ray(q, rblk),
                            lambda: split_ray_plain(q, rblk), iters=20)
            fwd = _time_ms(lambda: gnt_fused_split(packed, *args), 3)
            log(f"[kernel] K3 whole split forward, main tile: {fwd:.3f} ms "
                "(8 K3a + 8 K3b launches, torch prologue / q_fc / epilogue)")
    # the ray kernel streams the sample axis: any S, past the old cap of 368
    for s in K3B_SAMPLE_COUNTS:
        gen = torch.Generator(device="cuda").manual_seed(s)
        q = torch.randn((64, s, 64), generator=gen, device="cuda")
        got_q, got_w = gnt_split_ray(q, rblk)
        torch.cuda.synchronize()
        ref_q, ref_w = split_ray_plain(q, rblk)
        _check_against_plain(f"K3b s{s}", dict(r=64, s=s), {"q": got_q, "weights": got_w},
                             {"q": ref_q, "weights": ref_w}, worst["ray"], spread=True)
    return {p: worst[p] for p in ("view", "ray")}, times


# K3b's sample counts on the small rig: odd, the main one, past the old
# one-block-per-ray cap of 368, and past a multiple of the key tile
K3B_SAMPLE_COUNTS = (23, 256, 384, 520)


def phase_ray_kernel(ray_times, r=2048, s=256, heads=4):
    """The ray kernel's own line at the main tile: its ms per launch (the
    K3b timing), its bound, the exp floor (R * heads * S^2 exponentials at
    16 ex2 per clock per SM, the SFU rate), its shared memory and resident
    blocks per SM, and scaled_dot_product_attention on q, k, v [R, heads, S,
    16] bf16 as a yardstick for the attention core alone (no path calls it,
    and no PyTorch call computes the whole half-block). The exp floor is
    taken at the SM's maximum clock (cudaDeviceProp.clockRate)."""
    import torch
    import torch.nn.functional as F

    from pgdvs_tpu_torch.kernels._build import load_library

    lib = load_library().lib
    props = torch.cuda.get_device_properties(0)
    mhz = props.clock_rate / 1e3
    exp_floor = r * heads * s * s / (16 * props.multi_processor_count * mhz * 1e6) * 1e3
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = [torch.randn((r, heads, s, 16), generator=gen, device="cuda").to(torch.bfloat16)
           for _ in range(3)]
    sdpa = _time_ms(lambda: F.scaled_dot_product_attention(*qkv), 20)
    log(f"[k_ray] main tile R={r} S={s}: {ray_times['ms']:.4f} ms per launch (K3b), bound "
        f"{ray_times['bound_ms']:.4f} ms ({ray_times['bound_by']}), exp floor "
        f"{exp_floor:.4f} ms ({r}*{heads}*{s}^2 ex2 at 16/clock/SM x "
        f"{props.multi_processor_count} SMs x {mhz:.0f} MHz, cudaDeviceProp.clockRate); "
        f"shared memory {lib.gnt_ray_smem_bytes()} B per block, "
        f"{lib.gnt_ray_blocks_per_sm()} block(s) per SM; yardstick, attention core only: "
        f"scaled_dot_product_attention q,k,v [{r}, {heads}, {s}, 16] bf16 {sdpa:.4f} ms")


def _time_k3a(vblk, v, r, s, iters=20):
    """K3a's ms per launch on the rig at V views, R rays x S samples, with
    random q and h, the rig's ray-diff code and K3's main-tile mask."""
    import torch

    from pgdvs_tpu_torch.core.cameras import ray_diff_features
    from pgdvs_tpu_torch.kernels.gnt_fused_split import gnt_split_view

    ops, hw = _rig(v=v, r=r, s=s, hw=(288, 550), feats=False)
    rd = ray_diff_features(ops["pts"][None], ops["centers"][0], ops["centers"][1:, None, None, :])
    mask = _k2_mask(ops, hw, 0.2)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((r, s, 64), generator=gen, device="cuda")
    h = torch.randn((v, r, s, 64), generator=gen, device="cuda").to(torch.bfloat16)
    return _time_ms(lambda: gnt_split_view(q, h, rd, mask, vblk), iters)


def phase_view_kernel(gnt, view_times, r=2048, s=256, v=10, blk=2):
    """The view kernel's own line at the main tile: its ms per launch (the
    K3a timing) beside its bound at the function's contract, the bounds of
    the launches inside K1 / K2 (an odd block of K1, an even block of K1 and
    of K2 unfolded, with q_fc), K3a at 1 and 32 views (what a launch costs
    per view and apart from its views: the line through V = 1 and 32), its
    shared memory per block, and per instantiation (validity from the
    projection test, the mask, the split operands) its registers per thread,
    local memory per thread (spills and stack) and resident blocks per SM."""
    import ctypes

    from pgdvs_tpu_torch.kernels._build import load_library
    from pgdvs_tpu_torch.kernels.gnt_fused_split import pack_split_weights

    lib = load_library().lib
    vblk = pack_split_weights(gnt, "cuda").view[blk]
    sweep = {n: _time_k3a(vblk, n, r, s) for n in (1, 32)}
    per_view = (sweep[32] - sweep[1]) / 31
    attrs = {}
    for vsrc, name in enumerate(("proj", "mask", "split")):
        out = (ctypes.c_int * 3)()
        err = lib.gnt_view_attrs(vsrc, ctypes.cast(out, ctypes.c_void_p))
        if err:
            raise RuntimeError(f"gnt_view_attrs({vsrc}): cudaError {err}")
        attrs[name] = {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}
    inside = {
        "K1 odd block": bound_ms(*view_block_cost(v, r, s)),
        "K1 even block": bound_ms(*view_block_cost(v, r, s, qfc=True)),
        "K2 unfolded even block": bound_ms(*view_block_cost(v, r, s, qfc=True, mask=True,
                                                            rd16=True, pos16=True)),
    }
    view_bytes = r * s * 64 * 2  # one view's h
    log(f"[k_view] main tile R={r} S={s} V={v}: {view_times['ms']:.4f} ms per launch (K3a), "
        f"bound {view_times['bound_ms']:.4f} ms ({view_times['bound_by']}, the function's "
        "bf16 contract); bound inside K1 / K2: "
        + ", ".join(f"{k} {b:.4f} ms ({by})" for k, (b, by) in inside.items())
        + f"; K3a at V=1 {sweep[1]:.4f} ms, V=32 {sweep[32]:.4f} ms: {per_view:.4f} ms per "
        f"view (h {view_bytes / per_view / 1e9:.3f} TB/s), {sweep[1] - per_view:.4f} ms apart "
        f"from the views; shared memory {lib.gnt_view_smem_bytes()} B per block; "
        + ", ".join(f"{k}: {a['registers']} registers, {a['local_bytes']} B local memory "
                    "(spills and stack), "
                    f"{a['blocks_per_sm']} block(s) per SM" for k, a in attrs.items()))


def prologue_cost(v, r, s, c, source, ld=None, n_pos=0, nb=1):
    """(FLOP, bytes) of one prologue launch (``k_prologue``) over R rays x S
    samples x V views at C channels from ``source`` (``gnt_prologue.
    PROLOGUE_SOURCES``): rgbfeat_fc_0/1 (2 V N (C 64 + 64 64) FLOP) plus the
    patch combine (2 n_pos C per (view, token)) or the quad combine (8 C),
    counted at the bf16 peak as ``patch_cost`` counts it; the features read
    once (bf16 rows of ``ld`` channels; patch rows [V, R/nb, S, n_pos C] and
    coefficients [V, R, S, n_pos] bf16; quad rows [V, N, 4C] bf16 and frac
    [V, N, 2] f32), the head weights read once, h [V, N, 64] bf16 and q [N,
    64] f32 written once."""
    n, nw = r * s, 64
    flops = 2 * v * n * (c * nw + nw * nw)
    if source == "rgb_feat":
        nbytes = v * n * (ld or c) * 2
    elif source == "patch":
        nbytes = v * (r // nb) * s * n_pos * c * 2 + v * n * n_pos * 2
        flops += 2 * n_pos * c * v * n
    else:
        nbytes = v * n * (4 * c * 2 + 2 * 4)
        flops += 2 * 4 * c * v * n
    nbytes += (c * nw + nw * nw) * 2 + 2 * nw * 4 + v * n * nw * 2 + n * nw * 4
    return flops, nbytes


# the prologue's loaders timed at the main tile: (label, source, row stride,
# n_pos, rays per row block)
PROLOGUE_LOADERS = (("rgb_feat ld35", "rgb_feat", 35, 0, 1),
                    ("rgb_feat ld36", "rgb_feat", 36, 0, 1),
                    ("patch 4x2", "patch", 35, 24, 8),
                    ("patch 2x2", "patch", 35, 16, 4),
                    ("quad_rows", "quad_rows", 35, 0, 1))


def _prologue_operands(source, v, r, s, ld, n_pos, nb, seed=5, device="cuda"):
    """Random operands of ``gnt_prologue`` for one loader: bf16 features
    [V, R, S, ld]; patch rows [V, R/nb, S, n_pos*35] and coefficients
    [V, R/4, 4, S, n_pos], non-negative and summing to 1 per tap; or raw
    quad rows [V, R, S, 140] and offsets in [-0.6, 1.6]."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    if source == "rgb_feat":
        return {"rgb_feat": torch.randn((v, r, s, ld), generator=gen,
                                        device=device).to(torch.bfloat16)}
    if source == "patch":
        rows = torch.randn((v, r // nb, s, n_pos * 35), generator=gen, device=device) * 0.5
        coef = torch.rand((v, r // 4, 4, s, n_pos), generator=gen, device=device)
        return {"rows": rows.to(torch.bfloat16),
                "coef": (coef / coef.sum(-1, keepdim=True)).to(torch.bfloat16)}
    rows = torch.randn((v, r, s, 4 * 35), generator=gen, device=device) * 0.5
    frac = torch.rand((v, r, s, 2), generator=gen, device=device) * 2.2 - 0.6
    return {"rows": rows.to(torch.bfloat16), "frac": frac}


def check_prologue(name, got, ref, worst):
    """Hold the prologue's (h, q) to the plain version's within PRO_TOL,
    raising ``worst``'s entries to the max errors."""
    import torch

    for key, a, b in (("h", got[0], ref[0]), ("q", got[1], ref[1])):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}/{key}: shape {tuple(a.shape)} vs {tuple(b.shape)} "
                                 "or non-finite")
        err = (a - b).abs()
        worst[key] = max(worst.get(key, 0.0), float(err.max()))
        if not bool((err <= PRO_TOL["atol"] + PRO_TOL["rtol"] * b.abs()).all()):
            raise AssertionError(f"{name}/{key}: max err {float(err.max())} over {PRO_TOL}")


def phase_prologue_kernel(gnt, v=10, r=2048, s=256):
    """The prologue's own line: ``k_prologue`` alone (``gnt_prologue``) for
    each of PROLOGUE_LOADERS, first on small cases (V = 1 and 32, S = 23, N
    not a multiple of 8) and then at the main tile, h and q held against
    ``prologue_plain``; at the main tile its ms per launch (20 launches,
    CUDA events) beside the plain version's and the bound, and per loader
    the registers, local memory, shared memory per block and resident
    blocks per SM. Returns {source: (worst errors, times)} of the loaders
    the kernels line reports (row stride 35, patch 4x2, quad rows)."""
    import ctypes

    from pgdvs_tpu_torch.kernels._build import load_library
    from pgdvs_tpu_torch.kernels.gnt_fused import pack_mono4_weights
    from pgdvs_tpu_torch.kernels.gnt_prologue import (
        PROLOGUE_SOURCES, gnt_prologue, prologue_features, prologue_plain,
    )

    lib = load_library().lib
    packed = pack_mono4_weights(gnt, "cuda")
    out, parts = {}, []
    for label, source, ld, n_pos, nb in PROLOGUE_LOADERS:
        worst = {}
        for cv, cr, cs in ((1, 12, 23), (32, 4, 23), (v, r, s)):
            if cr % nb:
                continue
            ops = _prologue_operands(source, cv, cr, cs, ld, n_pos, nb)
            got = gnt_prologue(packed, **ops)
            ref = prologue_plain(gnt, prologue_features(35, **ops))
            check_prologue(f"k_prologue {label} V={cv} R={cr} S={cs}", got, ref, worst)
            del got, ref
        times = {"ms": _time_ms(lambda: gnt_prologue(packed, **ops), 20),
                 "plain_ms": _time_ms(lambda: prologue_plain(gnt, prologue_features(35, **ops)),
                                      3)}
        times["bound_ms"], times["bound_by"] = bound_ms(*prologue_cost(
            v, r, s, 35, source, ld, n_pos, nb))
        attrs = (ctypes.c_int * 4)()
        err = lib.gnt_prologue_attrs(PROLOGUE_SOURCES[source], 35, ld, n_pos, nb,
                                     ctypes.cast(attrs, ctypes.c_void_p))
        if err:
            raise RuntimeError(f"gnt_prologue_attrs({label}): cudaError {err}")
        parts.append(
            f"{label}: {times['ms']:.4f} ms (plain {times['plain_ms']:.3f}), bound "
            f"{times['bound_ms']:.4f} ms ({times['bound_by']}; "
            f"{times['bound_ms'] / times['ms']:.1%} of it), h err {worst['h']:.3e}, q err "
            f"{worst['q']:.3e}, {attrs[0]} registers, {attrs[1]} B local memory, "
            f"{attrs[2]} B shared memory per block, {attrs[3]} block(s) per SM")
        if label in ("rgb_feat ld35", "patch 4x2", "quad_rows"):
            out[source] = (worst, times)
        del ops
    log(f"[k_prologue] main tile R={r} S={s} V={v}, C=35, per launch: " + "; ".join(parts))
    return out


def sampler_bytes(v, r, s, hw, fhw, f, mode):
    """Bytes the epipolar kernel must move for one call: every input read
    once (the points, the maps) and every output written once (the samples,
    three byte masks, and on exact the float32 ray-difference code); its
    arithmetic is negligible beside them."""
    (h, w), (hf, wf) = hw, fhw
    n = v * r * s
    if mode == "exact":
        read = v * h * w * (3 * 2 + 4) + v * hf * wf * f * 2
        write = n * ((3 + f) * 2 + 16)
    else:  # the fused map [V, H, W, 3+F+1] bf16
        read = v * h * w * (3 + f + 1) * 2
        write = n * (3 + f) * 2
    return read + r * s * 12 + write + 3 * n


def _sampler_rig(v, r, s, hw, fhw, f, seed=11, device="cuda"):
    """A 2048-ray tile as the renderer makes one: rays from a target camera
    through consecutive pixels of its middle rows, samples uniform in
    inverse depth over [1.5, 8], sources on a small arc (points behind
    none; off-image projections at the frusta's edges); bf16 rgb and
    features, 0 / 1 float32 dynamic masks, and the fused map of the three."""
    import numpy as np
    import torch

    from pgdvs_tpu_torch.core import cameras as cam
    from pgdvs_tpu_torch.models.gnt.projector import build_fused_maps

    rng = np.random.default_rng(seed)
    (h, w), (hf, wf) = hw, fhw
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.9 * w
    k[0, 2], k[1, 2] = w / 2, h / 2
    cams = []
    for i in range(v + 1):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.3 * np.cos(i) - 0.1 * (i == 0), 0.1 * np.sin(i), -0.05 * i / v]
        cams.append(cam.make_flat_cam(h, w, k, c2w))
    pix = np.arange(r) + (h // 2) * w - r // 2
    d = np.stack([(pix % w + 0.5 - w / 2) / k[0, 0], (pix // w + 0.5 - h / 2) / k[1, 1],
                  np.ones(r)], -1)
    z = 1.0 / np.linspace(1 / 1.5, 1 / 8.0, s)
    pts = (d[:, None, :] * z[None, :, None] + cams[0][18:34].reshape(4, 4)[:3, 3].numpy())
    t = {
        "pts": torch.from_numpy(pts.astype(np.float32)),
        "rgbs": torch.from_numpy(rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32)),
        "feats": torch.from_numpy(rng.normal(0, 1, (v, hf, wf, f)).astype(np.float32)),
        "masks": torch.from_numpy((rng.uniform(0, 1, (v, h, w, 1)) > 0.8).astype(np.float32)),
        "tgt": cams[0].float(),
        "cams": torch.stack(cams[1:]).float(),
    }
    t = {k_: x.to(device) for k_, x in t.items()}
    t["fused"] = build_fused_maps(t["rgbs"], t["feats"], t["masks"])
    t["rgbs"], t["feats"] = t["rgbs"].to(torch.bfloat16), t["feats"].to(torch.bfloat16)
    t["proj"] = cam.flat_cam_projection(t["cams"])
    return t


def phase_epipolar_kernel(v=10, r=2048, s=256, hw=(288, 550), fhw=(72, 138), f=32):
    """The epipolar sampler's kernel (``kernels/epipolar.py``) in both modes
    at the benchmark's tile: held against the plain samplers (rgb_feat atol
    1e-2 + rtol 2^-7, ray_diff 1e-5, the masks' flips counted: ties of the
    two projections' summation orders), then ms per launch (20 launches,
    CUDA events) beside the plain version's and the byte bound
    (``sampler_bytes``). Returns {mode: times}."""
    import torch

    from pgdvs_tpu_torch.kernels import epipolar
    from pgdvs_tpu_torch.models.gnt import projector as pj

    t = _sampler_rig(v, r, s, hw, fhw, f)
    calls = {
        "exact": (pj.epipolar_sample, pj.epipolar_sample_plain,
                  (t["pts"], t["tgt"], t["cams"], t["rgbs"], t["feats"], t["masks"])),
        "quad_masked": (pj.epipolar_sample_quad_masked, pj.epipolar_sample_quad_masked_plain,
                        (t["pts"], t["proj"], t["fused"])),
    }
    out, parts = {}, []
    for mode, (kernel, plain, args) in calls.items():
        before = epipolar.launches[mode]
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if epipolar.launches[mode] != before + 1:
            raise AssertionError(f"[epipolar] {mode}: the kernel did not launch")
        torch.testing.assert_close(got["rgb_feat"].float(), ref["rgb_feat"].float(),
                                   atol=1e-2, rtol=2.0 ** -7)
        if mode == "exact":
            torch.testing.assert_close(got["ray_diff"], ref["ray_diff"], atol=1e-5, rtol=0)
        flips = {k_: int((got[k_] != ref[k_]).sum()) for k_ in ("mask_inbound", "mask_invalid")}
        if max(flips.values()) > 1e-4 * got["mask"].numel():
            raise AssertionError(f"[epipolar] {mode}: mask flips {flips}")
        err = float((got["rgb_feat"].float() - ref["rgb_feat"].float()).abs().max())
        del got, ref
        times = {"ms": _time_ms(lambda: kernel(*args), 20),
                 "plain_ms": _time_ms(lambda: plain(*args), 3)}
        times["bound_ms"] = sampler_bytes(v, r, s, hw, fhw, f, mode) / PEAK_BYTES_PER_S * 1e3
        parts.append(
            f"{mode}: {times['ms']:.4f} ms (plain {times['plain_ms']:.3f}), bound "
            f"{times['bound_ms']:.4f} ms (bytes; {times['bound_ms'] / times['ms']:.1%} of it), "
            f"rgb_feat err {err:.3e}, mask flips {flips}, in bounds "
            f"{float(kernel(*args)['mask_inbound'].float().mean()):.3f}")
        out[mode] = times
    log(f"[epipolar] tile R={r} S={s} V={v} {hw[0]}x{hw[1]}, features {fhw[0]}x{fhw[1]}x{f}, "
        "per launch: " + "; ".join(parts))
    return out


def slice_config(bundle=None, n_samples=256, preset="fast", **overrides):
    """The unmasked config (bundle None) or a named bundle, with
    ``n_samples`` coarse samples, on the fast preset (the JAX package's:
    patch without the dyn mask, quad with it), on it with quad sampling
    ("quad") or on the exact sampler ("exact"); then ``overrides`` (fine
    samples, render stride, another epipolar mode), as ``run.py`` applies a
    user's after the preset."""
    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset

    if preset not in ("fast", "quad", "exact"):
        raise KeyError(f"unknown preset {preset!r}; valid: fast | quad | exact")
    if bundle is not None:
        cfg = resolve_benchmark(bundle, preset="exact" if preset == "exact" else "fast")[0]
    else:
        cfg = RenderConfig() if preset == "exact" else apply_perf_preset(RenderConfig())
    if preset == "quad":
        cfg = cfg.replace(epipolar_mode="quad")
    return cfg.replace(n_coarse_samples_per_ray=n_samples, **overrides)


def _sampling_setup(models, data, cfg):
    """What render_image_gnt sets up before its tile loop: the resolved cfg
    and patch block, the sampling maps, the target's rays in image order
    and the render size (rh, rw) of ``cfg.render_stride``."""
    import torch

    from pgdvs_tpu_torch.core import cameras
    from pgdvs_tpu_torch.renderers.static_gnt import build_sampling_maps, resolve_epipolar_cfg

    fnet, gnt = models
    src = (data["static_rgb_src_spatial"] if cfg.gnt_use_masked_spatial_src
           else data["rgb_src_spatial"])
    masks = data["dyn_mask_src_spatial"] if cfg.gnt_use_dyn_mask else None
    h, w = src.shape[1:3]
    tgt = data["flat_cam_tgt"]
    with torch.no_grad():
        rays_o, rays_d, _uv, (rh, rw) = cameras.get_rays(
            h, w, cameras.flat_cam_intrinsics(tgt), cameras.flat_cam_c2w(tgt),
            stride=cfg.render_stride)
        cfg, block = resolve_epipolar_cfg(cfg, gnt, rh, rw)
        maps = build_sampling_maps(cfg, src, fnet(src), masks, block)
    return cfg, block, maps, rays_o, rays_d, (rh, rw)


def crop_on_cpu(models, data, cfg, rows, cols, keys=SLICE_TOL):
    """Static layer for a crop of the render's pixels (render coordinates,
    so every stride-th target pixel), rendered by the plain path on the CPU
    from the same sampling maps the card built, with the scalar or the
    per-pixel depth range of ``data``; outputs ``keys``. On patch
    the crop's rays go in the image's ray blocks (``rows`` and ``cols``
    aligned to the block) and come back in image order."""
    import copy

    import torch

    from pgdvs_tpu_torch.models.gnt.projector import PATCH_BLOCKS
    from pgdvs_tpu_torch.renderers.static_gnt import patch_ray_perm, render_rays_gnt

    cfg, block, maps, rays_o, rays_d, (_rh, rw) = _sampling_setup(models, data, cfg)
    tgt = data["flat_cam_tgt"]
    maps = (maps.cpu() if torch.is_tensor(maps)
            else type(maps)(*(t.cpu() if torch.is_tensor(t) else t for t in maps)))
    shape = (rows[1] - rows[0], cols[1] - cols[0])
    idx = (torch.arange(*rows)[:, None] * rw + torch.arange(*cols)[None]).reshape(-1)
    inv = None
    if block is not None:
        by, bx = PATCH_BLOCKS[block][0]
        if rows[0] % by or shape[0] % by or cols[0] % bx or shape[1] % bx:
            raise ValueError(f"crop {rows} x {cols} is not aligned to the {block} ray blocks")
        perm, inv = patch_ray_perm(idx.numel(), *shape, by, bx)
        idx = idx[perm]
    idx = idx.to(rays_o.device)
    dr = data["depth_range"]
    if dr.dim() == 1:
        dr = dr.expand(idx.numel(), 2)
    else:  # per pixel (DyCheck): the crop's rays' own ranges
        dr = dr[::cfg.render_stride, ::cfg.render_stride].reshape(-1, 2)[idx]
    with torch.no_grad():
        out = render_rays_gnt(
            copy.deepcopy(models[1]).cpu(), rays_o[idx].cpu(), rays_d[idx].cpu(),
            dr.cpu(), tgt.cpu(), data["flat_cam_src_spatial"].cpu(), maps, cfg)
    if inv is not None:
        out = {k: v[inv] for k, v in out.items()}
    return {k: out[k].reshape(shape + out[k].shape[1:]) for k in keys}


def check_crop(tag, models, data, cfg, layer, rows, cols, tol=SLICE_TOL):
    """A render's static layer (``layer``: its ``static_coarse_*`` maps) on
    ``rows`` x ``cols`` against the plain path on the CPU (``crop_on_cpu``)
    at ``tol``, the dyn count only with the dyn mask; the errors as text."""
    crop = crop_on_cpu(models, data, cfg, rows, cols, keys=tol)
    errs = {}
    for key, bound in tol.items():
        if key == "dyn_cnt" and not cfg.gnt_use_dyn_mask:
            continue
        a = layer[f"static_coarse_{key}"][rows[0]:rows[1], cols[0]:cols[1]].float().cpu()
        errs[key] = float((a - crop[key]).abs().max())
        if not errs[key] <= bound:
            raise AssertionError(f"{tag} crop {key}: max err {errs[key]} over {bound}")
    return " ".join(f"{k}={v:.3e}" for k, v in errs.items())


def clamp_fraction(models, data, cfg, fine=False):
    """The share of in-reach taps of a whole render that its patch sampler
    clamps to their block's border (``patch_clamp_counts`` summed over the
    ray tiles, rays in block order as the renderer sends them): of the
    coarse pass, or with ``fine`` of the second pass, whose samples come
    from a coarse pass run here on the card again."""
    import torch

    from pgdvs_tpu_torch.core import cameras, sampling
    from pgdvs_tpu_torch.kernels.gnt_fused import pack_mono4_weights
    from pgdvs_tpu_torch.models.gnt.projector import PATCH_BLOCKS, patch_clamp_counts
    from pgdvs_tpu_torch.renderers.static_gnt import gnt_pass, patch_ray_perm

    cfg, block, maps, rays_o, rays_d, (rh, rw) = _sampling_setup(models, data, cfg)
    perm, _inv = patch_ray_perm(rh * rw, rh, rw, *PATCH_BLOCKS[block][0], device=rays_o.device)
    src_cams = data["flat_cam_src_spatial"]
    proj = cameras.flat_cam_projection(src_cams)
    params = pack_mono4_weights(models[1], rays_o.device) if fine else None
    clamped = reach = 0
    with torch.no_grad():
        for i in range(0, rh * rw, cfg.ray_tile):
            t = perm[i:i + cfg.ray_tile]
            pts, z = sampling.sample_along_rays(
                rays_o[t], rays_d[t], data["depth_range"].expand(t.numel(), 2),
                cfg.n_coarse_samples_per_ray, inv_uniform=cfg.sample_inv_uniform)
            if fine:
                w = gnt_pass(params, pts, z, rays_d[t], data["flat_cam_tgt"], src_cams, maps,
                             cfg)["weights"]
                z = sampling.sample_fine_z_vals(z, w, cfg.n_fine_samples_per_ray,
                                                inv_uniform=cfg.sample_inv_uniform)
                pts = rays_o[t][:, None, :] + z[..., None] * rays_d[t][:, None, :]
            c, n = patch_clamp_counts(pts, proj, maps)
            clamped, reach = clamped + int(c), reach + int(n)
    return clamped / max(reach, 1), clamped, reach


def dyn_points_kept(data, cfg):
    """(kept, candidates): dynamic points of the render's cloud with and
    without the configured outlier removal."""
    from pgdvs_tpu_torch.renderers.dynamic import compute_dyn_pointcloud

    kw = dict(
        rgb_1=data["rgb_src_temporal"][0], dyn_mask_1=data["dyn_mask_src_temporal"][0],
        depth_1=data["depth_src_temporal"][0], flow_12=data["flow_fwd"],
        flow_12_occ_mask=data["flow_fwd_occ_mask"], rgb_2=data["rgb_src_temporal"][1],
        depth_2=data["depth_src_temporal"][1], cam_1=data["flat_cam_src_temporal"][0],
        cam_2=data["flat_cam_src_temporal"][1], cam_tgt=data["flat_cam_tgt"],
        time_1=data["time_src_temporal"][0], time_2=data["time_src_temporal"][1],
        time_tgt=data["time_tgt"][0])
    kept = int(compute_dyn_pointcloud(cfg=cfg, **kw)["valid"].sum())
    cand = int(compute_dyn_pointcloud(
        cfg=cfg.replace(dyn_pcl_remove_outlier=False), **kw)["valid"].sum())
    return kept, cand


PROLOGUE_ROWS = ("rgb_feat", "patch", "quad_rows")
# the epipolar sampler kernel's modes (``kernels/epipolar.py``)
SAMPLER_MODES = ("exact", "quad_masked")
KERNELS = ("gnt_fused_mono4", "gnt_fused_mono4_patch", "gnt_fused_mono3",
           "gnt_split_view", "gnt_split_ray",
           *(f"gnt_fused_apply_mono3[{mode}]" for mode in MONO3_MODES),
           *(f"gnt_prologue[{src}]" for src in PROLOGUE_ROWS),
           *(f"epipolar[{mode}]" for mode in SAMPLER_MODES))


def _launch_counters():
    """{kernel name: wrapper} of the wrappers with a plain launch count, and
    {row name prefix: wrapper} of those whose count is a Counter
    (``gnt_fused_apply_mono3`` per operand mode, ``gnt_prologue`` per
    source, the ``epipolar`` sampler module per mode)."""
    from pgdvs_tpu_torch.kernels import epipolar
    from pgdvs_tpu_torch.kernels.gnt_fused import gnt_fused_mono4
    from pgdvs_tpu_torch.kernels.gnt_fused_mono3 import gnt_fused_apply_mono3, gnt_fused_mono3
    from pgdvs_tpu_torch.kernels.gnt_fused_patch import gnt_fused_mono4_patch
    from pgdvs_tpu_torch.kernels.gnt_fused_split import gnt_split_ray, gnt_split_view
    from pgdvs_tpu_torch.kernels.gnt_prologue import gnt_prologue

    return ({"gnt_fused_mono4": gnt_fused_mono4, "gnt_fused_mono4_patch": gnt_fused_mono4_patch,
             "gnt_fused_mono3": gnt_fused_mono3, "gnt_split_view": gnt_split_view,
             "gnt_split_ray": gnt_split_ray},
            {"gnt_fused_apply_mono3": (gnt_fused_apply_mono3, MONO3_MODES),
             "gnt_prologue": (gnt_prologue, PROLOGUE_ROWS),
             "epipolar": (epipolar, SAMPLER_MODES)})


def reset_launches():
    """Set every kernel's launch count to 0."""
    import collections

    plain, keyed = _launch_counters()
    for fn in plain.values():
        fn.launches = 0
    for fn, _keys in keyed.values():
        fn.launches = collections.Counter()


def read_launches():
    """{kernel name: launches since reset_launches}; a K2 mode or a
    prologue source by its row name (every key that launched, and
    MONO3_MODES / PROLOGUE_ROWS)."""
    plain, keyed = _launch_counters()
    counts = {name: fn.launches for name, fn in plain.items()}
    for prefix, (fn, keys) in keyed.items():
        for key in (*keys, *fn.launches):
            counts[f"{prefix}[{key}]"] = fn.launches[key]
    return counts


def expected_launches(cfg, n_rays, plain=False):
    """{kernel name: launches} of one render of ``n_rays`` rays under
    ``cfg`` (resolved: ``resolve_epipolar_cfg``), once per ray tile and
    pass (two with fine samples): K2's unfolded mode on exact, K1's
    patch_rows mode on patch, K2 on fused, K2 with the dyn mask and K1
    without it on quad and quad_i8; every other kernel none, and none at
    all for a GNT made with ret_view_std (``plain``: the plain network).
    The sampler kernel launches as often on exact and on quad with the dyn
    mask, whatever network follows it."""
    launches = -(-n_rays // cfg.ray_tile) * (2 if cfg.n_fine_samples_per_ray > 0 else 1)
    mode = cfg.epipolar_mode
    if mode == "exact":
        name = "gnt_fused_apply_mono3[unfolded]"
    elif mode == "patch":
        name = "gnt_fused_mono4_patch"
    elif mode == "fused" or cfg.gnt_use_dyn_mask:
        name = "gnt_fused_mono3"
    else:
        name = "gnt_fused_mono4"
    want = {k: 0 if plain or k != name else launches for k in KERNELS}
    if mode == "exact":
        want["epipolar[exact]"] = launches
    elif mode == "quad" and cfg.gnt_use_dyn_mask:
        want["epipolar[quad_masked]"] = launches
    return want


def phase_main_path(models, bundle=None, device="cuda", h=288, w=550,
                    n_spatial=10, n_frames=12, n_samples=256, rows=(140, 144),
                    cols=(200, 264), n_timed=2, preset="fast", tag=None, tol=SLICE_TOL,
                    data=None, require_outliers=True, tracker=None, **overrides):
    """Drive render_novel_view once for the unmasked config (bundle None:
    on the fast preset patch, K1's patch_rows mode; on "quad" K1) or a
    named bundle (``default``: K2's path; on the exact preset K2 unfolded),
    with ``overrides`` (``slice_config``), the kernels' launch counts set to
    0 just before and read just after; check it (the crop of rows x cols of
    the render, at ``tol``), then time it. The view is the synthetic scene
    at h x w, or ``data``, a contract already on ``device`` (a reader's
    item), whose dynamic cloud need not hold an outlier for the removal to
    drop (``require_outliers=False``); ``tracker`` goes to every render (the
    track branch). Returns ({kernel name: launches}, seconds per view, the
    timed render's output)."""
    import warnings

    import torch

    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.static_gnt import resolve_epipolar_cfg

    if data is None:
        data = contract_to_device(make_contract_data(h=h, w=w, n_spatial=n_spatial,
                                                     n_frames=n_frames, tgt_time=0.5), device)
    n_spatial, h, w = data["rgb_src_spatial"].shape[:3]
    cfg = slice_config(bundle, n_samples, preset, **overrides)
    stride = cfg.render_stride
    rh, rw = -(-h // stride), -(-w // stride)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the full-size render takes no fallback
        resolved = resolve_epipolar_cfg(cfg, models[1], rh, rw)[0]
    tag = tag or f"[{bundle or 'main'}]"

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def render():
        gen = torch.Generator(device=device).manual_seed(SEED)
        out = render_novel_view(models, data, cfg, generator=gen, tracker=tracker)
        sync()
        return out

    reset_launches()
    t0 = time.perf_counter()
    out = render()
    first = time.perf_counter() - t0
    launches = read_launches()
    want = expected_launches(resolved, rh * rw, plain=models[1].ret_view_std)
    if device == "cuda" and launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    rgb = out["combined_rgb"]
    if tuple(rgb.shape) != (rh, rw, 3) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"combined_rgb {tuple(rgb.shape)} not finite/[{rh},{rw},3]")
    n_fine = cfg.n_fine_samples_per_ray
    log(f"{tag} {h}x{w}, {n_spatial} sources, {n_samples} samples"
        + (f" + {n_fine} fine" if n_fine else "")
        + (f", stride {stride}: a {rh}x{rw} render" if stride > 1 else "")
        + f", {resolved.epipolar_mode} sampling: first render {first:.3f} s (warm-up), "
        f"launches {launches}")
    if stride > 1:
        shapes = {k: tuple(out[k].shape) for k in ("render_dyn_rgb", "render_dyn_mask")}
        if shapes != {"render_dyn_rgb": (rh, rw, 3), "render_dyn_mask": (rh, rw, 1)}:
            raise AssertionError(f"{tag} the dynamic layer was not resized: {shapes}")
        log(f"{tag} dynamic layer resized from {h}x{w} to {shapes} (cubic rgb, nearest "
            f"mask); mask covers {float(out['render_dyn_mask'].mean()):.4f} of the render")

    log(f"{tag} crop rows {rows} cols {cols} vs plain path on CPU: "
        + check_crop(tag, models, data, cfg, out, rows, cols, tol))
    if resolved.epipolar_mode == "patch":
        frac, clamped, reach = clamp_fraction(models, data, cfg)
        log(f"{tag} patch_clamp_fraction {frac:.6e} ({clamped} of {reach} in-reach taps "
            "clamped to their block's border)")
        if n_fine:
            frac, clamped, reach = clamp_fraction(models, data, cfg, fine=True)
            log(f"{tag} patch_clamp_fraction of the fine pass {frac:.6e} ({clamped} of "
                f"{reach} in-reach taps clamped to their block's border)")
    if models[1].ret_view_std:
        for key in ("view_std", "view_std_normalized"):
            m = out[f"static_coarse_{key}"]
            if not (bool(torch.isfinite(m).all()) and float(m[..., 0].min()) > 0):
                raise AssertionError(f"{tag} {key} not finite and non-zero")
            log(f"{tag} {key} {tuple(m.shape)}: mean per entry "
                + " ".join(f"{float(x):.4f}" for x in m.mean(dim=(0, 1))))
    if cfg.gnt_use_dyn_mask:
        dyn = out["static_coarse_dyn_cnt"][rows[0]:rows[1], cols[0]:cols[1]]
        if not bool((dyn > 0).any()):
            raise AssertionError(f"{tag} the crop saw no dynamic view")
        log(f"{tag} crop rays with a dynamic view: {int((dyn > 0).sum())} of {dyn.numel()}; "
            f"image rays: {int((out['static_coarse_dyn_cnt'] > 0).sum())} of {rh * rw}")
    if cfg.dyn_pcl_remove_outlier:
        kept, cand = dyn_points_kept(data, cfg)
        if not (0 < kept < cand or (0 < kept == cand and not require_outliers)):
            raise AssertionError(f"{tag} outlier removal kept {kept} of {cand}")
        log(f"{tag} dynamic points kept by outlier removal: {kept} of {cand}")

    secs = []
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for _ in range(n_timed):
        t0 = time.perf_counter()
        out = render()
        secs.append(time.perf_counter() - t0)
    log(f"{tag} s/view over {n_timed} timed runs: mean {statistics.mean(secs):.4f} "
        f"min {min(secs):.4f} max {max(secs):.4f} runs {secs}")
    if device == "cuda":
        log(f"{tag} peak device memory of a render: "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return launches, secs, out


# the JAX package's fast-against-exact delta of the masked bundle at this
# scale, random weights (docs/BENCHMARK.md:60-66): a quality anchor, not a time
JAX_QUAD_VS_EXACT = {"psnr_db": 37.19, "ssim": 0.9963}


def exact_vs_quad(exact_rgb, quad_rgb, tag="[exact]", what="combined_rgb", label="exact"):
    """Full-image PSNR and SSIM (uint8-quantized, full mask) of one render's
    image ``what`` (the exact render's, or the one ``label`` names) against
    the quad render's, same view."""
    import numpy as np

    from pgdvs_tpu_torch.metrics.psnr_ssim import masked_psnr, masked_ssim, quantize_uint8

    a = quantize_uint8(exact_rgb.float().cpu().numpy())
    b = quantize_uint8(quad_rgb.float().cpu().numpy())
    full = np.ones_like(a)
    psnr, ssim = masked_psnr(a, b, full), masked_ssim(a, b, full)
    anchor = ("; the JAX package's fast-vs-exact anchor (masked bundle, random weights): "
              f"{JAX_QUAD_VS_EXACT['psnr_db']} dB / {JAX_QUAD_VS_EXACT['ssim']}"
              if label == "exact" else "")
    log(f"{tag} {label} vs quad ({what}): PSNR {psnr:.3f} dB, SSIM {ssim:.5f}{anchor}")
    if not (np.isfinite(psnr) and psnr > 25.0 and ssim > 0.9):
        raise AssertionError(f"{tag} {label} and quad renders disagree: {psnr} dB, {ssim}")
    return psnr, ssim


def phase_new_modes(models, quad_img):
    """The renderer's modes of the JAX package that feed the ported kernels
    at new shapes, each one render through ``render_novel_view`` checked as
    ``phase_main_path`` checks: fine samples (64 on 256) on the fast preset
    (K1 patch_rows twice per tile) and on `default` exact (K2 unfolded at
    S = 320), `default` quad at render stride 2, the unmasked fused and
    quad_i8 samplers (K2 and K1, PSNR / SSIM against [quad]'s image of the
    same view), and the view-std diagnostics (a GNT made with ret_view_std:
    the plain network on the card, no kernel launch) at 64x96."""
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    # one timed render each (a second took ~10 s of the script's time)
    phase_main_path(models, n_fine_samples_per_ray=64, tag="[fine]", n_timed=1)
    phase_main_path(models, bundle="default", preset="exact", cols=(160, 224),
                    n_fine_samples_per_ray=64, tag="[fine-exact]", n_timed=1)
    phase_main_path(models, bundle="default", rows=(70, 74), cols=(80, 144), render_stride=2,
                    tag="[stride2]")
    for mode in ("fused", "quad_i8"):
        _, _, out = phase_main_path(models, epipolar_mode=mode, tag=f"[{mode}]")
        for what in quad_img:
            exact_vs_quad(out[what], quad_img[what], tag=f"[{mode}]", what=what, label=mode)
        del out
    std_models = init_gnt_models(seed=SEED, device="cuda", ret_view_std=True)
    phase_main_path(std_models, h=64, w=96, rows=(16, 20), cols=(32, 64), n_timed=1,
                    preset="quad", tag="[view_std]",
                    tol={**SLICE_TOL, "view_std": VIEW_STD_TOL,
                         "view_std_normalized": VIEW_STD_TOL})


# ----------------------------------------------------------------- JPEG writer
# zig-zag position k -> natural (row-major) index of the 8x8 block
JPEG_NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# ITU-T T.81 Annex K.1 quantisation tables (natural order)
JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
    104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
JPEG_CHROMA_Q = np.full(64, 99)
JPEG_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# Annex K.3 Huffman tables: (code counts per length 1-16, symbols)
JPEG_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
JPEG_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
JPEG_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272820"
    "90a161718191a25262728292a3435363738393a434445464748494a535455565758595a6364"
    "65666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8"
    "a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9"
    "eaf1f2f3f4f5f6f7f8f9fa"))
JPEG_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a16"
    "2434e125f11718191a262728292a35363738393a434445464748494a535455565758595a6364"
    "65666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7"
    "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9"
    "eaf2f3f4f5f6f7f8f9fa"))


def _jpeg_quant(base, quality):
    """libjpeg's jpeg_quality_scaling of an Annex K table, baseline-clamped."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huff_codes(table):
    """symbol -> (code, length) arrays of the canonical code of ``table``."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix():
    n = np.arange(8)
    c = np.sqrt(2.0 / 8) * np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    c[0] /= np.sqrt(2.0)
    return c


def encode_jpeg(rgb, quality=95):
    """Baseline JFIF bytes of a uint8 [H, W, 3] image: YCbCr, 4:2:0 (chroma
    the mean of each 2x2), the float DCT, the Annex K tables scaled to
    ``quality`` and the Annex K Huffman tables. numpy only."""
    rgb = np.asarray(rgb)
    h, w = rgb.shape[:2]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(rgb.astype(np.float64), ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    sub = [c.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3)) for c in (cb, cr)]
    qt = [_jpeg_quant(JPEG_LUMA_Q, quality), _jpeg_quant(JPEG_CHROMA_Q, quality)]
    dct = _dct_matrix()

    def blocks(plane, q):
        """[rows, cols, 64] quantised coefficients in zig-zag order."""
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        blk = (plane - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dct @ blk @ dct.T
        return np.rint(coef.reshape(bh, bw, 64) / q)[..., JPEG_NATURAL_ORDER].astype(np.int64)

    yq, cbq, crq = blocks(y, qt[0]), blocks(sub[0], qt[1]), blocks(sub[1], qt[1])
    my, mx = ph // 16, pw // 16
    # MCU order: Y00 Y01 Y10 Y11 Cb Cr
    yq = yq.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    seq = np.concatenate([yq, cbq[:, :, None], crq[:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    nblk = seq.shape[0]

    dc = seq[:, 0].copy()
    diff = np.empty_like(dc)
    for c in range(3):
        sel = comp == c
        diff[sel] = np.diff(dc[sel], prepend=0)
    codes = [_huff_codes(t) for t in (JPEG_DC_LUMA, JPEG_AC_LUMA, JPEG_DC_CHROMA, JPEG_AC_CHROMA)]
    is_chroma = comp > 0

    def category(v):
        a = np.abs(v)
        return np.where(a == 0, 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1)

    def extra(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)

    # events: (block, key, value, length)
    ev_blk, ev_key, ev_val, ev_len = [], [], [], []
    s = category(diff)
    dcode = np.where(is_chroma, codes[2][0][s], codes[0][0][s])
    dlen = np.where(is_chroma, codes[2][1][s], codes[0][1][s])
    ev_blk.append(np.arange(nblk))
    ev_key.append(np.zeros(nblk, np.int64))
    ev_val.append((dcode << s) | extra(diff, s))
    ev_len.append(dlen + s)
    bi, k = np.nonzero(seq[:, 1:])
    k = k + 1
    prev = np.where(np.r_[True, bi[1:] != bi[:-1]], 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    n_zrl = run // 16
    run = run % 16
    v = seq[bi, k]
    s = category(v)
    ch = is_chroma[bi]
    sym = run * 16 + s
    ev_blk.append(bi)
    ev_key.append(k * 8 + 7)
    ev_val.append((np.where(ch, codes[3][0][sym], codes[1][0][sym]) << s) | extra(v, s))
    ev_len.append(np.where(ch, codes[3][1][sym], codes[1][1][sym]) + s)
    zi = np.repeat(np.arange(bi.size), n_zrl)
    zj = np.arange(zi.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
    zch = ch[zi]
    ev_blk.append(bi[zi])
    ev_key.append(k[zi] * 8 + zj)
    ev_val.append(np.where(zch, codes[3][0][0xF0], codes[1][0][0xF0]))
    ev_len.append(np.where(zch, codes[3][1][0xF0], codes[1][1][0xF0]))
    last = np.zeros(nblk, np.int64)
    np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    ev_blk.append(eob)
    ev_key.append(np.full(eob.size, 64 * 8))
    ev_val.append(np.where(is_chroma[eob], codes[3][0][0], codes[1][0][0]))
    ev_len.append(np.where(is_chroma[eob], codes[3][1][0], codes[1][1][0]))
    blk, key = np.concatenate(ev_blk), np.concatenate(ev_key)
    order = np.lexsort((key, blk))
    val, length = np.concatenate(ev_val)[order], np.concatenate(ev_len)[order]
    starts = np.cumsum(length) - length
    total = int(length.sum())
    idx = np.repeat(np.arange(val.size), length)
    j = np.arange(total) - starts[idx]
    bits = ((val[idx] >> (length[idx] - 1 - j)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])  # pad with 1s
    data = np.packbits(bits)
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).astype(np.uint8).tobytes()

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(qt):
        out += seg(0xDB, bytes([t]) + bytes(q[JPEG_NATURAL_ORDER].astype(np.uint8)))
    out += seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
               + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for tc_th, (counts, symbols) in ((0x00, JPEG_DC_LUMA), (0x10, JPEG_AC_LUMA),
                                      (0x01, JPEG_DC_CHROMA), (0x11, JPEG_AC_CHROMA)):
        out += seg(0xC4, bytes([tc_th]) + bytes(counts) + bytes(symbols))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + data + b"\xff\xd9"


# the [reader] phase's scene: the NVIDIA layout, 24 frames on the 12-camera
# round robin, raw images at twice the eval size (576x1100 -> 288x550)
READER_SCENE = "Balloon1"
READER_FRAMES = 24
READER_RAW_HW = (576, 1100)
READER_EVAL_HW = (288, 550)
# (frame, camera) of the items read: two targets in the mono video with both
# temporal neighbours, then a held-out camera
READER_ITEMS = ((11, 11), (12, 0), (12, 5))
# ranges of frames between which flows are written (intervals 1 and 2):
# those the items' temporal pairs read, and those of the first three items
# of the scene, which [eval] scores
READER_FLOW_FRAMES = ((0, 4), (10, 14))
READER_STAGES = ("decode", "lanczos", "inter_area", "nearest", "npz_npy", "depth_range")


def write_reader_scene(root, raw_hw=READER_RAW_HW, eval_hw=READER_EVAL_HW,
                       n_frames=READER_FRAMES, items=READER_ITEMS,
                       flow_frames=READER_FLOW_FRAMES, seed=SEED, jpeg_quality=None):
    """Write the synthetic scene (``data/synthetic.py``) under ``root`` in
    the NVIDIA layout that ``NvidiaEvalDataset`` reads with its default
    directory names, through the port's ``write_png`` (and ``encode_jpeg``)
    only: per frame the mono camera's image (frame % 12) and those of
    ``items``, each with its 8-bit eval mask, at ``raw_hw``, the rgb with the
    filter types cycled row by row, or, with ``jpeg_quality``, as baseline
    JPEG (``encode_jpeg``, 4:2:0) as the real DynIBaR frames are; the mono
    frame's 1-bit dynamic mask and its disparity (.npy,
    float32) at ``raw_hw``; the ``images_<w>x<h>`` marker of the eval size;
    flows at ``eval_hw``, intervals 1 and 2, between the frames of each
    (start, stop) range of ``flow_frames``, with a coord_diff from ``seed``
    that marks ~6 % of the pixels occluded; and ``poses_bounds_cvd.npy`` in LLFF's convention.
    Cameras are the synthetic arc's, 12 of them; frame f is seen from
    camera f % 12 at time f / (n_frames - 1). Returns the PSNR (dB) of each
    JPEG frame's decode (``read_jpeg``) against its source (empty for PNG)."""
    import numpy as np

    from pgdvs_tpu_torch.data import synthetic
    from pgdvs_tpu_torch.data.image_io import read_jpeg, write_png

    (rh, rw), (eh, ew) = raw_hw, eval_hw
    dense = root / "nvidia_long" / READER_SCENE / "dense"
    disp_dir = root / "nvidia_long_depths" / READER_SCENE / "disp"
    flow_root = root / "nvidia_long_flow_mask" / READER_SCENE / "dense"
    for d in (dense / "mv_images", dense / "mv_masks", disp_dir, flow_root / "masks/final",
              dense / f"images_{ew}x{eh}"):
        d.mkdir(parents=True, exist_ok=True)
    times = np.linspace(0.0, 1.0, n_frames)
    cams = [synthetic.camera_pose(c, 13) for c in range(12)]  # an open arc: no two alike
    focal = synthetic.intrinsics(rh, rw)[0, 0]
    rows = []
    for f in range(n_frames):
        c2w = cams[f % 12].copy()
        c2w[..., 1:3] *= -1  # OpenCV -> [right, up, back]
        m = c2w[:3, :4]
        llff = np.concatenate([-m[:, 1:2], m[:, 0:1], m[:, 2:4]], axis=1)  # [down, right, back]
        hwf = np.array([[rh], [rw], [focal]])
        rows.append(np.concatenate([llff, hwf], axis=1).ravel().tolist() + [0.1, 10.0])
    np.save(dense / "poses_bounds_cvd.npy", np.asarray(rows))
    psnrs = []
    for f in range(n_frames):
        frame_dir, eval_dir = dense / f"mv_images/{f:05d}", dense / f"mv_masks/{f:05d}"
        frame_dir.mkdir()
        eval_dir.mkdir()
        for c in sorted({f % 12} | {c for ff, c in items if ff == f}):
            fr = synthetic.render_frame(rh, rw, cams[c], times[f])
            rgb = (fr["rgb"] * 255).astype(np.uint8)
            if jpeg_quality is None:
                write_png(frame_dir / f"cam{c + 1:02d}.png", rgb, "cycle")
            else:
                data = encode_jpeg(rgb, jpeg_quality)
                (frame_dir / f"cam{c + 1:02d}.jpg").write_bytes(data)
                err = np.mean((read_jpeg(data).astype(np.float64) - rgb) ** 2)
                psnrs.append(10.0 * np.log10(255.0 ** 2 / err))
            write_png(eval_dir / f"cam{c + 1:02d}.png",
                      (fr["dyn_mask"][..., 0] * 255).astype(np.uint8))
            if c == f % 12:
                write_png(flow_root / f"masks/final/{f:05d}_final.png", fr["dyn_mask"][..., 0] > 0)
                np.save(disp_dir / f"{f:05d}.npy", (1.0 / fr["depth"][..., 0]).astype(np.float32))
    rng = np.random.default_rng(seed)
    frames = {f: synthetic.render_frame(eh, ew, cams[f % 12], times[f])
              for start, stop in flow_frames for f in range(start, stop)}
    for interval in (1, 2):
        (flow_root / f"flows/interval_{interval}").mkdir(parents=True)
        for a in (a for start, stop in flow_frames for a in range(start, stop - interval)):
            for i, j in ((a, a + interval), (a + interval, a)):
                flow = synthetic.flow_between(eh, ew, frames[i], cams[i % 12], times[i],
                                              cams[j % 12], times[j])
                np.savez(flow_root / f"flows/interval_{interval}/{i:05d}_{j:05d}.npz",
                         flow=flow, coord_diff=rng.uniform(0, 0.6, (eh, ew, 2)).astype(np.float32))
    return psnrs


IPHONE_SCENE = "paper-windmill"
IPHONE_HW = (360, 480)       # the factor-2 (processed) size of the iPhone captures
IPHONE_TRAIN = 24
IPHONE_GAP = 11              # the time missing from the train video
IPHONE_CENTER = (0.1, -0.05, 0.2)
IPHONE_SCALE = 0.8


def write_iphone_capture(root, hw=IPHONE_HW, n_train=IPHONE_TRAIN, gap=IPHONE_GAP,
                         factor=2, seed=SEED):
    """Write the synthetic scene under ``root`` as a DyCheck iPhone capture
    (``<root>/raw/<IPHONE_SCENE>``, the layout ``DyCheckIPhoneEvalDataset``
    reads), through the port's ``write_png`` only: the train video is camera
    0 on the synthetic arc at times 0..n_train except ``gap``; the val frames
    are camera 1 (the arc shifted by 0.05 along x) at times gap - 1 (a train
    time: one temporal source) and gap (between two train times). Per frame:
    RGBA at ``hw`` (the factor-``factor`` size), the z-depth .npy in the
    capture's units, the camera json at full resolution, its position and
    the depths in the world that ``scene.json``'s centre and scale
    normalize back to the synthetic one; per train frame its 1-bit dynamic
    mask under ``<root>/masks``; per val frame a covisible mask (its left
    eighth not covisible); forward and backward flows under ``<root>/flows``
    between the train frames either side of the gap, with a coord_diff from
    ``seed`` that marks ~6 % of the pixels occluded. Returns the scene's
    directory."""
    import json

    import numpy as np

    from pgdvs_tpu_torch.data import synthetic
    from pgdvs_tpu_torch.data.image_io import write_png

    h, w = hw
    scene = root / "raw" / IPHONE_SCENE
    masks = root / "masks" / IPHONE_SCENE / "masks/final"
    flows = root / "flows" / IPHONE_SCENE / "flows/interval_1"
    for d in (scene / "splits", scene / "camera", scene / f"rgb/{factor}x",
              scene / f"depth/{factor}x", scene / f"covisible/{factor}x/val", masks, flows):
        d.mkdir(parents=True, exist_ok=True)
    times = [t for t in range(n_train + 1) if t != gap]
    train = [(t, 0) for t in times]
    val = [(gap - 1, 1), (gap, 1)]
    names = {f: f"{f[1]}_{f[0]:05d}" for f in train + val}
    center, scale = np.asarray(IPHONE_CENTER), IPHONE_SCALE
    k = synthetic.intrinsics(h, w)

    def pose(t, cam):
        c2w = synthetic.camera_pose(t, n_train + 1)
        c2w[:2, 3] += np.array([0.05, 0.02]) * cam
        return c2w

    def dump(path, obj):
        path.write_text(json.dumps(obj))

    dump(scene / "scene.json", {"center": list(center), "scale": scale, "near": 0.5,
                                "far": 20.0})
    dump(scene / "dataset.json", {"count": len(names), "ids": list(names.values())})
    dump(scene / "metadata.json", {n: {"warp_id": t, "camera_id": c, "appearance_id": t}
                                   for (t, c), n in names.items()})
    dump(scene / "extra.json", {"factor": factor, "fps": 30})
    for split, frames in (("train", train), ("val", val)):
        dump(scene / "splits" / f"{split}.json", {
            "frame_names": [names[f] for f in frames], "time_ids": [t for t, _ in frames],
            "camera_ids": [c for _, c in frames]})
    rendered = {}
    for (t, cam), name in names.items():
        c2w = pose(t, cam)
        fr = synthetic.render_frame(h, w, c2w, t / n_train)
        rendered[(t, cam)] = (fr, c2w)
        dump(scene / "camera" / f"{name}.json", {
            "orientation": np.eye(3).tolist(),
            "position": list(c2w[:3, 3] / scale + center),
            "focal_length": float(k[0, 0]) * factor,
            "principal_point": [float(k[0, 2]) * factor, float(k[1, 2]) * factor],
            "image_size": [w * factor, h * factor], "skew": 0.0, "pixel_aspect_ratio": 1.0})
        rgb = (fr["rgb"] * 255).astype(np.uint8)
        write_png(scene / f"rgb/{factor}x" / f"{name}.png",
                  np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1))
        np.save(scene / f"depth/{factor}x" / f"{name}.npy",
                (fr["depth"] / scale).astype(np.float32))
        if cam == 0:
            write_png(masks / f"{name}_final.png", fr["dyn_mask"][..., 0] > 0)
        else:
            covis = np.full((h, w), 255, np.uint8)
            covis[:, :w // 8] = 0
            write_png(scene / f"covisible/{factor}x/val" / f"{name}.png", covis)
    rng = np.random.default_rng(seed)
    for a, b in (((gap - 1, 0), (gap + 1, 0)), ((gap + 1, 0), (gap - 1, 0))):
        (fa, ca), (_fb, cb) = rendered[a], rendered[b]
        flow = synthetic.flow_between(h, w, fa, ca, a[0] / n_train, cb, b[0] / n_train)
        np.savez(flows / f"{names[a]}_{names[b]}.npz", flow=flow,
                 coord_diff=rng.uniform(0, 0.6, (h, w, 2)).astype(np.float32))
    return scene


class StageTimer:
    """Host seconds spent in named functions while the context is open:
    each (object, attribute, stage) of ``targets`` is wrapped and its time
    added to its stage; the originals are put back on exit."""

    def __init__(self, targets):
        import collections

        self.targets = targets
        self.seconds = collections.defaultdict(float)

    def _timed(self, fn, stage):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.seconds[stage] += time.perf_counter() - t0
            return out

        return wrapped

    def __enter__(self):
        self._saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _stage in self.targets]
        for (obj, attr, fn), (_o, _a, stage) in zip(self._saved, self.targets):
            setattr(obj, attr, self._timed(fn, stage))
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)
        return False


class ReaderStageTimes(StageTimer):
    """Host seconds of one reader's stages while the context is open, by
    wrapping the functions ``pgdvs_tpu_torch.data.nvidia_eval`` calls (its
    decode, resizes and array loads, and the dataset's depth range); the
    image files it decoded. For one thread (a loader with 0 workers)."""

    WRAPPED = {"read_image": "decode", "resize_lanczos_pil": "lanczos",
               "resize_area": "inter_area", "resize_nearest_cv": "nearest",
               "resize_nearest_pil": "nearest", "load_arrays": "npz_npy"}

    def __init__(self):
        from pgdvs_tpu_torch.data import nvidia_eval

        super().__init__([(nvidia_eval, name, stage) for name, stage in self.WRAPPED.items()]
                         + [(nvidia_eval.NvidiaEvalDataset, "depth_range", "depth_range")])
        self.pngs = []

    def _timed(self, fn, stage):
        timed = super()._timed(fn, stage)
        if stage != "decode":
            return timed

        def decode(*args, **kwargs):
            self.pngs.append(args[0])
            return timed(*args, **kwargs)

        return decode


def check_reader_item(item, n_spatial, hw):
    """Every contract key of the reader's non-geo, non-track branch at the
    shape ``data/contract.py`` gives (S sources, T = 2), finite, and a
    depth range that is positive and increasing."""
    import numpy as np

    from pgdvs_tpu_torch.data.contract import RENDER_CONTRACT_KEYS

    dims = {"H": hw[0], "W": hw[1], "S": n_spatial, "T": 2}
    for key, shape in RENDER_CONTRACT_KEYS.items():
        if key.startswith("st_pcl") or "track" in key:
            continue
        want = (1 + n_spatial + 2,) if key == "seq_ids" else tuple(dims.get(d, d) for d in shape)
        if key not in item or item[key].shape != want:
            raise AssertionError(f"[reader] {key}: {getattr(item.get(key), 'shape', None)}, "
                                 f"expected {want}")
        if not np.isfinite(item[key]).all():
            raise AssertionError(f"[reader] {key} is not finite")
    lo, hi = item["depth_range"]
    if not 0 < lo < hi:
        raise AssertionError(f"[reader] depth range {item['depth_range']}")


def phase_reader(models, root, device="cuda", raw_hw=READER_RAW_HW, eval_hw=READER_EVAL_HW,
                 n_samples=256, rows=(140, 144), cols=(240, 304)):
    """[reader]: the NVIDIA reader from disk into the `default` render.

    Writes ``write_reader_scene`` into the directory ``root``, then reads
    the READER_ITEMS through ``NvidiaEvalDataset`` with 0 workers, host time
    per stage (``ReaderStageTimes``), and checks their contract keys; holds
    the C un-filter against its numpy plain version on every PNG of the
    first item (both timed); moves the items with ``to_device_prefetch`` and
    holds each device tensor against its host array bit for bit after a
    synchronize (ms per item, twice: pinned buffers allocated, then
    reused); renders each with ``default`` on the fast
    preset through ``phase_main_path`` (78 K2 launches per view at 288x550,
    finite output, a crop against the plain path on the CPU under
    SLICE_TOL); then times the 3-item loop through ``PrefetchLoader(
    n_workers=2)`` and ``to_device_prefetch``: s/view and the share of its
    wall time outside the renders."""
    import numpy as np
    import torch

    from pgdvs_tpu_torch.data.image_io import read_png
    from pgdvs_tpu_torch.data.loader import PrefetchLoader, to_device_prefetch
    from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset
    from pgdvs_tpu_torch.renderers.compose import render_novel_view

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    write_reader_scene(root, raw_hw, eval_hw)
    t_write = time.perf_counter() - t0
    ds = NvidiaEvalDataset(root, scene_ids=[READER_SCENE], tgt_height=eval_hw[0])
    index = {(f, c): i for i, (_s, f, c, _p) in enumerate(ds.items)}
    idx = [index[fc] for fc in READER_ITEMS]
    items, stages, pngs = [], [], []
    for i in idx:
        with ReaderStageTimes() as timer:
            t0 = time.perf_counter()
            item = ds[i]
            timer.seconds["total"] = time.perf_counter() - t0
        check_reader_item(item, ds.n_spatial, eval_hw)
        items.append(item)
        stages.append(dict(timer.seconds))
        pngs.append(timer.pngs)
    n_px = sum(read_png(f).size for f in pngs[0])
    t_native = t_plain = 0.0
    for f in pngs[0]:
        t0 = time.perf_counter()
        a = read_png(f)
        t_native += time.perf_counter() - t0
        t0 = time.perf_counter()
        b = read_png(f, native=False)
        t_plain += time.perf_counter() - t0
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"[reader] native and plain un-filter differ on {f}")
    log(f"[reader] scene {raw_hw[0]}x{raw_hw[1]} raw -> {eval_hw[0]}x{eval_hw[1]}, "
        f"{READER_FRAMES} frames, written in {t_write:.3f} s; items (frame, camera) "
        f"{list(READER_ITEMS)} read, contract keys and shapes checked")
    log(f"[reader] native un-filter == numpy plain on all {len(pngs[0])} PNGs of the first "
        f"item ({n_px} values): decode {1e3 * t_native:.2f} ms native, "
        f"{1e3 * t_plain:.2f} ms plain")
    for (f, c), st in zip(READER_ITEMS, stages):
        other = st["total"] - sum(st.get(k, 0.0) for k in READER_STAGES)
        log(f"[reader] host ms, frame {f} cam {c}, 0 workers: total {1e3 * st['total']:.2f}; "
            + " ".join(f"{k} {1e3 * st.get(k, 0.0):.2f}" for k in READER_STAGES)
            + f" other {1e3 * other:.2f}")

    # twice: the first pass allocates the pinned buffers, the second
    # reuses those the caching host allocator got back
    t_copy = []
    for _ in range(2):
        dev_items = []
        t0 = time.perf_counter()
        for dev in to_device_prefetch(items, device=device):
            sync()
            dev_items.append(dev)
        t_copy.append((time.perf_counter() - t0) / len(items))
    n_bytes = 0
    for host, dev in zip(items, dev_items):
        for key, v in host.items():
            if isinstance(v, np.ndarray):
                n_bytes += v.nbytes
                if dev[key].dtype != torch.from_numpy(v).dtype or not torch.equal(
                        dev[key].cpu(), torch.from_numpy(v)):
                    raise AssertionError(f"[reader] device copy of {key} differs")
    log(f"[reader] to_device_prefetch: device tensors == host arrays bit for bit; "
        f"ms per item {1e3 * t_copy[0]:.2f} first pass, {1e3 * t_copy[1]:.2f} second "
        f"({n_bytes / len(items) / 1e6:.1f} MB each)")

    render_s = []
    for (f, c), dev in zip(READER_ITEMS, dev_items):
        _launches, secs, _out = phase_main_path(
            models, bundle="default", device=device, data=dev, n_samples=n_samples,
            rows=rows, cols=cols, n_timed=1, tag=f"[reader] frame {f} cam {c}",
            require_outliers=False)
        render_s.append(secs[0])
    del dev_items, _out

    cfg = slice_config("default", n_samples)
    t0 = time.perf_counter()
    in_render = 0.0
    for dev in to_device_prefetch(PrefetchLoader(ds, n_workers=2, indices=idx),
                                  device=device):
        t1 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(SEED)
        out = render_novel_view(models, dev, cfg, generator=gen)
        sync()
        in_render += time.perf_counter() - t1
        if not bool(torch.isfinite(out["combined_rgb"]).all()):
            raise AssertionError("[reader] loop render not finite")
    wall = time.perf_counter() - t0
    mean = {k: statistics.mean(st.get(k, 0.0) for st in stages) * 1e3
            for k in ("total", *READER_STAGES)}
    log(f"[reader] summary: host ms per item (mean of {len(items)}, 0 workers) "
        + " ".join(f"{k} {v:.2f}" for k, v in mean.items())
        + f"; plain PNG decode of item 1 {1e3 * t_plain:.2f} vs native {1e3 * t_native:.2f}"
        f"; transfer ms per item {1e3 * t_copy[0]:.2f} / {1e3 * t_copy[1]:.2f} (first / "
        f"second pass); render s/view "
        + " ".join(f"{x:.4f}" for x in render_s)
        + f"; loop (PrefetchLoader n_workers=2 + to_device_prefetch) "
        f"{wall / len(idx):.4f} s/view, {100 * (wall - in_render) / wall:.2f} % of its "
        f"{wall:.3f} s outside the renders")


EVAL_ITEMS = 3
# LPIPS on the card against the CPU, relative: float32 convolutions on both
# (TF32 off on the card inside lpips_distance)
LPIPS_RTOL = 1e-5
EVAL_STAGES = ("psnr", "ssim", "lpips", "writes")


def random_lpips(seed=SEED):
    """LPIPS on the CPU with a random AlexNet from ``seed`` (torch's
    initialisers) and the bundled heads."""
    import torch

    from pgdvs_tpu_torch.metrics import lpips as lp

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = lp.LPIPS()
    heads = torch.load(lp.BUNDLED_HEADS, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k in range(5):
            net.lins[k].copy_(heads[f"lin{k}.model.1.weight"].reshape(-1))
    return net.eval()


def save_torchvision_alexnet(net, path):
    """``net``'s backbone as torchvision's ``alexnet`` state dict, to
    ``path`` (where ``load_lpips_weights`` looks for it)."""
    import torch

    from pgdvs_tpu_torch.metrics.lpips import TORCHVISION_IDX

    sd = {}
    for i, ti in enumerate(TORCHVISION_IDX):
        sd[f"features.{ti}.weight"] = net.convs[i].weight.detach().cpu()
        sd[f"features.{ti}.bias"] = net.convs[i].bias.detach().cpu()
    torch.save(sd, path)


def save_reference_checkpoint(models, path):
    """(feature_net, gnt) written as the reference's released checkpoint:
    ``{"feature_net", "net_coarse", "net_fine"}`` state dicts under the
    reference's key names (``weight_port.reference_key``)."""
    import torch

    from pgdvs_tpu_torch.models.gnt.weight_port import reference_key

    fnet, gnt = models
    coarse = {reference_key(k): v.detach().cpu() for k, v in gnt.state_dict().items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"feature_net": {k: v.detach().cpu() for k, v in fnet.state_dict().items()},
                "net_coarse": coarse, "net_fine": dict(coarse)}, path)


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


STATIC_KEYS = tuple(f"static_coarse_{k}" for k in SLICE_TOL)


def _run_hooked(argv, tag, n_items, want, module, targets, device="cuda", keep=None):
    """``python -m pgdvs_tpu_torch.run`` in-process with ``argv``, each render
    of ``module`` (the evaluator's or the visualizer's ``render_novel_view``)
    with the kernels' launch counts set to 0 just before and read just after
    (each must equal ``want``); each render's seconds and image kept, and
    render ``keep``'s static layer (``STATIC_KEYS``, on the host); host
    seconds in each of ``targets`` (``StageTimer``). Returns (what the CLI
    returned, [(render s, image)], {stage: seconds}, the kept layer)."""
    import torch

    from pgdvs_tpu_torch import run as cli

    renders, kept = [], {}
    real = module.render_novel_view

    def render(*args, **kwargs):
        reset_launches()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        if device == "cuda" and launches != want:
            raise AssertionError(f"{tag} item {len(renders)}: launches {launches}, "
                                 f"expected {want}")
        if len(renders) == keep:
            kept.update({k: out[k].float().cpu() for k in STATIC_KEYS if k in out})
        renders.append((secs, out["combined_rgb"].float().cpu().numpy()))
        return out

    module.render_novel_view = render
    try:
        with StageTimer(targets) as timer:
            result = cli.main(argv)
    finally:
        module.render_novel_view = real
    if len(renders) != n_items:
        raise AssertionError(f"{tag} {len(renders)} renders, expected {n_items}")
    return result, renders, dict(timer.seconds), kept


def _run_cli(argv, tag, n_items, want, device="cuda", extra_targets=(), keep=None):
    """``_run_hooked`` on the evaluator: host seconds per scoring stage
    (``EVAL_STAGES``), of ``Evaluator.run`` and of ``extra_targets``.
    Returns (result, [(render s, image)], {stage: seconds}), and the kept
    static layer when ``keep`` names a render."""
    from pgdvs_tpu_torch.engines import evaluator as ev

    targets = [(ev, "masked_psnr", "psnr"), (ev, "ssim_map", "ssim"),
               (ev, "masked_map_mean", "ssim"), (ev, "lpips_on_host_arrays", "lpips"),
               (ev.Evaluator, "_write_outputs", "writes"), (ev.Evaluator, "run", "loop"),
               *extra_targets]
    result, renders, stages, kept = _run_hooked(argv, tag, n_items, want, ev, targets,
                                                device, keep)
    if result.get("count") != n_items:
        raise AssertionError(f"{tag} count {result.get('count')}, expected {n_items}")
    return (result, renders, stages) if keep is None else (result, renders, stages, kept)


def _check_eval_outputs(out, result, renders, items, lpips_cpu, tag):
    """Each item's pickle equals compute_nvidia_metrics recomputed on the
    CPU from its render (PSNR / SSIM bit for bit, LPIPS at LPIPS_RTOL, the
    join ids the item's); summary.json is the result, its mean the pickles'
    mean; each PNG decodes to the render truncated to uint8. Returns the
    largest LPIPS relative error."""
    import pickle

    import numpy as np

    from pgdvs_tpu_torch.data.image_io import read_png
    from pgdvs_tpu_torch.engines import evaluator as ev

    summary = json.loads((out / "summary.json").read_text())
    if summary != json.loads(json.dumps(result)):
        raise AssertionError(f"{tag} summary.json is not the run's result")
    recs, worst = [], 0.0
    for i, ((_secs, pred), item) in enumerate(zip(renders, items)):
        rec = pickle.loads((out / f"{i:06d}.pkl").read_bytes())
        recs.append(rec)
        misc = item["misc"]
        if (rec["scene_id"], rec["tgt_frame_id"], rec["tgt_cam_id"]) != (
                misc["scene_id"], misc["tgt_frame_id"], misc["tgt_cam_id"]):
            raise AssertionError(f"{tag} item {i}: join ids {rec}")
        ref = ev.compute_nvidia_metrics(
            pred, item["rgb_tgt"], misc["tgt_dyn_mask"],
            lpips_fn=lambda a, b, m: ev.lpips_on_host_arrays(lpips_cpu, a, b, m))
        if sorted(ref) != sorted(k for k in rec if k not in (
                "scene_id", "tgt_frame_id", "tgt_cam_id", "render_wall_s")):
            raise AssertionError(f"{tag} item {i}: keys {sorted(rec)} vs {sorted(ref)}")
        for k, v in ref.items():
            if k.startswith("lpips"):
                err = abs(rec[k] - v) / abs(v)
                worst = max(worst, err)
                if not err <= LPIPS_RTOL:
                    raise AssertionError(f"{tag} item {i} {k}: card {rec[k]} vs CPU {v}")
            elif rec[k] != v:
                raise AssertionError(f"{tag} item {i} {k}: {rec[k]} vs {v} recomputed on the CPU")
        png = read_png(out / f"{i:06d}_combined.png")
        if not np.array_equal(png, (np.clip(pred, 0.0, 1.0) * 255).astype(np.uint8)):
            raise AssertionError(f"{tag} item {i}: the PNG is not the truncated render")
    for k, v in summary["mean"].items():
        mean = float(np.mean([r[k] for r in recs]))
        if not abs(v - mean) <= 1e-12 * max(1.0, abs(mean)):
            raise AssertionError(f"{tag} summary mean {k} {v} vs the pickles' {mean}")
    return worst


def phase_eval(models, root, device="cuda", n_items=EVAL_ITEMS, eval_hw=READER_EVAL_HW,
               n_samples=256):
    """[eval]: the evaluation slice on [reader]'s scene (``root / "scene"``).

    (d) ``models`` written as the reference checkpoint (``root / "ckpts" /
    "gnt/model_720000.pth"``), loaded by ``load_gnt_checkpoint`` onto the
    card: equal state dicts, and a crop of a 64x96 fast-preset render from
    its sampling maps equal to the source models' bit for bit. (c) A random
    AlexNet (seed) with the bundled heads: LPIPS of two of the scene's views
    at 288x550 over the three regions on the card, cuDNN's TF32 switched on
    globally, against the CPU at LPIPS_RTOL; ms per call on the card; the
    backbone saved where ``load_lpips_weights`` finds it. (a) ``run eval``
    in-process over the first ``n_items`` items with ``--save-vis``, that
    directory as ``$PGDVS_CKPT_DIR`` (so the checkpoint and the backbone are
    found): 78 K1 patch_rows launches per item, each pickle against
    ``compute_nvidia_metrics`` on the CPU, summary.json, the PNGs
    (``_check_eval_outputs``). (b) ``run benchmark --benchmark-type
    default`` over the same items: 78 K2 masked launches per item. (e) Host
    ms per item and stage, render s/view, the loop's s/view and its share
    of wall time outside the renders, and whether scoring stays under the
    render."""
    import os

    import numpy as np
    import torch

    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.metrics.lpips import lpips_distance
    from pgdvs_tpu_torch.models.gnt.weight_port import load_gnt_checkpoint
    from pgdvs_tpu_torch.renderers.static_gnt import resolve_epipolar_cfg

    scene, ckpts = root / "scene", root / "ckpts"

    # (d) the reference checkpoint loader
    path = ckpts / "gnt" / "model_720000.pth"
    save_reference_checkpoint(models, path)
    t0 = time.perf_counter()
    loaded = load_gnt_checkpoint(str(path), device=device)
    t_load = time.perf_counter() - t0
    for src, dst in zip(models, loaded):
        a, b = src.state_dict(), dst.state_dict()
        if sorted(a) != sorted(b) or not all(
                b[k].device == a[k].device and torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("[eval] the loaded checkpoint differs from its source")
    data = contract_to_device(make_contract_data(h=64, w=96, n_spatial=10, n_frames=12,
                                                 tgt_time=0.5), device)
    cfg = slice_config(None, 64)
    rows, cols = (16, 24), (32, 64)
    crops = [crop_on_cpu(m, data, cfg, rows, cols) for m in (models, loaded)]
    for k in crops[0]:
        if not torch.equal(crops[0][k], crops[1][k]):
            raise AssertionError(f"[eval] crop {k} of the loaded checkpoint differs")
    log(f"[eval] (d) reference checkpoint ({path.stat().st_size / 1e6:.1f} MB, feature_net / "
        f"net_coarse / net_fine) loaded onto {device} in {1e3 * t_load:.1f} ms: state dicts "
        f"equal, crop rows {rows} cols {cols} of a 64x96 fast-preset render equal bit for bit "
        f"({', '.join(crops[0])})")
    del loaded, data, crops

    # (c) LPIPS on the card against the CPU
    ds = NvidiaEvalDataset(scene, scene_ids=[READER_SCENE], tgt_height=eval_hw[0])
    items = [ds[i] for i in range(n_items)]
    lpips_cpu = random_lpips()
    lpips_card = random_lpips().to(device)
    save_torchvision_alexnet(lpips_cpu, ckpts / "alexnet.pth")
    a, b = (torch.from_numpy(items[i]["rgb_tgt"]) for i in (0, 1))
    dyn = torch.from_numpy(np.asarray(items[0]["misc"]["tgt_dyn_mask"], np.float32))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    errs, ms = {}, []
    try:
        for region, m in (("full", torch.ones_like(dyn)), ("dyn", dyn), ("static", 1.0 - dyn)):
            ref = float(lpips_distance(lpips_cpu, a, b, mask=m))
            for _ in range(3):
                t0 = time.perf_counter()
                got = float(lpips_distance(lpips_card, a.to(device), b.to(device),
                                           mask=m.to(device)))
                ms.append(1e3 * (time.perf_counter() - t0))
            errs[region] = (got, ref, abs(got - ref) / abs(ref))
            if not errs[region][2] <= LPIPS_RTOL:
                raise AssertionError(f"[eval] LPIPS {region}: card {got} vs CPU {ref}")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    log(f"[eval] (c) LPIPS (random AlexNet, seed {SEED}, bundled heads) at "
        f"{tuple(a.shape[:2])}, cuDNN TF32 on globally, card vs CPU: "
        + "; ".join(f"{r} {g:.6f} / {c:.6f} (rel {e:.2e})" for r, (g, c, e) in errs.items())
        + f"; ms per call on the card (host, with the copy in) median "
        f"{statistics.median(ms):.2f} min {min(ms):.2f}")

    h, w = items[0]["rgb_tgt"].shape[:2]
    common = ["--data-root", str(scene), "--scene-ids", READER_SCENE, "--max-items",
              str(n_items), "--device", device, "--dataset-arg", f"tgt_height={eval_hw[0]}",
              "--render-cfg", f"n_coarse_samples_per_ray={n_samples}"]
    plain = device != "cuda"  # the CPU launches no kernel
    old = os.environ.get("PGDVS_CKPT_DIR")
    os.environ["PGDVS_CKPT_DIR"] = str(ckpts)
    try:
        # (a) eval: the fast preset, K1 patch_rows
        cfg = resolve_epipolar_cfg(slice_config(None, n_samples), models[1], h, w)[0]
        want = expected_launches(cfg, h * w, plain)
        out = root / "eval"
        result, renders, stages = _run_cli(["eval", *common, "--out-dir", str(out),
                                            "--save-vis"], "[eval] (a)", n_items, want, device)
        worst = _check_eval_outputs(out, result, renders, items, lpips_cpu, "[eval] (a)")
        log(f"[eval] (a) run eval: {n_items} items, {cfg.epipolar_mode} sampling, "
            f"launches per item {_nonzero(want)}; pickles == "
            f"compute_nvidia_metrics on the CPU (PSNR / SSIM bit for bit, LPIPS rel "
            f"{worst:.2e}), summary count {result['count']}, mean == the pickles' mean, PNGs "
            f"== truncated renders; mean " + json.dumps(result["mean"]))
        # (b) benchmark default: quad sampling, K2 masked
        cfg_b = resolve_epipolar_cfg(slice_config("default", n_samples), models[1], h, w)[0]
        want_b = expected_launches(cfg_b, h * w, plain)
        out_b = root / "benchmark"
        result_b, renders_b, stages_b = _run_cli(
            ["benchmark", "--benchmark-type", "default", *common, "--out-dir", str(out_b)],
            "[eval] (b)", n_items, want_b, device)
        if not all(np.isfinite(v) for v in result_b["mean"].values()):
            raise AssertionError(f"[eval] (b) metrics not finite: {result_b['mean']}")
        log(f"[eval] (b) run benchmark --benchmark-type default: {n_items} items, "
            f"{cfg_b.epipolar_mode} sampling, launches per item {_nonzero(want_b)}; mean "
            + json.dumps(result_b["mean"]))
    finally:
        if old is None:
            os.environ.pop("PGDVS_CKPT_DIR", None)
        else:
            os.environ["PGDVS_CKPT_DIR"] = old

    # (e) numbers
    for tag, st, rs in (("eval", stages, renders), ("benchmark default", stages_b, renders_b)):
        per_item = {k: 1e3 * st.get(k, 0.0) / n_items for k in EVAL_STAGES}
        scoring = sum(per_item.values())
        render_s = [secs for secs, _ in rs]
        loop = st["loop"]
        log(f"[eval] (e) {tag}: host ms per item " + " ".join(
            f"{k} {v:.2f}" for k, v in per_item.items())
            + f" (scoring {scoring:.2f}); render s/view " + " ".join(f"{x:.4f}" for x in render_s)
            + f"; loop {loop / n_items:.4f} s/view, {100 * (loop - sum(render_s)) / loop:.2f} % "
            f"of its {loop:.3f} s outside the renders; scoring "
            + ("stays under" if scoring / 1e3 < min(render_s) else "does not stay under")
            + " the render")


# ------------------------------------------------- JPEG frames and geometry

JPEG_FIXTURES = pathlib.Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
# the [geo] scene's frames: baseline JPEG at quality 95, 4:2:0, each decode
# at least this far above its source (the 25 frames at 576x1100 decode at
# 38.6-46.0 dB; Pillow's own encoder at quality 95 lands within 0.1 dB of
# this one on such a frame)
GEO_JPEG_QUALITY = 95
GEO_MIN_PSNR_DB = 35.0
GEO_BUNDLES = ("st_cvd_dy_cvd", "st_cvd_dy_cvd_pcl_clean", "st_cvd_pcl_clean_dy_cvd_pcl_clean")
GEO_ITEMS = 2
# the capped cloud of the render held against the CPU (the KNN of the full
# cloud is too slow there)
GEO_CPU_CAPACITY = 20000
# card against CPU, the same inputs and noise: float32 projection (another
# summation order on the card) and index_add_'s atomics (F3) move rgb by
# float32 rounding; a coverage or mask pixel may flip where a point sits on
# a footprint's edge to the ulp, or a KNN tie flips an outlier: at most
# GEO_MASK_FLIPS of the pixels, rgb compared where both masks agree
GEO_RGB_TOL = 1e-4
GEO_MASK_FLIPS = 1e-4
# a KNN over the whole static cloud slower than this runs its bundle on one
# item (it runs every view, as in the JAX package)
GEO_KNN_SLOW_S = 10.0


def _cuda_ms(fn, iters=3):
    """Per-call device ms of ``fn`` (CUDA events, after one warm-up call),
    each call timed alone: (median, all)."""
    import torch

    fn()
    out = []
    for _ in range(iters):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return statistics.median(out), out


def phase_jpeg(smi):
    """[jpeg]: the C decoder built, the committed fixtures decoded to the
    sha256 and shape recorded from Pillow when they were made
    (tests/data/jpeg/decodes.json: 4:4:4 / 4:2:2 / 4:2:0, grey, restarts,
    16-bit tables, Adobe RGB, EXIF), the progressive fixture refused naming
    the file, and host ms per megapixel on a 576x1100 synthetic frame
    written by ``encode_jpeg`` at GEO_JPEG_QUALITY."""
    import hashlib

    from pgdvs_tpu_torch.data import image_io, synthetic

    t0 = time.perf_counter()
    image_io.load_jpeg_library()
    t_build = time.perf_counter() - t0
    record = json.loads((JPEG_FIXTURES / "decodes.json").read_text())
    for name, want in record["decodes"].items():
        got = image_io.read_image(JPEG_FIXTURES / name)
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        if list(got.shape) != want["shape"] or digest != want["sha256"]:
            raise AssertionError(f"[jpeg] {name}: {got.shape} {digest} is not Pillow's "
                                 f"{want['shape']} {want['sha256']}")
    for name, what in record["refused"].items():
        try:
            image_io.read_image(JPEG_FIXTURES / name)
        except NotImplementedError as e:
            if name not in str(e) or what not in str(e):
                raise AssertionError(f"[jpeg] {name} refused without naming it: {e}") from e
        else:
            raise AssertionError(f"[jpeg] {name} ({what}) decoded; it must raise")
    fr = synthetic.render_frame(*READER_RAW_HW, synthetic.camera_pose(3, 13), 0.5)
    data = encode_jpeg((fr["rgb"] * 255).astype(np.uint8), GEO_JPEG_QUALITY)
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        image_io.read_jpeg(data)
        secs.append(time.perf_counter() - t0)
    mpix = READER_RAW_HW[0] * READER_RAW_HW[1] / 1e6
    log(f"[jpeg] decoder built in {t_build:.2f} s; {len(record['decodes'])} fixtures == Pillow "
        f"{record['pillow']} (libjpeg-turbo {record['libjpeg_turbo']}) by sha256 and shape; "
        f"{', '.join(record['refused'])} refused naming the file; host decode of a "
        f"{READER_RAW_HW[0]}x{READER_RAW_HW[1]} q{GEO_JPEG_QUALITY} 4:2:0 frame "
        f"({len(data)} bytes): median {1e3 * statistics.median(secs):.2f} ms, "
        f"{1e3 * statistics.median(secs) / mpix:.2f} ms per megapixel; on {smi}")


def _geo_render(data, cfg, noise):
    from pgdvs_tpu_torch.renderers.compose import render_novel_view

    return render_novel_view(None, data, cfg, static_mode="geo", noise=noise)


def _hold_against_cpu(tag, got, ref, rgb_keys, mask_keys, mask_for,
                      flip_share=GEO_MASK_FLIPS, rgb_tol=GEO_RGB_TOL):
    """Masks equal but for at most ``flip_share`` of the pixels; each rgb
    within ``rgb_tol`` where the masks ``mask_for[key]`` all agree. Returns
    (flips, worst rgb)."""
    flips, worst = {}, {}
    for key in mask_keys:
        a, b = got[key].float().cpu(), ref[key].float()
        flips[key] = int((a != b).sum())
        if flips[key] > flip_share * a.numel():
            raise AssertionError(f"{tag} {key}: {flips[key]} of {a.numel()} pixels differ "
                                 "from the CPU")
    for key in rgb_keys:
        agree = 1.0
        for m in mask_for[key]:
            agree = agree * (got[m].cpu() == ref[m]).all(dim=-1, keepdim=True)
        err = ((got[key].float().cpu() - ref[key]).abs() * agree).max()
        worst[key] = float(err)
        if not worst[key] <= rgb_tol:
            raise AssertionError(f"{tag} {key}: max err {worst[key]} against the CPU")
    return flips, worst


def phase_geo(root, smi, device="cuda", n_items=GEO_ITEMS, raw_hw=READER_RAW_HW,
              eval_hw=READER_EVAL_HW, cpu_capacity=GEO_CPU_CAPACITY,
              min_psnr_db=GEO_MIN_PSNR_DB):
    """[geo]: the pure-geometry bundles on [reader]'s scene with JPEG frames.

    Writes ``write_reader_scene`` under ``root`` with its frames as JPEG
    (``encode_jpeg``), each decode at least GEO_MIN_PSNR_DB above its source;
    aggregates the static cloud (``NvidiaPureGeoEvalDataset``, host ms) and
    times on the card, over the first item, the KNN outlier removal of the
    whole cloud (``statistical_outlier_mask``, k 50, std 0.2) and the point
    raster's taps, z-buffer and composite passes (CUDA events); renders each
    ``st_cvd_*`` bundle on the first item twice and times it (s/view after
    the warm-up), and holds it, on a cloud capped at GEO_CPU_CAPACITY,
    against the port on the CPU with the same noise; then runs ``python -m
    pgdvs_tpu_torch.run benchmark --benchmark-type`` for each bundle
    in-process over the first ``n_items`` items (one where the whole-cloud
    KNN takes more than GEO_KNN_SLOW_S): no kernel launches, finite
    metrics. Device times use CUDA events, so the phase needs a card;
    sizes are parameters for a rehearsal."""
    import torch

    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.data.nvidia_pure_geo import NvidiaPureGeoEvalDataset
    from pgdvs_tpu_torch.kernels.knn import statistical_outlier_mask
    from pgdvs_tpu_torch.kernels.point_raster import (
        composite_pass,
        footprint_px,
        point_taps,
        zbuffer_pass,
    )

    t0 = time.perf_counter()
    psnrs = write_reader_scene(root, raw_hw, eval_hw, jpeg_quality=GEO_JPEG_QUALITY)
    t_write = time.perf_counter() - t0
    if not min(psnrs) >= min_psnr_db:
        raise AssertionError(f"[geo] a JPEG frame decodes at {min(psnrs):.2f} dB of its source")
    kw = dict(scene_ids=[READER_SCENE], tgt_height=eval_hw[0])
    ds = NvidiaPureGeoEvalDataset(root, **kw)
    t0 = time.perf_counter()
    pcl = ds._scene_pcl(READER_SCENE)
    t_agg = time.perf_counter() - t0
    log(f"[geo] scene {raw_hw[0]}x{raw_hw[1]} raw -> {eval_hw[0]}x"
        f"{eval_hw[1]}, {READER_FRAMES} frames, {len(psnrs)} JPEG frames (q"
        f"{GEO_JPEG_QUALITY}, 4:2:0) written in {t_write:.3f} s, decode PSNR min "
        f"{min(psnrs):.2f} mean {statistics.mean(psnrs):.2f} dB (bound {min_psnr_db}); "
        f"static cloud {pcl.shape[0]} points aggregated in {1e3 * t_agg:.1f} host ms")

    item = ds[0]
    data = contract_to_device(item, device)
    hw = item["rgb_tgt"].shape[:2]
    points = data["st_pcl_rgb"][:, :3]
    valid = data["st_pcl_valid"]
    clean = resolve_benchmark(GEO_BUNDLES[2])[0]
    kept = []
    knn_ms, knn_all = _cuda_ms(lambda: kept.append(int(statistical_outlier_mask(
        points, valid, k=clean.st_pcl_outlier_knn,
        std_thres=clean.st_pcl_outlier_std_thres)[0].sum())), iters=1)
    r_px, fp = footprint_px(clean.st_render_pcl_pt_radius, hw)
    cam = data["flat_cam_tgt"]
    taps_ms, _ = _cuda_ms(lambda: point_taps(points, cam, hw, valid, r_px, fp), iters=5)
    z, taps = point_taps(points, cam, hw, valid, r_px, fp)
    zbuf_ms, _ = _cuda_ms(lambda: zbuffer_pass(z, taps, hw[0] * hw[1]), iters=5)
    zbuf = zbuffer_pass(z, taps, hw[0] * hw[1])
    comp_ms, _ = _cuda_ms(lambda: composite_pass(z, taps, zbuf, data["st_pcl_rgb"][:, 3:6], hw,
                                                 r_px, 0.01), iters=5)
    log(f"[geo] device ms over the {points.shape[0]}-point cloud: KNN outlier removal (k "
        f"{clean.st_pcl_outlier_knn}) median {knn_ms:.1f} ({', '.join(f'{x:.1f}' for x in knn_all)}"
        f"), keeps {kept[-1]}; point raster at radius {clean.st_render_pcl_pt_radius} ({r_px:.2f} px, "
        f"{(2 * fp + 1) ** 2} taps): taps {taps_ms:.3f}, z-buffer pass {zbuf_ms:.3f}, composite "
        f"pass {comp_ms:.3f}; on {smi}")

    cap = NvidiaPureGeoEvalDataset(root, st_pcl_capacity=cpu_capacity, **kw)[0]
    cap_cpu = contract_to_device(cap, "cpu")
    cap_dev = contract_to_device(cap, device)
    noise = torch.randn(item["rgb_tgt"].shape, generator=torch.Generator().manual_seed(SEED))
    for bundle in GEO_BUNDLES:
        cfg = resolve_benchmark(bundle)[0]
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = _geo_render(data, cfg, noise.to(device))
            if device == "cuda":
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rgb = out["combined_rgb"]
        if tuple(rgb.shape) != (*hw, 3) or not bool(torch.isfinite(rgb).all()):
            raise AssertionError(f"[geo] {bundle}: combined_rgb {tuple(rgb.shape)} not finite")
        got = _geo_render(cap_dev, cfg, noise.to(device))
        ref = _geo_render(cap_cpu, cfg, noise)
        flips, worst = _hold_against_cpu(
            f"[geo] {bundle}", got, ref, ("geo_static_rgb", "render_dyn_rgb", "combined_rgb"),
            ("geo_static_mask", "render_dyn_mask"),
            {"geo_static_rgb": ("geo_static_mask",), "render_dyn_rgb": ("render_dyn_mask",),
             "combined_rgb": ("geo_static_mask", "render_dyn_mask")})
        log(f"[geo] {bundle}: s/view {secs[1]:.4f} after a {secs[0]:.4f} s warm-up; static "
            f"coverage {float(out['geo_static_mask'].mean()):.4f}, dynamic "
            f"{float(out['render_dyn_mask'].mean()):.4f}; vs CPU on the cloud capped at "
            f"{cpu_capacity}: mask pixels differing {flips}, rgb max err "
            + " ".join(f"{k}={v:.2e}" for k, v in worst.items()) + f"; on {smi}")

    no_launch = {k: 0 for k in KERNELS}
    for bundle in GEO_BUNDLES:
        n = 1 if (bundle == GEO_BUNDLES[2] and knn_ms / 1e3 > GEO_KNN_SLOW_S) else n_items
        argv = ["benchmark", "--benchmark-type", bundle, "--data-root", str(root),
                "--scene-ids", READER_SCENE, "--max-items", str(n), "--device", device,
                "--dataset-arg", f"tgt_height={eval_hw[0]}",
                "--out-dir", str(root / f"out_{bundle}")]
        result, renders, stages = _run_cli(argv, f"[geo] {bundle}", n, no_launch, device)
        if not all(np.isfinite(v) for v in result["mean"].values()):
            raise AssertionError(f"[geo] {bundle}: metrics not finite: {result['mean']}")
        log(f"[geo] run benchmark --benchmark-type {bundle}: {n} items, no kernel launches; "
            f"render s/view " + " ".join(f"{x:.4f}" for x, _img in renders)
            + f"; loop {stages['loop'] / n:.4f} s/view (cloud aggregation included); mean "
            + json.dumps(result["mean"]) + f"; on {smi}")


def phase_point_mesh(models, smi, device="cuda", h=288, w=550, n_samples=256,
                     rows=(140, 144), cols=(160, 224)):
    """[pcl] / [mesh]: the two masked bundles whose dynamic layer is
    rasterized, ``..._render_point`` and ``..._render_mesh``, at 288x550 on
    the synthetic contract scene through ``phase_main_path`` (78 K2 launches,
    the static crop against the CPU, s/view); then the dynamic layer held
    against ``render_dynamic`` on the CPU from the same inputs (masks equal
    but for GEO_MASK_FLIPS, rgb within GEO_RGB_TOL), and the device ms of
    the rasterizer alone on the card's cloud (CUDA events)."""
    import torch

    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.kernels.mesh_raster import rasterize_grid_mesh
    from pgdvs_tpu_torch.kernels.point_raster import rasterize_points
    from pgdvs_tpu_torch.renderers.dynamic import compute_dyn_pointcloud, render_dynamic

    host = make_contract_data(h=h, w=w, n_spatial=10, n_frames=12, tgt_time=0.5)
    data = contract_to_device(host, device)
    cpu = contract_to_device(host, "cpu")
    for tag, bundle in (("[pcl]", "st_gnt_masked_attn_dy_cvd_pcl_clean_render_point"),
                        ("[mesh]", "st_gnt_masked_attn_dy_cvd_pcl_clean_render_mesh")):
        _launches, secs, out = phase_main_path(models, bundle=bundle, device=device,
                                               n_samples=n_samples, rows=rows, cols=cols,
                                               tag=tag, data=data)
        cfg = slice_config(bundle, n_samples)
        ref = render_dynamic(cpu, cfg)
        got = {"rgb": out["render_dyn_rgb"], "mask": out["render_dyn_mask"]}
        flips, worst = _hold_against_cpu(tag, got, ref, ("rgb",), ("mask",), {"rgb": ("mask",)})
        pcl = compute_dyn_pointcloud(
            rgb_1=data["rgb_src_temporal"][0], dyn_mask_1=data["dyn_mask_src_temporal"][0],
            depth_1=data["depth_src_temporal"][0], flow_12=data["flow_fwd"],
            flow_12_occ_mask=data["flow_fwd_occ_mask"], rgb_2=data["rgb_src_temporal"][1],
            depth_2=data["depth_src_temporal"][1], cam_1=data["flat_cam_src_temporal"][0],
            cam_2=data["flat_cam_src_temporal"][1], cam_tgt=data["flat_cam_tgt"],
            time_1=data["time_src_temporal"][0], time_2=data["time_src_temporal"][1],
            time_tgt=data["time_tgt"][0], cfg=cfg)
        if cfg.dyn_render_type == "pcl":
            def raster():
                return rasterize_points(pcl["points"], pcl["colors"], data["flat_cam_tgt"],
                                        (h, w), valid=pcl["valid"],
                                        radius=cfg.dyn_render_pcl_pt_radius)
        else:
            def raster():
                return rasterize_grid_mesh(pcl["points"], pcl["colors"], pcl["valid"],
                                           data["flat_cam_tgt"], (h, w))
        ms, all_ms = _cuda_ms(raster, iters=5)
        log(f"{tag} dynamic layer ({cfg.dyn_render_type}, {int(pcl['valid'].sum())} valid of "
            f"{pcl['valid'].numel()} points) vs render_dynamic on the CPU: mask pixels differing "
            f"{flips['mask']}, rgb max err {worst['rgb']:.2e} where the masks agree; mask covers "
            f"{float(out['render_dyn_mask'].mean()):.4f}; rasterizer device ms median {ms:.3f} "
            f"({', '.join(f'{x:.3f}' for x in all_ms)}); s/view {statistics.mean(secs):.4f}; "
            f"on {smi}")


# ------------------------------------------------- the track branch

TRACK_K = 5                 # ±5 track frames: T = 12 slots
# both [track-tapir] bundles render on ±2 track frames (T = 6): the _raw_res
# one since PR 15 (its TAPIR at the frames' size took ~160 s of the script on
# ±5), the 256x256 one since PR 18 (its profiled first render and timed
# render took 112 s on ±5, which with [depth] brought the script to 1124 s
# of its 1200 on one host); [track-lk], [track-eval] and the CoTracker
# prediction keep ±5
TRACK_K_TAPIR = 2
TRACK_BUNDLES = ("st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir",
                 "st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir_raw_res")
# rendered by [track-tapir]: the _raw_res bundle alone (the
# 256x256 one's first and timed renders took ~25 s of the script; it still
# runs on the card through [track-eval]'s `run benchmark`)
TRACK_TAPIR_RENDERED = TRACK_BUNDLES[1:]
# one item: each TAPIR item on ±5 track frames costs ~41 s of the script's
# time, which [track-cotracker] takes
TRACK_EVAL_ITEMS = 1
# the reduced-size branch on the card against the CPU (48x64, k_track=2):
# LK on both; a query whose visibility flips between the two moves one
# point, which may change a few pixels of the track layer
TRACK_CPU_HW = (48, 64)
TRACK_MASK_FLIPS = 0.01
TRACK_RGB_TOL = 1e-3
# TapirTracker on the card against the CPU (T = 4, 64x64, 64 queries), both
# float32 with TF32 off: grids and the cost-volume heads' logits within
# these; tracks by median and 90th percentile of |card - CPU| (px) with a
# budget for tracks a soft-argmax cell flip moved by more than 8 px (the
# JAX package holds its flax TAPIR to the haiku one so,
# tests/test_tapir_parity.py); visibility agreeing on TAPIR_VIS_SHARE
TAPIR_GRID_TOL = 1e-4
TAPIR_LOGIT_TOL = 1e-3
TAPIR_TRACK_MEDIAN = 0.05
TAPIR_TRACK_P90 = 0.5
TAPIR_OUTLIERS = 0.05
TAPIR_VIS_SHARE = 0.97
# chunked against one call on the card (4096 queries): tracks and logits
# within 1e-3 but for a share of entries a cell flip may move
TAPIR_CHUNK_TOL = 1e-3
TAPIR_CHUNK_FLIPS = 0.005


def _event_ms(fn):
    """(result, device ms) of one call of ``fn`` between two CUDA events."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def _kernel_table(fn, top=5):
    """(result, device kernel launches, summed kernel ms, elapsed ms,
    [(name, ms, launches)] of the ``top`` kernels by device time) of one
    call of ``fn`` under ``torch.profiler``; the launches and summed ms are
    None where the profiler sees no device activity."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, ms = _event_ms(fn)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    if not by_name:
        return out, None, None, ms, []
    rows = sorted(((n, t, c) for n, (t, c) in by_name.items()), key=lambda r: -r[1])
    return out, sum(c for _, _, c in rows), sum(t for _, t, _ in rows), ms, rows[:top]


def _profile_cuda(fn):
    """(result, device kernel launches, summed kernel ms, elapsed ms) of one
    call of ``fn`` under ``torch.profiler`` (``_kernel_table``)."""
    return _kernel_table(fn)[:4]


class RecordingTracker:
    """A tracker that keeps what the smoke reports of it: its first call
    runs under ``torch.profiler`` (kernel launches, summed kernel ms), every
    call is timed by CUDA events, and the last call's frames, queries and
    outputs are kept, so no extra tracker call is made to take the branch
    apart."""

    def __init__(self, tracker):
        self.tracker = tracker
        self.calls = []
        self.last = None

    def __call__(self, frames, queries, query_valid=None):
        def fn():
            return self.tracker(frames, queries, query_valid)

        if self.calls:
            out, ms = _event_ms(fn)
            launches = busy = None
        else:
            out, launches, busy, ms = _profile_cuda(fn)
        self.calls.append({"ms": ms, "launches": launches, "busy_ms": busy,
                           "queries": int(queries.shape[0])})
        self.last = (frames, queries, out)
        return out


def track_breakdown(tag, data, cfg, rec, smi, require_points=True):
    """The track branch of the last render taken apart on the card: the
    base cloud (with its KNN threshold), the query slots and the valid
    queries, the tracker (``rec``, a RecordingTracker: launches and summed
    kernel ms of its first call, under the profiler; CUDA-event ms of its
    last, in the timed render), the lift and both filters (points lifted
    and kept after each) on the last call's tracks, the rasterizer of the
    merged cloud (CUDA events). With ``require_points`` the branch must
    keep a point (LK on the synthetic scene does; TAPIR on random weights
    need not). Returns the counts."""
    import torch

    from pgdvs_tpu_torch.kernels.point_raster import rasterize_points
    from pgdvs_tpu_torch.renderers.dynamic import compute_dyn_pointcloud
    from pgdvs_tpu_torch.renderers.dynamic_track import (build_track_stack,
                                                          compute_track_pointcloud,
                                                          select_queries)

    h, w = data["rgb_src_temporal"].shape[1:3]
    pcl, pcl_ms = _event_ms(lambda: compute_dyn_pointcloud(
        rgb_1=data["rgb_src_temporal"][0], dyn_mask_1=data["dyn_mask_src_temporal"][0],
        depth_1=data["depth_src_temporal"][0], flow_12=data["flow_fwd"],
        flow_12_occ_mask=data["flow_fwd_occ_mask"], rgb_2=data["rgb_src_temporal"][1],
        depth_2=data["depth_src_temporal"][1], cam_1=data["flat_cam_src_temporal"][0],
        cam_2=data["flat_cam_src_temporal"][1], cam_tgt=data["flat_cam_tgt"],
        time_1=data["time_src_temporal"][0], time_2=data["time_src_temporal"][1],
        time_tgt=data["time_tgt"][0], cfg=cfg))
    stack = build_track_stack(data)
    _queries, q_valid = select_queries(stack, h * w)
    _frames, queries, (tracks, vis) = rec.last
    n = queries.shape[0]
    if n != int(q_valid.sum()) or n == 0:
        raise AssertionError(f"{tag} the tracker saw {n} queries of {int(q_valid.sum())}")
    stats = {"query_slots": int(q_valid.numel()), "valid_queries": n}
    ones = torch.ones((n,), dtype=torch.bool, device=queries.device)
    (points, colors, valid), lift_ms = _event_ms(lambda: compute_track_pointcloud(
        stack, tracks, vis, ones, data["time_tgt"][0], pcl["points"], pcl["colors"],
        pcl["valid"], pcl["nn_dist_thres"], cfg, stats))
    if require_points and not stats["kept_self_filter"] > 0:
        raise AssertionError(f"{tag} the track branch kept no point: {stats}")
    raster_ms, raster_all = _cuda_ms(lambda: rasterize_points(
        torch.cat([points, pcl["points"]]), torch.cat([colors, pcl["colors"]]),
        data["flat_cam_tgt"], (h, w), valid=torch.cat([valid, pcl["valid"]]),
        radius=cfg.dyn_render_pcl_pt_radius), iters=3)
    first, last = rec.calls[0], rec.calls[-1]
    log(f"{tag} query slots {stats['query_slots']}, valid queries {n} "
        f"({int(stack['real_track'].sum())} real track frames of {stack['rgbs'].shape[0]}), "
        f"lifted {stats['lifted']}, kept after the base-cloud filter "
        f"{stats['kept_base_filter']}, after the self filter {stats['kept_self_filter']}; "
        f"base cloud {int(pcl['valid'].sum())} points")
    log(f"{tag} device ms: base cloud + KNN threshold {pcl_ms:.3f}; tracker {last['ms']:.3f} "
        f"in the timed render (CUDA events; {len(rec.calls)} calls: "
        + ", ".join(f"{c['ms']:.1f}" for c in rec.calls) + "), its first call "
        + (f"{first['busy_ms']:.3f} ms of kernels over {first['launches']} launches "
           "(torch.profiler)" if first["launches"] is not None
           else "not measured (the profiler saw no device activity)")
        + f"; lift + both filters {lift_ms:.3f}; rasterizer median {raster_ms:.3f} "
        f"({', '.join(f'{x:.3f}' for x in raster_all)}); on {smi}")
    return stats


def _track_contract(h, w, k, device):
    """The synthetic contract with ±k track frames, on ``device``."""
    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.data.synthetic import make_contract_data

    return contract_to_device(make_contract_data(h=h, w=w, n_spatial=10, n_frames=12,
                                                 tgt_time=0.5, k_track=k), device)


def phase_track_lk(models, smi, h=288, w=550, n_samples=256):
    """[track-lk]: F4's configuration, the ``default`` bundle with
    ``dyn_render_track_temporal="no_tgt"`` and ``LucasKanadeTracker()``, at
    288x550 with 10 sources, 256 samples and ±5 track frames through
    ``phase_main_path`` (78 K2 launches, the static crop against the CPU,
    s/view of one render after a warm-up, peak memory); ``track_breakdown``; then the same
    branch at TRACK_CPU_HW with ``k_track=2`` held against the port on the
    CPU (``render_dynamic``: masks equal but for TRACK_MASK_FLIPS of the
    pixels, rgb within TRACK_RGB_TOL where they agree)."""
    import torch

    from pgdvs_tpu_torch.models.tracking import LucasKanadeTracker
    from pgdvs_tpu_torch.renderers.dynamic import render_dynamic

    tag = "[track-lk]"
    tracker = LucasKanadeTracker()
    rec = RecordingTracker(tracker)
    data = _track_contract(h, w, TRACK_K, "cuda")
    # one timed render: a second costs ~7 s of the script's time
    launches, secs, out = phase_main_path(models, bundle="default", data=data, tag=tag,
                                          n_samples=n_samples, cols=(160, 224), n_timed=1,
                                          tracker=rec, dyn_render_track_temporal="no_tgt")
    if not bool(out["render_dyn_temporal_track_mask"].any()):
        raise AssertionError(f"{tag} the track layer is empty")
    cfg = slice_config("default", n_samples, dyn_render_track_temporal="no_tgt")
    track_breakdown(tag, data, cfg, rec, smi)
    log(f"{tag} K2 launches {launches['gnt_fused_mono3']}; track layer covers "
        f"{float(out['render_dyn_temporal_track_mask'].mean()):.4f} of the view, adds "
        f"{int((out['render_dyn_mask'] - out['render_dyn_temporal_closest_mask']).sum())} "
        f"pixels to the splat's {int(out['render_dyn_temporal_closest_mask'].sum())}; "
        f"s/view {statistics.mean(secs):.4f}; on {smi}")
    sh, sw = TRACK_CPU_HW
    small = _track_contract(sh, sw, 2, "cuda")
    cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in small.items()}
    noise = torch.randn((sh, sw, 3), generator=torch.Generator().manual_seed(SEED))
    got = render_dynamic(small, cfg, noise=noise.cuda(), tracker=tracker)
    ref = render_dynamic(cpu, cfg, noise=noise, tracker=tracker)
    keys = ("mask", "temporal_track_mask")
    flips, worst = _hold_against_cpu(
        tag, got, ref, ("rgb", "temporal_track_rgb"), keys,
        {"rgb": keys, "temporal_track_rgb": keys}, TRACK_MASK_FLIPS, TRACK_RGB_TOL)
    if not bool(ref["temporal_track_mask"].any()):
        raise AssertionError(f"{tag} the CPU's track layer at {sh}x{sw} is empty")
    log(f"{tag} the branch at {sh}x{sw}, k_track 2, card vs CPU: mask pixels differing "
        f"{flips}, rgb max err where the masks agree {worst}")


def phase_track_tapir(models, smi, h=288, w=550, n_samples=256):
    """[track-tapir]: TapirTracker (seeded random weights: no checkpoint
    is in the repository, and the JAX package falls back so too) on the
    card against the CPU on a small clip (T = 4, 64x64, 64 queries): the
    grids, the cost-volume heads, the tracks, the visibility; chunked
    tracking against one call on 4096 queries; then each of TRACK_BUNDLES at
    288x550 (10 sources, 256 samples, ±2 track frames (TRACK_K_TAPIR),
    every dynamic pixel of the real track frames a query) through ``phase_main_path`` (78 K2
    launches, the static crop against the CPU, s/view after a warm-up, peak
    memory) and ``track_breakdown``."""
    import copy

    import numpy as np
    import torch

    from pgdvs_tpu_torch.configs.benchmarks import make_tracker
    from pgdvs_tpu_torch.data import synthetic
    from pgdvs_tpu_torch.models.tracking.tapir import TapirTracker

    tag = "[track-tapir]"
    tracker = make_tracker("tapir", device="cuda")
    cpu_tracker = TapirTracker(copy.deepcopy(tracker.model).cpu())
    m_card, m_cpu = tracker.model, cpu_tracker.model
    t_n, n = 4, 64
    frames = np.stack([synthetic.render_frame(64, 64, synthetic.camera_pose(i + 1, 10),
                                              0.3 + 0.1 * i)["rgb"] for i in range(t_n)])
    frames = torch.from_numpy(frames.astype(np.float32))
    rng = np.random.default_rng(SEED)
    q = torch.from_numpy(np.stack([rng.integers(0, t_n, n), rng.uniform(0, 63, n),
                                   rng.uniform(0, 63, n)], axis=-1).astype(np.float32))
    video = frames * 2 - 1
    qyx = q[:, [0, 2, 1]]
    with torch.no_grad():
        g_card = m_card.feature_grids(video.cuda())
        g_cpu = m_cpu.feature_grids(video)
        grid_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(g_card, g_cpu))
        qf = m_cpu.query_features(g_cpu, qyx, (64, 64))
        heads_card = m_card.tracks_from_cost_volume(qf[1].cuda(), g_cpu[1].cuda(), qyx.cuda(),
                                                    (64, 64))
        heads_cpu = m_cpu.tracks_from_cost_volume(qf[1], g_cpu[1], qyx, (64, 64))
    logit_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(heads_card[1:],
                                                                      heads_cpu[1:]))
    if not (grid_err <= TAPIR_GRID_TOL and logit_err <= TAPIR_LOGIT_TOL):
        raise AssertionError(f"{tag} card vs CPU: grids {grid_err}, head logits {logit_err}")
    tr_card, vis_card = tracker(frames.cuda(), q.cuda())
    tr_cpu, vis_cpu = cpu_tracker(frames, q)
    d = (tr_card.cpu() - tr_cpu).abs().numpy()
    med, p90, outl = float(np.median(d)), float(np.quantile(d, 0.9)), float((d > 8.0).mean())
    vis_share = float((vis_card.cpu() == vis_cpu).float().mean())
    if not (med <= TAPIR_TRACK_MEDIAN and p90 <= TAPIR_TRACK_P90 and outl <= TAPIR_OUTLIERS
            and vis_share >= TAPIR_VIS_SHARE):
        raise AssertionError(f"{tag} tracks card vs CPU: median {med}, p90 {p90}, outliers "
                             f"{outl}, visibility agreeing {vis_share}")
    log(f"{tag} TapirTracker card vs CPU (T {t_n}, 64x64 -> 256x256, {n} queries, TF32 off): "
        f"grids max err {grid_err:.2e}, cost-volume head logits {logit_err:.2e}, tracks |d| "
        f"median {med:.2e} p90 {p90:.2e} px, share > 8 px {outl:.4f}, visibility agreeing "
        f"{vis_share:.4f}")
    nq = 4096
    qq = torch.from_numpy(np.stack([rng.integers(0, t_n, nq), rng.uniform(0, 255, nq),
                                    rng.uniform(0, 255, nq)], axis=-1).astype(np.float32)).cuda()
    with torch.no_grad():
        vid = torch.nn.functional.interpolate(video.permute(0, 3, 1, 2), size=(256, 256),
                                              mode="bilinear").permute(0, 2, 3, 1).cuda()
        one = m_card(vid, qq, chunk=nq)
        chunked = m_card(vid, qq, chunk=512)
    errs = [(a - b).abs() for a, b in zip(chunked, one)]
    flips = max(float((e > TAPIR_CHUNK_TOL).float().mean()) for e in errs)
    if not flips <= TAPIR_CHUNK_FLIPS:
        raise AssertionError(f"{tag} chunked vs one call: share over {TAPIR_CHUNK_TOL} {flips}")
    log(f"{tag} {nq} queries in chunks of 512 vs one call on the card: max |d| "
        + ", ".join(f"{float(e.max()):.2e}" for e in errs)
        + f" (tracks, occlusion, expected distance); share over {TAPIR_CHUNK_TOL}: {flips:.5f}")
    del g_card, g_cpu, one, chunked, errs, cpu_tracker
    for bundle in TRACK_TAPIR_RENDERED:
        raw_res = bundle.endswith("raw_res")
        btag = f"{tag}[{'raw_res' if raw_res else '256'}]"
        data = _track_contract(h, w, TRACK_K_TAPIR, "cuda")
        rec = RecordingTracker(make_tracker("tapir_raw_res" if raw_res else "tapir",
                                            device="cuda"))
        launches, secs, out = phase_main_path(models, bundle=bundle, data=data, tag=btag,
                                              n_samples=n_samples, cols=(160, 224),
                                              n_timed=1, tracker=rec)
        if not bool(out["render_dyn_temporal_track_mask"].any()):
            raise AssertionError(f"{btag} the track layer is empty")
        cfg = slice_config(bundle, n_samples)
        track_breakdown(btag, data, cfg, rec, smi, require_points=False)
        log(f"{btag} K2 launches {launches['gnt_fused_mono3']}; track layer covers "
            f"{float(out['render_dyn_temporal_track_mask'].mean()):.4f} of the view; s/view "
            f"{statistics.mean(secs):.4f}; peak device memory of a render "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; on {smi}")
        del out, data


# ------------------------------------------------------------- CoTracker

COTRACKER_BUNDLE = "st_gnt_masked_attn_dy_cvd_pcl_clean_track_cotracker"
# the bundle on ±1 track frames (T = 4: one window each way; ~62k valid
# queries, 16 chunks of 4096): on ±5 (T = 12: two windows each way; ~310k
# queries, 76 chunks) CoTracker takes minutes a view by its FLOP count,
# which the smoke has no room for; [track-cotracker] predicts ±5 from the
# rate it measures, scripts/profile_port_render.py --tracker cotracker
# measures it
TRACK_K_COTRACKER = 1
# CoTrackerTracker on the card against the CPU: a T = 10 clip (windows at 0
# and 4, so the carry and the backward merge run) of 64x96 frames at the
# published 384x512 working size, six refinements, COTRACKER_QUERIES queries
# whose first frames fall in both windows, then COTRACKER_QUERIES_LARGE on
# the clip's first four frames (one window; attention and the GEMMs nearer
# the shapes of a production chunk); both sides float32 with TF32 off.
# The encoder's features (up to ~3) within COTRACKER_FMAP_TOL; the tracks by
# median and 90th percentile of |card - CPU| (px) and a share moved by more
# than 8 px, as [track-tapir] holds TAPIR (six refinements feed the sampled
# correlation back into the positions); visibility agreeing on
# COTRACKER_VIS_SHARE. Chunked tracking equals one-set calls bit for bit.
COTRACKER_CLIP = (10, 64, 96)
COTRACKER_QUERIES = 64
COTRACKER_QUERIES_LARGE = 1024
COTRACKER_FMAP_TOL = 1e-3
COTRACKER_TRACK_MEDIAN = 0.05
COTRACKER_TRACK_P90 = 0.5
COTRACKER_OUTLIERS = 0.05
COTRACKER_VIS_SHARE = 0.97
COTRACKER_CHUNK_VALID = 8192


def _conv_flops(cin, cout, k, h, w):
    return 2 * cin * cout * k * k * h * w


def cotracker_flops(n_valid, t_frames, iters=6, s=8, grid=36):
    """FLOPs of one ``make_tracker("cotracker")`` call on ``n_valid`` valid
    queries over ``t_frames`` frames (what this data needs): the encoder once
    per frame at 384x512, then per chunk of 4096 (its queries plus the
    support grid, N tokens), forward and time-flipped, per window and
    refinement: the dense layers (42.9 MFLOP a token), space attention (1536
    N^2 a frame and block), time attention and the correlation against the
    four pyramid levels."""
    from pgdvs_tpu_torch.models.tracking.cotracker import CHUNK, INTERP_HW

    hi, wi = INTERP_HW
    h2, w2, h4, w4 = hi // 2, wi // 2, hi // 4, wi // 4
    h8, w8, h16, w16 = hi // 8, wi // 8, hi // 16, wi // 16
    enc = (_conv_flops(3, 64, 7, h2, w2) + 4 * _conv_flops(64, 64, 3, h2, w2)
           + _conv_flops(64, 96, 3, h4, w4) + 3 * _conv_flops(96, 96, 3, h4, w4)
           + _conv_flops(64, 96, 1, h4, w4)
           + _conv_flops(96, 128, 3, h8, w8) + 3 * _conv_flops(128, 128, 3, h8, w8)
           + _conv_flops(96, 128, 1, h8, w8)
           + 4 * _conv_flops(128, 128, 3, h16, w16) + _conv_flops(128, 128, 1, h16, w16)
           + _conv_flops(416, 256, 3, h4, w4) + _conv_flops(256, 128, 1, h4, w4))
    dense = 2 * (456 * 384 + 12 * (384 * 1152 + 384 * 384 + 2 * 384 * 1536) + 384 * 130
                 + 128 * 128 + 128)
    levels = sum((h4 >> lvl) * (w4 >> lvl) for lvl in range(4))
    windows = len(range(0, max(t_frames - s // 2, 1), s // 2))
    total = enc * t_frames
    for start in range(0, n_valid, CHUNK):
        n = min(CHUNK, n_valid - start) + grid
        per_frame = (n * dense + 6 * 4 * n * n * 384 + 6 * 4 * n * s * 384
                     + 2 * n * 128 * levels)
        total += 2 * windows * iters * s * per_frame
    return total


def phase_track_cotracker(models, smi, h=288, w=550, n_samples=256):
    """[track-cotracker]: CoTracker on seeded, damped random weights
    (``init_cotracker_weights``: no checkpoint is in the repository). (a)
    ``CoTrackerTracker(chunk=None)`` on the card against the CPU on
    COTRACKER_CLIP (the encoder, the tracks, the visibility) and on
    COTRACKER_QUERIES_LARGE queries over its first four frames; (b)
    COTRACKER_CHUNK_VALID valid queries among invalid slots with chunks of
    4096 against one-set calls on each chunk's valid queries, and one set
    on the compacted valid queries against a single chunk of them: equal;
    (c) the CoTracker bundle at 288x550 (10 sources, 256 samples, ±1 track
    frames, make_tracker's chunks of 4096) through ``phase_main_path`` (78
    K2 launches, the static crop against the CPU, s/view after a warm-up,
    peak memory) and ``track_breakdown``, the tracker's FLOPs and rate and
    the s/view they predict at ±5. Returns (c)'s launches."""
    import copy
    import math

    import torch

    from pgdvs_tpu_torch.data import synthetic
    from pgdvs_tpu_torch.models.tracking.cotracker import (CHUNK, CoTrackerModel,
                                                            CoTrackerTracker,
                                                            init_cotracker_weights)
    from pgdvs_tpu_torch.models.tracking.tapir import no_tf32
    from pgdvs_tpu_torch.renderers.dynamic_track import build_track_stack, select_queries

    tag = "[track-cotracker]"
    model = init_cotracker_weights(CoTrackerModel(), seed=SEED).eval()
    cpu = CoTrackerTracker(copy.deepcopy(model))
    card = CoTrackerTracker(model).to("cuda")
    t_n, fh, fw = COTRACKER_CLIP
    frames = np.stack([synthetic.render_frame(fh, fw, synthetic.camera_pose(i + 1, 10),
                                              0.3 + 0.05 * i)["rgb"] for i in range(t_n)])
    frames = torch.from_numpy(frames.astype(np.float32))
    rng = np.random.default_rng(SEED)

    def against_cpu(clip, n):
        """Tracks and visibility of ``n`` random queries over ``clip`` on the
        card against the CPU, held to the tolerances above."""
        t_c = clip.shape[0]
        qc = torch.from_numpy(np.stack([rng.integers(0, t_c, n), rng.uniform(0, fw - 1, n),
                                        rng.uniform(0, fh - 1, n)], axis=-1).astype(np.float32))
        if t_c > 8 and not ((qc[:, 0] < 4).any() and (qc[:, 0] >= 8).any()):
            raise AssertionError(f"{tag} the queries' first frames miss a window")
        (tr_card, vis_card), card_ms = _event_ms(lambda: card(clip.cuda(), qc.cuda()))
        t0 = time.perf_counter()
        tr_cpu, vis_cpu = cpu(clip, qc)
        cpu_s = time.perf_counter() - t0
        d = (tr_card.cpu() - tr_cpu).abs().numpy()
        med, p90, outl = float(np.median(d)), float(np.quantile(d, 0.9)), float((d > 8.0).mean())
        vis_share = float((vis_card.cpu() == vis_cpu).float().mean())
        if not (med <= COTRACKER_TRACK_MEDIAN and p90 <= COTRACKER_TRACK_P90
                and outl <= COTRACKER_OUTLIERS and vis_share >= COTRACKER_VIS_SHARE):
            raise AssertionError(f"{tag} card vs CPU at T {t_c}, {n} queries: tracks median "
                                 f"{med}, p90 {p90}, outliers {outl}, visibility agreeing "
                                 f"{vis_share}")
        log(f"{tag} CoTrackerTracker card vs CPU (T {t_c}, {fh}x{fw} -> 384x512, {n} queries "
            f"+ the 6x6 grid, 6 refinements, TF32 off): tracks |d| median {med:.2e} p90 "
            f"{p90:.2e} px, share > 8 px {outl:.4f}, visibility agreeing {vis_share:.4f} "
            f"(visible on the card {float(vis_card.float().mean()):.4f}); card {card_ms:.1f} ms "
            f"(first call at this size), CPU {cpu_s:.2f} s")

    with torch.no_grad(), no_tf32():
        fmap_err = float((card.encode(frames.cuda()).cpu() - cpu.encode(frames)).abs().max())
    if not fmap_err <= COTRACKER_FMAP_TOL:
        raise AssertionError(f"{tag} card vs CPU: encoder max err {fmap_err}")
    log(f"{tag} encoder card vs CPU (T {t_n}, {fh}x{fw} -> 384x512): max err {fmap_err:.2e}")
    against_cpu(frames, COTRACKER_QUERIES)
    against_cpu(frames[:4], COTRACKER_QUERIES_LARGE)
    del cpu

    # (b) chunks against one-set calls, on the clip's first four frames
    t4 = frames[:4].cuda()
    slots, nv = COTRACKER_CHUNK_VALID * 3 // 2, COTRACKER_CHUNK_VALID
    qq = torch.from_numpy(np.stack([rng.integers(0, 4, slots), rng.uniform(0, fw - 1, slots),
                                    rng.uniform(0, fh - 1, slots)],
                                   axis=-1).astype(np.float32)).cuda()
    valid = torch.zeros(slots, dtype=torch.bool)
    valid[torch.from_numpy(rng.choice(slots, nv, replace=False))] = True
    valid = valid.cuda()
    rows = torch.nonzero(valid)[:, 0]
    (tr, vis), chunked_ms = _event_ms(lambda: CoTrackerTracker(model, chunk=CHUNK)(t4, qq,
                                                                                   valid))
    same = not bool(tr[~valid].any()) and not bool(vis[~valid].any())
    one_ms = []
    for i in range(0, nv, CHUNK):
        sel = rows[i:i + CHUNK]
        (ref_tr, ref_vis), ms = _event_ms(lambda: card(t4, qq[sel]))
        one_ms.append(ms)
        same &= torch.equal(tr[sel], ref_tr) and torch.equal(vis[sel], ref_vis)
    (big_tr, big_vis), big_ms = _event_ms(lambda: CoTrackerTracker(model, chunk=nv)(t4, qq,
                                                                                    valid))
    (whole_tr, whole_vis), whole_ms = _event_ms(lambda: card(t4, qq[rows]))
    same_big = torch.equal(big_tr[rows], whole_tr) and torch.equal(big_vis[rows], whole_vis)
    if not (same and same_big):
        raise AssertionError(f"{tag} chunked tracking differs from one-set calls: chunks of "
                             f"{CHUNK} {same}, one chunk of {nv} {same_big}")
    log(f"{tag} {nv} valid queries of {slots} slots (T 4) in chunks of {CHUNK} == one-set "
        f"calls on each chunk's valid queries, invalid rows zero and invisible; a chunk of "
        f"{nv} == one set on the compacted queries; bit for bit. Device ms: chunked "
        f"{chunked_ms:.1f}, one-set per chunk " + ", ".join(f"{x:.1f}" for x in one_ms)
        + f", one chunk of {nv} {big_ms:.1f}, one set of {nv} {whole_ms:.1f}")
    del tr, vis, big_tr, big_vis, whole_tr, whole_vis, qq

    # (c) the bundle at 288x550, make_tracker's chunks
    btag = f"{tag}[bundle]"
    data = _track_contract(h, w, TRACK_K_COTRACKER, "cuda")
    rec = RecordingTracker(CoTrackerTracker(model, chunk=CHUNK))
    launches, secs, out = phase_main_path(models, bundle=COTRACKER_BUNDLE, data=data, tag=btag,
                                          n_samples=n_samples, cols=(160, 224), n_timed=1,
                                          tracker=rec)
    if not bool(out["render_dyn_temporal_track_mask"].any()):
        raise AssertionError(f"{btag} the track layer is empty")
    cfg = slice_config(COTRACKER_BUNDLE, n_samples)
    stats = track_breakdown(btag, data, cfg, rec, smi, require_points=False)
    nq = stats["valid_queries"]
    t_slots = 2 * TRACK_K_COTRACKER + 2
    flops = cotracker_flops(nq, t_slots)
    track_s = rec.calls[-1]["ms"] / 1e3
    rate = flops / track_s
    far = _track_contract(h, w, TRACK_K, "cuda")
    nq5 = int(select_queries(build_track_stack(far), h * w)[1].sum())
    flops5 = cotracker_flops(nq5, 2 * TRACK_K + 2)
    rest = statistics.mean(secs) - track_s
    log(f"{btag} K2 launches {launches['gnt_fused_mono3']}; tracker: {nq} valid queries in "
        f"{math.ceil(nq / CHUNK)} chunks of {CHUNK}, T {t_slots}, "
        f"{flops / 1e12:.2f} TFLOP in {track_s:.3f} s = {rate / 1e12:.2f} TFLOP/s; track layer "
        f"covers {float(out['render_dyn_temporal_track_mask'].mean()):.4f} of the view; s/view "
        f"{statistics.mean(secs):.4f} (the rest of the render {rest:.3f} s); peak device memory "
        f"of a render {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; on {smi}")
    log(f"{btag} predicted at ±{TRACK_K} track frames (T {2 * TRACK_K + 2}, {nq5} valid "
        f"queries, {math.ceil(nq5 / CHUNK)} chunks): {flops5 / 1e12:.1f} TFLOP, "
        f"{flops5 / rate + rest:.1f} s/view at this rate")
    return launches


def phase_track_cotracker_cli(models, root, smi, eval_hw=READER_EVAL_HW, n_samples=256):
    """[track-cotracker][cli]: ``run benchmark --benchmark-type
    st_gnt_masked_attn_dy_cvd_pcl_clean_track_cotracker`` in-process over
    [reader]'s first item with ±1 track frames (``--dataset-arg
    n_src_views_temporal_track_one_side=1``), ``$PGDVS_CKPT_DIR`` the [eval]
    checkpoints plus a seeded, damped CoTracker state dict in the
    reference's key layout saved as
    ``cotracker/cotracker_stride_4_wind_8.pth`` (so the card runs the .pth
    loader and ``make_tracker``): 78 K2 launches, the pickle, summary.json
    and PNG checked as [eval] checks them. Returns the launches."""
    import os

    import torch

    from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset
    from pgdvs_tpu_torch.models.tracking.cotracker import CoTrackerModel, init_cotracker_weights
    from pgdvs_tpu_torch.renderers.static_gnt import resolve_epipolar_cfg

    tag = "[track-cotracker][cli]"
    scene, ckpts = root / "scene", root / "ckpts"
    pth = ckpts / "cotracker" / "cotracker_stride_4_wind_8.pth"
    pth.parent.mkdir(parents=True, exist_ok=True)
    torch.save(init_cotracker_weights(CoTrackerModel(), seed=SEED).state_dict(), pth)
    ds = NvidiaEvalDataset(scene, scene_ids=[READER_SCENE], tgt_height=eval_hw[0],
                           with_track_sources=True,
                           n_src_views_temporal_track_one_side=TRACK_K_COTRACKER)
    items = [ds[0]]
    h, w = items[0]["rgb_tgt"].shape[:2]
    cfg = resolve_epipolar_cfg(slice_config(COTRACKER_BUNDLE, n_samples), models[1], h, w)[0]
    want = expected_launches(cfg, h * w)
    out = root / "cotracker_benchmark"
    old = os.environ.get("PGDVS_CKPT_DIR")
    os.environ["PGDVS_CKPT_DIR"] = str(ckpts)
    try:
        result, renders, _stages = _run_cli(
            ["benchmark", "--benchmark-type", COTRACKER_BUNDLE, "--data-root", str(scene),
             "--scene-ids", READER_SCENE, "--max-items", "1", "--device", "cuda",
             "--dataset-arg", f"tgt_height={eval_hw[0]}",
             f"n_src_views_temporal_track_one_side={TRACK_K_COTRACKER}",
             "--render-cfg", f"n_coarse_samples_per_ray={n_samples}", "--out-dir", str(out)],
            tag, 1, want)
    finally:
        if old is None:
            os.environ.pop("PGDVS_CKPT_DIR", None)
        else:
            os.environ["PGDVS_CKPT_DIR"] = old
    worst = _check_eval_outputs(out, result, renders, items, random_lpips(), tag)
    n_track = int(items[0]["n_actual_src_track_fwd"][0] + items[0]["n_actual_src_track_bwd"][0])
    log(f"{tag} run benchmark --benchmark-type {COTRACKER_BUNDLE} with {pth.name} from "
        f"$PGDVS_CKPT_DIR: 1 item ({n_track} real track frames), {cfg.epipolar_mode} sampling, "
        f"launches {_nonzero(want)}; pickle == compute_nvidia_metrics on the CPU (LPIPS rel "
        f"{worst:.2e}), summary.json, PNG == truncated render; render s/view "
        f"{renders[0][0]:.4f}; mean " + json.dumps(result["mean"]) + f"; on {smi}")
    return want


def phase_track_eval(models, root, smi, n_items=TRACK_EVAL_ITEMS, eval_hw=READER_EVAL_HW,
                     n_samples=256):
    """[track-eval]: ``python -m pgdvs_tpu_torch.run benchmark --benchmark-type
    st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir`` in-process over the
    first ``n_items`` items of [reader]'s scene (24 frames, read with its
    track sources), ``$PGDVS_CKPT_DIR`` the [eval] checkpoints (the GNT and
    the LPIPS backbone; no TAPIR checkpoint: random weights): 78 K2
    launches per item, the pickles, summary.json and PNGs checked as
    [eval] checks them, s/view of the renders."""
    import os

    from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset
    from pgdvs_tpu_torch.renderers.static_gnt import resolve_epipolar_cfg

    tag = "[track-eval]"
    bundle = TRACK_BUNDLES[0]
    scene, ckpts = root / "scene", root / "ckpts"
    ds = NvidiaEvalDataset(scene, scene_ids=[READER_SCENE], tgt_height=eval_hw[0],
                           with_track_sources=True)
    items = [ds[i] for i in range(n_items)]
    h, w = items[0]["rgb_tgt"].shape[:2]
    cfg = resolve_epipolar_cfg(slice_config(bundle, n_samples), models[1], h, w)[0]
    want = expected_launches(cfg, h * w)
    out = root / "track_benchmark"
    old = os.environ.get("PGDVS_CKPT_DIR")
    os.environ["PGDVS_CKPT_DIR"] = str(ckpts)
    try:
        result, renders, _stages = _run_cli(
            ["benchmark", "--benchmark-type", bundle, "--data-root", str(scene), "--scene-ids",
             READER_SCENE, "--max-items", str(n_items), "--device", "cuda", "--dataset-arg",
             f"tgt_height={eval_hw[0]}", "--render-cfg", f"n_coarse_samples_per_ray={n_samples}",
             "--out-dir", str(out)], tag, n_items, want)
    finally:
        if old is None:
            os.environ.pop("PGDVS_CKPT_DIR", None)
        else:
            os.environ["PGDVS_CKPT_DIR"] = old
    worst = _check_eval_outputs(out, result, renders, items, random_lpips(), tag)
    n_track = [int(it["n_actual_src_track_fwd"][0] + it["n_actual_src_track_bwd"][0])
               for it in items]
    log(f"{tag} run benchmark --benchmark-type {bundle}: {n_items} items (real track frames "
        f"{n_track}), {cfg.epipolar_mode} sampling, launches per item {_nonzero(want)}; pickles "
        f"== compute_nvidia_metrics on the CPU (PSNR / SSIM bit for bit, LPIPS rel "
        f"{worst:.2e}), summary.json, PNGs == truncated renders; render s/view "
        + " ".join(f"{secs:.4f}" for secs, _ in renders) + "; mean " + json.dumps(result["mean"])
        + f"; on {smi}")


# ------------------------------------------------------- vis and DyCheck (PR 15)

VIS_BUNDLE = "visualize_nvidia_max_disp_32"
# [reader]'s 24-frame scene (flows at the frame size), the bullet-time
# trajectory cut from 400 frames to VIS_FRAMES around frame 12
# cut from 4 (~14 s of the script's time) to make room for [train] / [parallel]
VIS_FRAMES = 2               # ~7 s a frame of the script's time
VIS_ARGS = (f"n_render_frames={VIS_FRAMES}", "vis_center_time=12", "vis_time_interval=6")
VIS_FLOW_FRAMES = ((6, 20),)
VIS_ROWS, VIS_COLS = (284, 288), (520, 584)
MONO_SCENE = "lady-running"
MONO_HW = (480, 854)          # DAVIS 480p
MONO_FRAMES = 12
MONO_VIS_FRAMES = 2          # cut from 4 (~3.5 s a frame)
MONO_ARGS = (f"n_render_frames={MONO_VIS_FRAMES}", "vis_center_time=5", "vis_time_interval=1.5")
MONO_ROWS, MONO_COLS = (236, 244), (400, 464)
DYCHECK_ROWS, DYCHECK_COLS = (176, 180), (200, 264)
DYCHECK_SPATIAL = 10


def write_mono_scene(root, hw=MONO_HW, n_frames=MONO_FRAMES, seed=SEED):
    """Write the synthetic scene under ``root/MONO_SCENE`` in the layout of
    the preprocessing's output that ``MonoVisDataset`` reads (the DAVIS
    captures'), through the port's ``write_png`` only: per frame the rgb PNG
    at ``hw``, ``poses/<name>.npz`` {K 4x4, c2w} on the synthetic arc, the
    z-depth npz, the 1-bit dynamic mask, and flows at interval 1 between
    consecutive frames with a coord_diff from ``seed`` that marks ~6 % of
    the pixels occluded. Returns the scene's directory."""
    import numpy as np

    from pgdvs_tpu_torch.data import synthetic
    from pgdvs_tpu_torch.data.image_io import write_png

    h, w = hw
    scene = root / MONO_SCENE
    for sub in ("rgbs", "poses", "depths", "masks/final", "flows/interval_1"):
        (scene / sub).mkdir(parents=True, exist_ok=True)
    k = synthetic.intrinsics(h, w)
    frames = []
    for i in range(n_frames):
        c2w = synthetic.camera_pose(i, n_frames)
        fr = synthetic.render_frame(h, w, c2w, i / (n_frames - 1))
        frames.append((fr, c2w))
        name = f"{i:05d}"
        write_png(scene / "rgbs" / f"{name}.png", (fr["rgb"] * 255).astype(np.uint8))
        np.savez(scene / "poses" / f"{name}.npz", K=k, c2w=c2w)
        np.savez(scene / "depths" / f"{name}.npz", depth=fr["depth"][..., 0].astype(np.float32))
        write_png(scene / "masks/final" / f"{name}_final.png", fr["dyn_mask"][..., 0] > 0)
    rng = np.random.default_rng(seed)
    for a in range(n_frames - 1):
        for i, j in ((a, a + 1), (a + 1, a)):
            flow = synthetic.flow_between(h, w, frames[i][0], frames[i][1], i / (n_frames - 1),
                                          frames[j][1], j / (n_frames - 1))
            np.savez(scene / f"flows/interval_1/{i:05d}_{j:05d}.npz", flow=flow,
                     coord_diff=rng.uniform(0, 0.6, (h, w, 2)).astype(np.float32))
    return scene


def _run_vis_cli(argv, tag, n_frames, want, dataset_cls, device="cuda", keep=0):
    """``_run_hooked`` on the visualizer: host seconds of the reader's
    ``__getitem__`` (its calls summed; two threads read ahead while the card
    renders) and of ``Visualizer.run``. Returns (the Visualizer, [(render s,
    image)], {stage: seconds}, render ``keep``'s static layer)."""
    from pgdvs_tpu_torch.engines import visualizer as vz

    targets = [(dataset_cls, "__getitem__", "reader"), (vz.Visualizer, "run", "loop")]
    return _run_hooked(argv, tag, n_frames, want, vz, targets, device, keep)


def _check_vis_outputs(tag, out, vis, renders):
    """One PNG per frame, each the frame's render truncated to uint8; the
    video written or skipped as ``images_to_video`` says."""
    import numpy as np

    from pgdvs_tpu_torch.data.image_io import read_png

    pngs = sorted(out.glob("*_combined.png"))
    if [p.name for p in pngs] != [f"{i:06d}_combined.png" for i in range(len(renders))]:
        raise AssertionError(f"{tag} PNGs {[p.name for p in pngs]}")
    for i, (p, (_secs, pred)) in enumerate(zip(pngs, renders)):
        if not np.isfinite(pred).all():
            raise AssertionError(f"{tag} frame {i} is not finite")
        if not np.array_equal(read_png(p), (np.clip(pred, 0.0, 1.0) * 255).astype(np.uint8)):
            raise AssertionError(f"{tag} frame {i}: the PNG is not the truncated render")
    if vis.video_written != (out / "video_combined.mp4").is_file():
        raise AssertionError(f"{tag} video_written {vis.video_written} but the file says not")
    return "written" if vis.video_written else "skipped (no imageio-ffmpeg)"


def phase_vis(models, root, smi, raw_hw=READER_RAW_HW, device="cuda", rows=VIS_ROWS,
              cols=VIS_COLS, n_samples=256):
    """[vis]: ``run benchmark --benchmark-type visualize_nvidia_max_disp_32``
    in-process on [reader]'s 24-frame scene at 576x1100 (written anew with
    flows at the frame size, which the vis reader renders at), the
    trajectory cut to VIS_FRAMES frames by ``--dataset-arg`` (K2 masked,
    one launch per 2048-ray tile of the frame); each PNG the frame's render
    truncated; frame 0's static layer held against the CPU on a crop; s/frame,
    host ms per item, the video written or skipped. Returns the launches per
    frame."""
    import statistics

    from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.data.nvidia_vis import NvidiaVisDataset
    from pgdvs_tpu_torch.renderers.static_gnt import resolve_epipolar_cfg
    from pgdvs_tpu_torch.run import _coerce

    tag = "[vis]"
    scene = root / "vis_scene"
    t0 = time.perf_counter()
    write_reader_scene(scene, raw_hw=raw_hw, eval_hw=raw_hw, items=(),
                       flow_frames=VIS_FLOW_FRAMES)
    t_write = time.perf_counter() - t0
    kw = dict(data_root=scene, scene_ids=[READER_SCENE], vis_bt_max_disp=32,
              **{k: _coerce(v) for k, v in (a.split("=") for a in VIS_ARGS)})
    ds = NvidiaVisDataset(**kw)
    t0 = time.perf_counter()
    item0 = ds[0]
    t_item = time.perf_counter() - t0
    h, w = item0["rgb_src_temporal"].shape[1:3]
    cfg = resolve_benchmark(VIS_BUNDLE, "fast")[0].replace(n_coarse_samples_per_ray=n_samples)
    cfg = resolve_epipolar_cfg(cfg, models[1], h, w)[0]
    want = expected_launches(cfg, h * w)
    out = root / "vis_out"
    vis, renders, stages, kept = _run_vis_cli(
        ["benchmark", "--benchmark-type", VIS_BUNDLE, "--data-root", str(scene), "--scene-ids",
         READER_SCENE, "--dataset-arg", *VIS_ARGS, "--device", device, "--out-dir", str(out),
         "--render-cfg", f"n_coarse_samples_per_ray={n_samples}"],
        tag, VIS_FRAMES, want, NvidiaVisDataset, device)
    video = _check_vis_outputs(tag, out, vis, renders)
    errs = check_crop(tag, models, contract_to_device(item0, device), cfg, kept, rows, cols)
    secs = [t for t, _ in renders]
    times = [round(t[1], 4) for t in ds.traj]
    log(f"{tag} run benchmark --benchmark-type {VIS_BUNDLE} --dataset-arg {' '.join(VIS_ARGS)}: "
        f"scene {raw_hw[0]}x{raw_hw[1]} written in {t_write:.3f} s; {len(renders)} frames at "
        f"{h}x{w} (trajectory times {times}), {cfg.epipolar_mode} sampling, launches per frame "
        f"{_nonzero(want)}; PNGs == truncated renders; video {video}")
    log(f"{tag} frame 0 crop rows {rows} cols {cols} vs plain path on CPU: {errs}")
    log(f"{tag} s/frame " + " ".join(f"{t:.4f}" for t in secs)
        + f"; mean of frames 1.. {statistics.mean(secs[1:]):.4f}; Visualizer.run "
        f"{stages['loop']:.3f} s; host ms per item: 0 workers {1e3 * t_item:.1f}, in the run "
        f"(2 threads beside the renders) {1e3 * stages['reader'] / len(renders):.1f}; on {smi}")
    return want


def phase_mono_vis(models, root, smi, hw=MONO_HW, device="cuda", rows=MONO_ROWS,
                   cols=MONO_COLS, n_samples=256):
    """[mono-vis]: a DAVIS-layout scene at 480x854 (``write_mono_scene``,
    12 frames) through ``run vis --dataset mono_vis`` in-process for
    MONO_VIS_FRAMES frames on the fast preset (K1 patch_rows, one launch per
    2048-ray tile); checked as [vis]. Returns the launches per frame."""
    import statistics

    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.data.mono_vis import MonoVisDataset
    from pgdvs_tpu_torch.renderers.static_gnt import resolve_epipolar_cfg
    from pgdvs_tpu_torch.run import _coerce

    tag = "[mono-vis]"
    t0 = time.perf_counter()
    write_mono_scene(root / "mono", hw)
    t_write = time.perf_counter() - t0
    ds = MonoVisDataset(root / "mono", [MONO_SCENE], vis_bt_max_disp=64,
                        **{k: _coerce(v) for k, v in (a.split("=") for a in MONO_ARGS)})
    t0 = time.perf_counter()
    item0 = ds[0]
    t_item = time.perf_counter() - t0
    h, w = item0["rgb_src_temporal"].shape[1:3]
    cfg = resolve_epipolar_cfg(slice_config(None, n_samples), models[1], h, w)[0]
    want = expected_launches(cfg, h * w)
    out = root / "mono_out"
    vis, renders, stages, kept = _run_vis_cli(
        ["vis", "--dataset", "mono_vis", "--data-root", str(root / "mono"), "--scene-ids",
         MONO_SCENE, "--dataset-arg", *MONO_ARGS, "--device", device, "--out-dir", str(out),
         "--render-cfg", f"n_coarse_samples_per_ray={n_samples}"],
        tag, MONO_VIS_FRAMES, want, MonoVisDataset, device)
    video = _check_vis_outputs(tag, out, vis, renders)
    errs = check_crop(tag, models, contract_to_device(item0, device), cfg, kept, rows, cols)
    secs = [t for t, _ in renders]
    log(f"{tag} run vis --dataset mono_vis --dataset-arg {' '.join(MONO_ARGS)}: scene "
        f"{hw[0]}x{hw[1]}, {MONO_FRAMES} frames, written in {t_write:.3f} s; "
        f"{len(renders)} frames (times {[round(t[1], 4) for t in ds.traj]}), "
        f"{cfg.epipolar_mode} sampling, launches per frame {_nonzero(want)}; PNGs == "
        f"truncated renders; video {video}")
    log(f"{tag} frame 0 crop rows {rows} cols {cols} vs plain path on CPU: {errs}")
    log(f"{tag} s/frame " + " ".join(f"{t:.4f}" for t in secs)
        + f"; mean of frames 1.. {statistics.mean(secs[1:]):.4f}; host ms per item: 0 workers "
        f"{1e3 * t_item:.1f}, in the run {1e3 * stages['reader'] / len(renders):.1f}; on {smi}")
    return want


def phase_dycheck(models, root, smi, hw=IPHONE_HW, device="cuda", rows=DYCHECK_ROWS,
                  cols=DYCHECK_COLS, n_samples=256):
    """[dycheck]: a synthetic iPhone capture (``write_iphone_capture``:
    360x480 at factor 2, 24 train frames, two val frames, one at a train
    time and one between two) through ``run benchmark --benchmark-type
    default --dataset-family dycheck_iphone`` in-process on the fast and the
    exact preset, ``$PGDVS_CKPT_DIR`` the [eval] checkpoints (so mLPIPS is
    scored): DYCHECK_SPATIAL clustered spatial sources, the per-pixel depth
    range, K2 masked (fast) or K2 unfolded (exact) once per 2048-ray tile;
    each pickle equal to the covisible metrics recomputed on the CPU from its
    render (mPSNR / mSSIM bit for bit, mLPIPS at LPIPS_RTOL), summary.json,
    PNGs; item 1's static layer held against the CPU on a crop (the
    per-pixel ranges); the spatial indices KMeans chose, host ms per item
    and of the KMeans refit, s/item. Returns {preset: launches per item}."""
    import os
    import pickle

    import numpy as np

    from pgdvs_tpu_torch.data.dycheck_iphone import DyCheckIPhoneEvalDataset
    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.engines import evaluator as ev
    from pgdvs_tpu_torch.renderers.static_gnt import resolve_epipolar_cfg

    tag = "[dycheck]"
    t0 = time.perf_counter()
    write_iphone_capture(root / "iphone", hw)
    t_write = time.perf_counter() - t0
    dargs = {"mask_data_dir": str(root / "iphone" / "masks"),
             "flow_data_dir": str(root / "iphone" / "flows")}
    ds = DyCheckIPhoneEvalDataset(root / "iphone" / "raw", [IPHONE_SCENE], **dargs)
    items, t_items, t_km = [], [], []
    for i in range(len(ds)):
        with StageTimer([(DyCheckIPhoneEvalDataset, "select_spatial", "kmeans")]) as timer:
            t0 = time.perf_counter()
            items.append(ds[i])
            t_items.append(time.perf_counter() - t0)
        t_km.append(timer.seconds["kmeans"])
    h, w = items[0]["rgb_tgt"].shape[:2]
    dr = items[1]["depth_range"]
    pinned = float(np.isclose(dr[..., 1] - dr[..., 0], 2e-4, atol=1e-6).mean())
    log(f"{tag} capture {h}x{w} (factor 2), {IPHONE_TRAIN} train frames, val times "
        f"{[float(it['time_tgt'][0]) for it in items]}, written in {t_write:.3f} s; spatial sources "
        f"(KMeans, {DYCHECK_SPATIAL} clusters) {[it['seq_ids'][1:1 + DYCHECK_SPATIAL].tolist() for it in items]}; "
        f"temporal {[it['seq_ids'][1 + DYCHECK_SPATIAL:].tolist() for it in items]}; per-pixel "
        f"depth range {tuple(dr.shape)}, {pinned:.4f} of item 1's pixels pinned to +-1e-4; host "
        f"ms per item (0 workers) {[round(1e3 * t, 1) for t in t_items]}, of it the KMeans "
        f"refit {[round(1e3 * t, 2) for t in t_km]}")
    lpips_cpu = random_lpips()
    old = os.environ.get("PGDVS_CKPT_DIR")
    os.environ["PGDVS_CKPT_DIR"] = str(root / "ckpts")
    launches = {}
    try:
        for preset in ("fast", "exact"):
            cfg = resolve_epipolar_cfg(slice_config("default", n_samples, preset), models[1],
                                       h, w)[0]
            want = expected_launches(cfg, h * w)
            out = root / f"dycheck_{preset}"
            result, renders, stages, kept = _run_cli(
                ["benchmark", "--benchmark-type", "default", "--dataset-family", "dycheck_iphone",
                 "--perf-preset", preset, "--data-root", str(root / "iphone" / "raw"),
                 "--scene-ids", IPHONE_SCENE, "--dataset-arg",
                 *(f"{k}={v}" for k, v in dargs.items()), "--device", device, "--out-dir",
                 str(out), "--render-cfg", f"n_coarse_samples_per_ray={n_samples}"],
                f"{tag}[{preset}]", len(items), want, device,
                extra_targets=[(DyCheckIPhoneEvalDataset, "__getitem__", "reader"),
                               (DyCheckIPhoneEvalDataset, "select_spatial", "kmeans")], keep=1)
            summary = json.loads((out / "summary.json").read_text())
            if summary != json.loads(json.dumps(result)):
                raise AssertionError(f"{tag}[{preset}] summary.json is not the run's result")
            worst = 0.0
            for i, ((_t, pred), item) in enumerate(zip(renders, items)):
                rec = pickle.loads((out / f"{i:06d}.pkl").read_bytes())
                ref = ev.compute_dycheck_metrics(pred, item["rgb_tgt"],
                                                 item["misc"]["covisible_mask"], lpips_cpu)
                if sorted(rec) != sorted([*ref, "render_wall_s", "scene_id"]):
                    raise AssertionError(f"{tag}[{preset}] item {i}: keys {sorted(rec)}")
                for k in ("mpsnr", "mssim"):
                    if rec[k] != ref[k]:
                        raise AssertionError(f"{tag}[{preset}] item {i} {k}: {rec[k]} vs "
                                             f"{ref[k]} recomputed on the CPU")
                err = abs(rec["mlpips"] - ref["mlpips"]) / abs(ref["mlpips"])
                worst = max(worst, err)
                if not err <= LPIPS_RTOL:
                    raise AssertionError(f"{tag}[{preset}] item {i} mlpips: {rec['mlpips']} vs "
                                         f"{ref['mlpips']}")
                if not (out / f"{i:06d}_combined.png").is_file():
                    raise AssertionError(f"{tag}[{preset}] item {i}: no PNG")
            errs = check_crop(f"{tag}[{preset}]", models, contract_to_device(items[1], device),
                              cfg, kept, rows, cols)
            launches[preset] = want
            log(f"{tag}[{preset}] run benchmark --dataset-family dycheck_iphone --perf-preset "
                f"{preset}: {len(renders)} items, {cfg.epipolar_mode} sampling, launches per item "
                f"{_nonzero(want)}; pickles == covisible metrics on the CPU (mPSNR / mSSIM "
                f"bit for bit, mLPIPS rel {worst:.2e}); item 1 crop rows {rows} cols "
                f"{cols} vs plain path on CPU: {errs}; s/item "
                + " ".join(f"{t:.4f}" for t in [t for t, _ in renders])
                + f"; host ms per item in the run {1e3 * stages['reader'] / len(renders):.1f} "
                f"(KMeans {1e3 * stages['kmeans'] / len(renders):.2f}); mean "
                + json.dumps(result["mean"]) + f"; on {smi}")
    finally:
        if old is None:
            os.environ.pop("PGDVS_CKPT_DIR", None)
        else:
            os.environ["PGDVS_CKPT_DIR"] = old
    return launches


PRE_CHECK_HW = (96, 128)      # (a): the card against the CPU
PRE_CHECK_ITERS = 12
RAFT_ITERS = 32               # the reference's iterations (compute_flow.py:221-238)
# the clip's frames: cut from 24 (~27 s of the script's time, the
# host mask tools ~0.8 s a frame); [depth] reads DEPTH_FRAMES of them
PRE_FRAMES = 8
# (a) bounds: encoders and correlation window within 1e-4 of their largest
# magnitude (float32 with TF32 off on both sides: other convolution and
# summation orders only); the 12-iteration flows (~0.5 px with the damped
# weights) within 1e-3 px at every pixel
RAFT_REL_TOL = 1e-4
RAFT_FLOW_TOL = 1e-3


def raft_flops(h, w, iters):
    """FLOPs of one ``RAFTFlow`` pair (forward and backward flow) of frames
    padded to h x w: the feature encoder over both frames and the context
    encoder over both (each ~86 GFLOP at 576x1104), per direction the
    correlation product [N, 256] x [256, N] with N = H/8 * W/8 and, per
    iteration, the update block's convolutions (~62 GFLOP at 576x1104).
    The lookup's taps, the norms, activations and the upsampling are
    elementwise and left out."""
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    enc = (_conv_flops(3, 64, 7, h2, w2) + 4 * _conv_flops(64, 64, 3, h2, w2)
           + _conv_flops(64, 96, 3, h4, w4) + 3 * _conv_flops(96, 96, 3, h4, w4)
           + _conv_flops(64, 96, 1, h4, w4)
           + _conv_flops(96, 128, 3, h8, w8) + 3 * _conv_flops(128, 128, 3, h8, w8)
           + _conv_flops(96, 128, 1, h8, w8) + _conv_flops(128, 256, 1, h8, w8))
    n = h8 * w8
    corr = 2 * n * n * 256
    update = (_conv_flops(324, 256, 1, h8, w8) + _conv_flops(256, 192, 3, h8, w8)
              + _conv_flops(2, 128, 7, h8, w8) + _conv_flops(128, 64, 3, h8, w8)
              + _conv_flops(256, 126, 3, h8, w8) + 6 * 2 * 384 * 128 * 5 * n
              + 2 * _conv_flops(128, 256, 3, h8, w8) + _conv_flops(256, 2, 3, h8, w8)
              + _conv_flops(256, 576, 1, h8, w8))
    return 4 * enc + 2 * (corr + iters * update)


def write_flow_clip(root, hw=READER_RAW_HW, n_frames=READER_FRAMES):
    """The synthetic scene as a video under ``root``: ``rgbs/<i:05d>.png``
    (``write_png``, filter types cycled) seen from the synthetic arc at
    times i / (n_frames - 1), and ``poses/<i:05d>.npz`` {c2w, K} (the
    ``depth_converters`` layout). Returns (rgb dir, pose dir)."""
    from pgdvs_tpu_torch.data import synthetic
    from pgdvs_tpu_torch.data.image_io import write_png

    rgb_dir, pose_dir = root / "rgbs", root / "poses"
    rgb_dir.mkdir(parents=True)
    pose_dir.mkdir()
    k = synthetic.intrinsics(*hw)
    for i in range(n_frames):
        c2w = synthetic.camera_pose(i, n_frames)
        fr = synthetic.render_frame(hw[0], hw[1], c2w, i / (n_frames - 1))
        write_png(rgb_dir / f"{i:05d}.png", (fr["rgb"] * 255).astype(np.uint8), "cycle")
        np.savez(pose_dir / f"{i:05d}.npz", c2w=c2w, K=k)
    return rgb_dir, pose_dir


def _raft_parts(model, frames, device, iters):
    """The feature and context encoders over both frames, the correlation
    window at coordinates 1.5 px off the grid, and the pair's flows."""
    import torch

    from pgdvs_tpu_torch.models.flow import raft

    x = torch.from_numpy(np.stack(frames)).to(device).permute(0, 3, 1, 2) * 2.0 - 1.0
    with torch.no_grad(), raft.no_tf32():
        fmaps, ctx = model.fnet(x), model.cnet(x)
        h8, w8 = fmaps.shape[2:]
        gy, gx = torch.meshgrid(torch.arange(h8, device=device), torch.arange(w8, device=device),
                                indexing="ij")
        coords = torch.stack([gx, gy], -1)[None].float() + 1.5
        corr = raft.lookup_corr(raft.build_corr_pyramid(fmaps[:1], fmaps[1:]), coords)
    fwd, bwd = raft.RAFTFlow(model, iters)(frames[0], frames[1])
    return {"fnet": fmaps, "cnet": ctx, "corr": corr, "flow_fwd": fwd, "flow_bwd": bwd}


class RecordingFlow:
    """Patches ``RAFTFlow.__call__`` while active: every pair is timed by
    CUDA events (the host clock on the CPU) and by the host clock around
    the call."""

    def __init__(self, device):
        self.device = device
        self.calls = []

    def __enter__(self):
        from pgdvs_tpu_torch.models.flow import raft

        self.orig = raft.RAFTFlow.__call__
        rec = self

        def recorded(flow, img1, img2):
            t0 = time.perf_counter()
            if rec.device == "cuda":
                out, ms = _event_ms(lambda: rec.orig(flow, img1, img2))
            else:
                out = rec.orig(flow, img1, img2)
                ms = (time.perf_counter() - t0) * 1e3
            rec.calls.append({"ms": ms, "wall_ms": (time.perf_counter() - t0) * 1e3})
            return out

        raft.RAFTFlow.__call__ = recorded
        return self

    def __exit__(self, *exc):
        from pgdvs_tpu_torch.models.flow import raft

        raft.RAFTFlow.__call__ = self.orig


def phase_preprocess(root, smi, device="cuda", raw_hw=READER_RAW_HW, n_frames=READER_FRAMES,
                     iters=RAFT_ITERS, check_hw=PRE_CHECK_HW, check_iters=PRE_CHECK_ITERS):
    """[preprocess]: flow and mask preprocessing (RAFT on seeded, damped
    random weights; the released checkpoint is not in the repository).

    (a) RAFT on the card against the port on the CPU with the same weights,
    two synthetic frames at ``check_hw``, ``check_iters`` iterations: both
    encoders and the correlation window within RAFT_REL_TOL of their
    largest magnitude, both flows within RAFT_FLOW_TOL px; (b) a
    ``n_frames`` clip at ``raw_hw`` written as PNGs (``write_flow_clip``),
    the weights saved as ``raft/models/raft-things.pth`` (the released key
    layout, ``module.`` prefix) under a ``$PGDVS_CKPT_DIR`` in ``root``, and
    ``python -m pgdvs_tpu_torch.preprocess.compute_flow --intervals 1`` run
    in-process (runpy) at ``iters`` iterations: the npz files, finite, one
    coord_diff against ``flow_roundtrip`` on the CPU; seconds per pair (the
    CLI's wall clock and RAFT's device time), FLOPs (``raft_flops``) and
    TFLOP/s, peak memory, RAFT's share of the CLI's time and the host
    seconds of the frames' reads and of the npz writes, then one more pair
    (the clip's first two frames) under ``torch.profiler``: kernel launches
    per pair, the busy share and the five kernels that take the most time;
    (c) ``epipolar_mask`` on those flows and the clip's poses, then
    ``combine_masks`` on its masks (as .npy) and the interval-1 flows:
    host seconds per frame of each, the dynamic share of the masks. Returns
    the hand kernels' launches over (b) and (c): none."""
    import copy
    import os
    import runpy

    import torch

    from pgdvs_tpu_torch.data import image_io, synthetic
    from pgdvs_tpu_torch.data.image_io import read_image
    from pgdvs_tpu_torch.models.flow import raft
    from pgdvs_tpu_torch.preprocess import combine_masks, epipolar_mask
    from pgdvs_tpu_torch.preprocess.flow_consistency import flow_roundtrip

    tag = "[preprocess]"
    cpu_model = raft.init_raft_weights(raft.RAFT(), seed=SEED).eval()
    card_model = copy.deepcopy(cpu_model).to(device)
    h, w = check_hw
    frames = [synthetic.render_frame(h, w, synthetic.camera_pose(i, 8), 0.3 + 0.1 * i)["rgb"]
              .astype(np.float32) for i in (0, 1)]
    got = _raft_parts(card_model, frames, device, check_iters)
    ref = _raft_parts(cpu_model, frames, "cpu", check_iters)
    errs = {}
    for key in ref:
        d = (got[key].float().cpu() - ref[key]).abs()
        scale = float(ref[key].abs().max())
        errs[key] = (float(d.max()), float(d.median()), scale)
        bound = RAFT_FLOW_TOL if key.startswith("flow") else RAFT_REL_TOL * scale
        if not (bool(torch.isfinite(got[key]).all()) and errs[key][0] <= bound):
            raise AssertionError(f"{tag} (a) {key}: max |card - cpu| {errs[key][0]:.3e} "
                                 f"over the bound {bound:.3e}")
    log(f"{tag} (a) RAFT card vs CPU at {h}x{w}, {check_iters} iterations: " + ", ".join(
        f"{k} max {e[0]:.3e} median {e[1]:.3e} (scale {e[2]:.3f})" for k, e in errs.items())
        + f"; bounds {RAFT_REL_TOL} x scale (encoders, correlation), {RAFT_FLOW_TOL} px (flows)")

    t0 = time.perf_counter()
    rgb_dir, pose_dir = write_flow_clip(root / "clip", raw_hw, n_frames)
    write_s = time.perf_counter() - t0
    pth = root / "ckpts" / "raft" / "models" / "raft-things.pth"
    pth.parent.mkdir(parents=True)
    torch.save({f"module.{k}": v for k, v in cpu_model.state_dict().items()}, pth)
    flows = root / "flows"
    old_env, old_argv = os.environ.get("PGDVS_CKPT_DIR"), sys.argv
    os.environ["PGDVS_CKPT_DIR"] = str(root / "ckpts")
    sys.argv = ["compute_flow", "--rgb-dir", str(rgb_dir), "--save-dir", str(flows),
                "--intervals", "1", "--iters", str(iters), "--device", device]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    host = {"read_rgb": 0.0, "savez": 0.0}
    orig_read, orig_savez = image_io.read_rgb, np.savez

    def timed(key, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                host[key] += time.perf_counter() - t
        return run

    image_io.read_rgb, np.savez = timed("read_rgb", orig_read), timed("savez", orig_savez)
    try:
        with RecordingFlow(device) as rec:
            t0 = time.perf_counter()
            runpy.run_module("pgdvs_tpu_torch.preprocess.compute_flow", run_name="__main__")
            cli_s = time.perf_counter() - t0
    finally:
        image_io.read_rgb, np.savez = orig_read, orig_savez
        sys.argv = old_argv
        if old_env is None:
            os.environ.pop("PGDVS_CKPT_DIR", None)
        else:
            os.environ["PGDVS_CKPT_DIR"] = old_env
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
    n_pairs = n_frames - 1
    files = sorted((flows / "interval_1").glob("*.npz"))
    if len(files) != 2 * n_pairs or len(rec.calls) != n_pairs:
        raise AssertionError(f"{tag} (b) {len(files)} npz files from {len(rec.calls)} pairs, "
                             f"expected {2 * n_pairs} from {n_pairs}")
    for f in files:
        z = np.load(f)
        for key in ("flow", "coord_diff"):
            if z[key].shape != raw_hw + (2,) or not np.isfinite(z[key]).all():
                raise AssertionError(f"{tag} (b) {f.name}:{key} {z[key].shape} or not finite")
    z01, z10 = (np.load(flows / "interval_1" / n) for n in ("00000_00001.npz", "00001_00000.npz"))
    cd = flow_roundtrip(torch.from_numpy(z01["flow"]), torch.from_numpy(z10["flow"]))[0]
    cd_err = float(np.abs(cd.numpy() - z01["coord_diff"]).max())
    if cd_err > 1e-4:
        raise AssertionError(f"{tag} (b) coord_diff off the CPU round trip by {cd_err:.3e}")
    ph, pw = -(-raw_hw[0] // 8) * 8, -(-raw_hw[1] // 8) * 8
    flops = raft_flops(ph, pw, iters)
    timed = [c["ms"] for c in rec.calls]
    ms = statistics.median(timed)
    raft_s = sum(timed) / 1e3
    wall_s = sum(c["wall_ms"] for c in rec.calls) / 1e3
    busy = "no device activity seen by the profiler"
    if device == "cuda":
        pair = [image_io.read_rgb(rgb_dir / f"{i:05d}.png").astype(np.float32) / 255.0
                for i in (0, 1)]
        _, launches, busy_ms, prof_ms, top = _kernel_table(
            lambda: raft.RAFTFlow(card_model, iters)(pair[0], pair[1]))
        if launches:
            busy = (f"{launches} launches, {busy_ms:.2f} ms of kernels in {prof_ms:.2f} ms: "
                    f"busy {100 * busy_ms / prof_ms:.2f} %; top kernels " + "; ".join(
                        f"{name[:70]} {t:.2f} ms x{c}" for name, t, c in top))
    log(f"{tag} (b) python -m pgdvs_tpu_torch.preprocess.compute_flow on a {n_frames}-frame "
        f"{raw_hw[0]}x{raw_hw[1]} PNG clip (written in {write_s:.2f} s), --intervals 1, "
        f"{iters} iterations, {pth.name} from $PGDVS_CKPT_DIR: {len(files)} npz files, finite, "
        f"coord_diff vs the CPU round trip {cd_err:.2e}; CLI {cli_s:.3f} s = "
        f"{cli_s / n_pairs:.4f} s per pair; RAFT per pair (forward + backward, padded "
        f"{ph}x{pw}) median {ms:.2f} ms (first {timed[0]:.2f}, min {min(timed):.2f}, max "
        f"{max(timed):.2f}), {flops / 1e12:.3f} TFLOP = {flops / ms / 1e9:.2f} TFLOP/s; one pair "
        f"profiled after the CLI: {busy}; of the CLI's wall time RAFT {raft_s:.3f} s on the card "
        f"({wall_s:.3f} s on the host clock around its calls), the frames' reads "
        f"{host['read_rgb']:.3f} s, the npz writes {host['savez']:.3f} s "
        f"({2 * raw_hw[0] * raw_hw[1] * 2 * 4 * len(files) / 1e6 / max(host['savez'], 1e-9):.1f} "
        f"MB/s); peak memory {peak_gb:.2f} GB; on {smi}")

    masks = root / "masks"
    t0 = time.perf_counter()
    epipolar_mask.main(["--rgb-dir", str(rgb_dir), "--flow-dir", str(flows),
                        "--save-dir", str(masks), "--pose-dir", str(pose_dir)])
    epi_s = time.perf_counter() - t0
    raw_dir = root / "raw_masks"
    raw_dir.mkdir()
    dyn = []
    for i in range(n_frames):
        m = read_image(masks / "final" / f"{i:05d}_final.png") > 0
        if m.shape != raw_hw:
            raise AssertionError(f"{tag} (c) mask {i} has shape {m.shape}")
        dyn.append(float(m.mean()))
        np.save(raw_dir / f"{i:05d}.npy", m)
    t0 = time.perf_counter()
    combine_masks.main(["--mask_dir", str(raw_dir), "--flow_dir", str(flows / "interval_1"),
                        "--out_dir", str(root / "combined")])
    comb_s = time.perf_counter() - t0
    final = [np.load(root / "combined" / f"{i:05d}_final.npy") for i in range(n_frames)]
    if any(f.shape != raw_hw or f.dtype != bool for f in final):
        raise AssertionError(f"{tag} (c) combined masks of the wrong shape or type")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"{tag} hand kernels launched: {_nonzero(launches)}")
    log(f"{tag} (c) epipolar_mask {epi_s / n_frames:.4f} s per frame (host), dynamic share "
        f"{100 * statistics.mean(dyn):.2f} %; combine_masks {comb_s / n_frames:.4f} s per frame "
        f"(host), dynamic share {100 * statistics.mean(float(f.mean()) for f in final):.2f} %; "
        f"hand kernel launches 0; on {smi}")
    return launches


DEPTH_CHECK_HW = (128, 192)   # (a): an 8x12 token grid against the 24x24 table
DEPTH_FRAMES = 8              # (b): frames of [preprocess]'s clip through the CLI
# (a) bound: every output within 1e-3 of its largest magnitude (float32 with
# TF32 off on both sides: other convolution and summation orders only)
DEPTH_REL_TOL = 1e-3
SEM_QUERIES = 250             # OneFormer DiNAT-L's queries
SEM_CLASSES = (150, 133)      # ADE20K, COCO panoptic (plus the null class)
# (c) the upsampled maps: float32 scores resized on each device; a pixel may
# differ only where the CPU's top two scores are within this of each other
SEM_UP_TIE = 1e-6


def zoe_flops(h, w, depth=24, dim=1024, grid=None):
    """FLOPs of one ``ZoeDepthDPT`` forward (the single head) at h x w:
    the patch embedding, per BEiT block the qkv / proj / MLP products over
    T = h/16 * w/16 + 1 tokens and the two attention products (~31 GFLOP a
    block at 384x704), the readouts and the reassemble convolutions, the
    fusion's 3x3 convolutions, the relative-depth head and the metric
    head's 1x1 convolutions. Elementwise work (norms, softmax, resizes, the
    attractors' pulls, the log-binomial) is left out."""
    gh, gw = h // 16, w // 16
    n = gh * gw
    t = n + 1
    beit = _conv_flops(3, dim, 16, gh, gw) + depth * (
        2 * t * dim * (3 * dim + dim + 8 * dim) + 4 * t * t * dim)
    rc, f = (256, 512, 1024, 1024), 256
    reassemble = sum(2 * n * 2 * dim * dim + 2 * n * dim * c for c in rc)
    reassemble += (2 * n * rc[0] * rc[0] * 16 + 2 * n * rc[1] * rc[1] * 4
                   + _conv_flops(rc[3], rc[3], 3, gh // 2, gw // 2))
    sizes = [(h // s, w // s) for s in (4, 8, 16, 32)]
    fusion = sum(_conv_flops(c, f, 3, *hw) for c, hw in zip(rc, sizes))
    for i, (rh, rw) in enumerate(sizes):     # refinenet1..4: 2 units, one for refinenet4
        units = 1 if i == 3 else 2
        fusion += units * 2 * _conv_flops(f, f, 3, rh, rw) + _conv_flops(f, f, 1, 2 * rh, 2 * rw)
    head = (_conv_flops(f, 128, 3, h // 2, w // 2) + _conv_flops(128, 32, 3, h, w)
            + _conv_flops(32, 1, 1, h, w))
    b = sizes[3]
    metric = (_conv_flops(f, f, 1, *b) + _conv_flops(f, 256, 1, *b) + _conv_flops(256, 64, 1, *b)
              + 2 * _conv_flops(f, 128, 1, *b) + _conv_flops(128, 128, 1, *b))
    for s, n_attr in zip((16, 8, 4, 2), (16, 8, 4, 1)):
        hw = (h // s, w // s)
        metric += (_conv_flops(f, 128, 1, *hw) + _conv_flops(128, 128, 1, *hw)
                   + _conv_flops(128, 128, 1, *hw) + _conv_flops(128, n_attr, 1, *hw))
    metric += _conv_flops(161, 80, 1, h, w) + _conv_flops(80, 4, 1, h, w)
    return beit + reassemble + fusion + head + metric


def write_zoe_checkpoint(model, path):
    """A ``ZoeDepthDPT``'s weights as a ``ZoeD_M12_*.pt`` in the published
    key layout: the backbone under ``core.core.`` with the buffers and
    unused modules released files carry (each block's
    ``relative_position_index``, timm's final norm, refinenet4's dead
    ``resConfUnit1``), the head's keys bare, in ``{"model": ...}``."""
    import torch

    from pgdvs_tpu_torch.models.depth.dpt_beit import gen_relative_position_index

    sd = {f"core.core.{k}": v for k, v in model.midas.state_dict().items()}
    sd.update(model.head.state_dict())
    grid = model.midas.pretrained.model.blocks[0].attn.pretrained_grid
    index = torch.from_numpy(gen_relative_position_index(*grid))
    pm = "core.core.pretrained.model."
    for i in range(len(model.midas.pretrained.model.blocks)):
        sd[f"{pm}blocks.{i}.attn.relative_position_index"] = index
    dim = model.midas.embed_dim
    sd[pm + "norm.weight"], sd[pm + "norm.bias"] = torch.ones(dim), torch.zeros(dim)
    for k, v in model.midas.scratch.refinenet3.resConfUnit1.state_dict().items():
        sd[f"core.core.scratch.refinenet4.resConfUnit1.{k}"] = torch.zeros_like(v)
    torch.save({"model": sd}, path)


def write_mvs_depths(rgb_dir, mvs_dir, hw, n_clip, seed=SEED, keep=0.05):
    """Seeded sparse MVS depth for each frame of ``rgb_dir`` (frame i of an
    ``n_clip``-frame ``write_flow_clip`` clip): the synthetic scene's
    z-depth from that frame's camera at a random ``keep`` share of the
    pixels, 0 elsewhere."""
    from pgdvs_tpu_torch.data import synthetic

    rng = np.random.default_rng(seed)
    mvs_dir.mkdir(parents=True)
    for f in sorted(rgb_dir.glob("*.png")):
        i = int(f.stem)
        fr = synthetic.render_frame(hw[0], hw[1], synthetic.camera_pose(i, n_clip),
                                    i / (n_clip - 1))
        depth = fr["depth"][..., 0].astype(np.float32)
        np.savez(mvs_dir / f"{f.stem}.npz",
                 depth=np.where(rng.random(hw) < keep, depth, 0.0).astype(np.float32))


class RecordingZoe:
    """Patches ``ZoeDepthDPT.forward`` and ``zoe_port.load_zoe_model``
    while active: each forward timed by CUDA events (the host clock on the
    CPU) with its input's shape, the checkpoint load timed on the host."""

    def __init__(self, device):
        self.device = device
        self.calls = []
        self.load_s = None

    def __enter__(self):
        from pgdvs_tpu_torch.models.depth import dpt_beit, zoe_port

        self.orig, self.orig_load = dpt_beit.ZoeDepthDPT.forward, zoe_port.load_zoe_model
        rec = self

        def forward(model, img):
            if rec.device == "cuda":
                out, ms = _event_ms(lambda: rec.orig(model, img))
            else:
                t0 = time.perf_counter()
                out = rec.orig(model, img)
                ms = (time.perf_counter() - t0) * 1e3
            rec.calls.append({"ms": ms, "shape": tuple(img.shape)})
            return out

        def load(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return rec.orig_load(*args, **kwargs)
            finally:
                rec.load_s = time.perf_counter() - t0

        dpt_beit.ZoeDepthDPT.forward, zoe_port.load_zoe_model = forward, load
        return self

    def __exit__(self, *exc):
        from pgdvs_tpu_torch.models.depth import dpt_beit, zoe_port

        dpt_beit.ZoeDepthDPT.forward, zoe_port.load_zoe_model = self.orig, self.orig_load


def _zoe_parts(model, img):
    """The backbone's outputs (relative depth, the head activation, the
    bottleneck, r4..r1), the metric depth and, for the NK head, the domain
    logits, of ``model`` on ``img`` [1, 3, H, W] in [0, 1]."""
    import torch

    from pgdvs_tpu_torch.models.depth.dpt_beit import IMAGENET_MEAN, IMAGENET_STD
    from pgdvs_tpu_torch.models.tracking.tapir import no_tf32

    mean = torch.tensor(IMAGENET_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=img.device)[:, None, None]
    with torch.no_grad(), no_tf32():
        rel, outconv, l4, pyr = model.midas((img - mean) / std)
        parts = {"rel": rel, "out_conv": outconv, "l4_rn": l4,
                 **{f"r{4 - i}": r for i, r in enumerate(pyr)}}
        head = model.head(outconv, l4, pyr, rel)
        if model.variant == "nk":
            parts["logits"] = head[1]
        parts["depth"] = model(img)
    return parts


def _semantic_case(seed, q, c, hw, device):
    """Seeded OneFormer-like class logits [Q, C + 1] and mask logits
    [Q, H, W] on ``device``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    cls = torch.randn(q, c + 1, generator=gen) * 2.0
    # mostly negative mask logits, as a query covers a small region: some
    # pixels fall under the 0.1 threshold
    msk = torch.randn(q, *hw, generator=gen) * 3.0 - 8.0
    return cls.to(device), msk.to(device)


def phase_depth(root, smi, clip_dir, device="cuda", n_frames=DEPTH_FRAMES,
                check_hw=DEPTH_CHECK_HW, depth=24, sem_hw=None, sem_queries=SEM_QUERIES):
    """[depth]: ZoeDepth and the semantic aggregation (ZoeDepth on seeded,
    damped random weights, ``init_zoe_weights``: the released checkpoint is
    not in the repository).

    (a) ``ZoeDepthDPT`` at the published widths (DPT-BEiT-L, ``depth``
    blocks) on the card against the port on the CPU with the same weights,
    single and NK heads, one synthetic frame at ``check_hw`` (an 8x12 token
    grid: the relative-position tables resized): the relative depth, the
    head activation, the bottleneck, r4..r1, the NK logits and the metric
    depth within DEPTH_REL_TOL of their largest magnitude; (b) the single
    model written as ``ZoeD_M12_N.pt`` in the published key layout
    (``write_zoe_checkpoint``), ``python -m
    pgdvs_tpu_torch.preprocess.compute_zoedepth --zoe-ckpt ... --device``
    run in-process (runpy) on the first ``n_frames`` frames of
    ``clip_dir`` ([preprocess]'s 576x1100 clip) with seeded sparse MVS
    depth (``write_mvs_depths``) into ``<root>/zoe/<scene>/dense``: the npz
    files (keys, shapes, finite, positive), the net size, seconds per frame
    (the CLI's wall clock), the network's device ms per forward, FLOPs
    (``zoe_flops``) and TFLOP/s, the checkpoint's write and load seconds,
    peak memory, then one more frame under ``torch.profiler`` (launches,
    busy share, top kernels) and the port's NVIDIA reader on the written
    files for every ZOE_PRINCIPLES key; (c) ``semantic_seg_from_queries``
    on the card against the CPU at OneFormer's output shapes (``sem_queries``
    queries, 150 / 133 classes plus the null class, masks at a quarter of
    the frame): the quarter-size maps equal but where the CPU's float64
    scores tie within 1e-9, the frame-size maps but where the CPU's float32
    top two lie within SEM_UP_TIE, the union equal; device ms of each; then
    the semantic_masks CLI, which must refuse (no OneFormer checkpoint in
    the local cache, or no ``transformers``) and write no mask. Returns the
    hand kernels' launches over (b): none."""
    import copy
    import runpy
    import shutil

    import torch

    from pgdvs_tpu_torch.data import synthetic
    from pgdvs_tpu_torch.data.image_io import read_rgb
    from pgdvs_tpu_torch.data.nvidia_eval import ZOE_PRINCIPLES, NvidiaEvalDataset
    from pgdvs_tpu_torch.models.depth.dpt_beit import ZoeDepthDPT, init_zoe_weights
    from pgdvs_tpu_torch.models.depth.zoe_infer import resize_output_size, zoe_infer
    from pgdvs_tpu_torch.preprocess import semantic_masks as sem

    tag = "[depth]"
    t0 = time.perf_counter()
    cpu = {}
    for variant in ("single", "nk"):
        with torch.device("meta"):
            cpu[variant] = ZoeDepthDPT(variant=variant, backbone_kwargs={"depth": depth})
    cpu["single"] = init_zoe_weights(cpu["single"].to_empty(device="cpu"), seed=SEED).eval()
    cpu["nk"].midas = cpu["single"].midas
    cpu["nk"].head = init_zoe_weights(cpu["nk"].head.to_empty(device="cpu"), seed=SEED + 1)
    cpu["nk"].eval()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in cpu["single"].parameters())
    h, w = check_hw
    frame = synthetic.render_frame(h, w, synthetic.camera_pose(3, 8), 0.4)["rgb"]
    img = torch.from_numpy(np.ascontiguousarray(frame, np.float32)).permute(2, 0, 1)[None]
    for variant, cpu_model in cpu.items():
        card = copy.deepcopy(cpu_model).to(device)
        got, ref = _zoe_parts(card, img.to(device)), _zoe_parts(cpu_model, img)
        del card
        errs = {}
        for key in ref:
            d = (got[key].float().cpu() - ref[key]).abs()
            scale = float(ref[key].abs().max())
            errs[key] = (float(d.max()), scale)
            if not (bool(torch.isfinite(got[key]).all()) and scale > 0
                    and errs[key][0] <= DEPTH_REL_TOL * scale):
                raise AssertionError(f"{tag} (a) {variant} {key}: max |card - cpu| "
                                     f"{errs[key][0]:.3e} of scale {scale:.3e}, bound "
                                     f"{DEPTH_REL_TOL} x scale")
        pick = ""
        if variant == "nk":
            pick = f", domain picked {int(torch.argmax(ref['logits'][0]))} on both"
            if int(torch.argmax(ref["logits"][0])) != int(torch.argmax(got["logits"][0])):
                raise AssertionError(f"{tag} (a) nk: the card and the CPU pick other domains")
        log(f"{tag} (a) ZoeDepthDPT {variant} ({n_params / 1e6:.1f} M parameters, {depth} BEiT "
            f"blocks, seeded weights in {init_s:.2f} s) card vs CPU at {h}x{w} "
            f"({h // 16}x{w // 16} tokens against the 24x24 table): " + ", ".join(
                f"{k} {e[0]:.2e} of {e[1]:.3g} ({e[0] / e[1]:.1e})" for k, e in errs.items())
            + f"; bound {DEPTH_REL_TOL} x scale{pick}")

    # (b) the CLI on the clip's first frames
    raw_hw = read_rgb(sorted(clip_dir.glob("*.png"))[0]).shape[:2]
    rgb_dir = root / "rgbs"
    rgb_dir.mkdir(parents=True)
    for f in sorted(clip_dir.glob("*.png"))[:n_frames]:
        shutil.copyfile(f, rgb_dir / f.name)
    write_mvs_depths(rgb_dir, root / "mvs", raw_hw, len(list(clip_dir.glob("*.png"))))
    pt = root / "ckpts" / "ZoeD_M12_N.pt"
    pt.parent.mkdir()
    t0 = time.perf_counter()
    write_zoe_checkpoint(cpu["single"], pt)
    write_s = time.perf_counter() - t0
    dense = root / "zoe" / READER_SCENE / "dense"
    old_argv = sys.argv
    sys.argv = ["compute_zoedepth", "--rgb-dir", str(rgb_dir), "--mvs-depth-dir",
                str(root / "mvs"), "--save-dir", str(dense), "--zoe-ckpt", str(pt),
                "--zoe-type", "n", "--device", device]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        with RecordingZoe(device) as rec:
            t0 = time.perf_counter()
            runpy.run_module("pgdvs_tpu_torch.preprocess.compute_zoedepth", run_name="__main__")
            cli_s = time.perf_counter() - t0
    finally:
        sys.argv = old_argv
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
    files = sorted((dense / "zoe_depths_n").glob("*.npz"))
    keys = {"depth_pred"} | set(ZOE_PRINCIPLES) | {k for pair in ZOE_PRINCIPLES.values()
                                                    for k in pair}
    if len(files) != n_frames or len(rec.calls) != n_frames:
        raise AssertionError(f"{tag} (b) {len(files)} npz files from {len(rec.calls)} forwards, "
                             f"expected {n_frames} of each")
    spread = []
    for f in files:
        z = np.load(f)
        d = z["depth_pred"]
        if set(z.files) != keys or d.shape != raw_hw or not np.isfinite(d).all() or d.min() <= 0:
            raise AssertionError(f"{tag} (b) {f.name}: keys {sorted(z.files)}, depth {d.shape}")
        if not all(np.isfinite(float(z[k])) for k in keys - {"depth_pred"}):
            raise AssertionError(f"{tag} (b) {f.name}: a non-finite alignment value")
        spread.append(float(d.std() / d.mean()))
    net = rec.calls[0]["shape"]
    pad = [n + 2 * int(np.sqrt(n / 2) * 3) for n in raw_hw]
    want = (2, 3, *resize_output_size(*pad, 384, 512))  # the reference's 384x512 target
    if any(c["shape"] != want for c in rec.calls):
        raise AssertionError(f"{tag} (b) forwards at {[c['shape'] for c in rec.calls]}")
    flops = zoe_flops(net[2], net[3], depth)
    timed = [c["ms"] for c in rec.calls]
    ms = statistics.median(timed)
    zoe_s = sum(timed) / 1e3
    busy = "no device activity seen by the profiler"
    if device == "cuda":
        card = copy.deepcopy(cpu["single"]).to(device)
        x = torch.from_numpy(read_rgb(sorted(rgb_dir.glob("*.png"))[0]).astype(np.float32)
                             / 255.0).to(device)
        with torch.no_grad():
            zoe_infer(card, x)
            _, launches, busy_ms, prof_ms, top = _kernel_table(lambda: zoe_infer(card, x))
        del card
        if launches:
            busy = (f"{launches} launches, {busy_ms:.2f} ms of kernels in {prof_ms:.2f} ms: "
                    f"busy {100 * busy_ms / prof_ms:.2f} %; top kernels " + "; ".join(
                        f"{name[:70]} {t:.2f} ms x{c}" for name, t, c in top))
    reader = NvidiaEvalDataset(root, use_zoe_depth="none", zoe_depth_data_path="zoe")
    read = []
    for zp in ZOE_PRINCIPLES:
        reader.use_zoe_depth = f"n_{zp}"
        for i in range(n_frames):
            d = reader._read_depth(READER_SCENE, i, *READER_EVAL_HW)
            if d.shape != READER_EVAL_HW or not np.isfinite(d).all():
                raise AssertionError(f"{tag} (b) the reader's n_{zp} depth of frame {i}")
            read.append(float(np.median(d)))
    log(f"{tag} (b) python -m pgdvs_tpu_torch.preprocess.compute_zoedepth --zoe-ckpt "
        f"{pt.name} ({pt.stat().st_size / 1e9:.2f} GB, written in {write_s:.2f} s, loaded in "
        f"{rec.load_s:.2f} s) --device {device} on {n_frames} {raw_hw[0]}x{raw_hw[1]} PNG frames "
        f"with seeded sparse MVS depth: {len(files)} npz files, keys as the JAX package writes "
        f"them, depth finite and positive (std / mean {min(spread):.2e}-{max(spread):.2e}); net "
        f"{net[2]}x{net[3]} ({net[2] // 16}x{net[3] // 16} tokens), the flip in one batch of "
        f"{net[0]}; CLI {cli_s:.3f} s = {cli_s / n_frames:.4f} s per frame (with the load); "
        f"ZoeDepthDPT per forward (2 images) median {ms:.2f} ms (first {timed[0]:.2f}, min "
        f"{min(timed):.2f}, max {max(timed):.2f}), {2 * flops / 1e12:.3f} TFLOP = "
        f"{2 * flops / ms / 1e9:.2f} TFLOP/s, {zoe_s:.3f} s of the CLI; one frame profiled "
        f"after the CLI: {busy}; peak memory {peak_gb:.2f} GB; the port's NVIDIA reader takes "
        f"the files for {', '.join(ZOE_PRINCIPLES)} (median depth {min(read):.3f}-"
        f"{max(read):.3f}); on {smi}")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"{tag} hand kernels launched: {_nonzero(launches)}")

    # (c) the semantic aggregation at OneFormer's output shapes
    if sem_hw is None:
        sem_hw = raw_hw
    quarter = (sem_hw[0] // 4, sem_hw[1] // 4)
    reset_launches()
    maps = {}
    for seed, c in enumerate(SEM_CLASSES):
        cls, msk = _semantic_case(SEED + seed, sem_queries, c, quarter, "cpu")
        s_cpu = sem.semantic_scores_from_queries(cls, msk)
        m_cpu = sem.semantic_map_from_scores(s_cpu)
        up_cpu = sem.semantic_seg_from_queries(cls, msk, sem_hw)
        cls_d, msk_d = cls.to(device), msk.to(device)
        sem.semantic_seg_from_queries(cls_d, msk_d, sem_hw)  # warm-up

        def quarter_map():
            s = sem.semantic_scores_from_queries(cls_d, msk_d)
            return s, sem.semantic_map_from_scores(s)

        (s_card, m_card), ms_q = _timed(quarter_map, device)
        up_card, ms_up = _timed(lambda: sem.semantic_seg_from_queries(cls_d, msk_d, sem_hw),
                                device)
        s64 = torch.einsum("qc,qhw->chw", torch.softmax(cls.double(), -1)[:, :-1],
                           torch.sigmoid(msk.double()))
        top2 = torch.topk(s64, 2, dim=0).values
        excused = ((top2[0] - top2[1]) <= 1e-9) | ((top2[0] - sem.SEM_SEG_PROB_THRES).abs() <= 1e-9)
        diff = (m_card.cpu() != m_cpu) & ~excused
        up_scores = torch.nn.functional.interpolate(s_cpu[None], size=tuple(sem_hw),
                                                    mode="bilinear", align_corners=False)[0]
        up_top2 = torch.topk(up_scores, 2, dim=0).values
        up_excused = (((up_top2[0] - up_top2[1]) <= SEM_UP_TIE)
                      | ((up_top2[0] - sem.SEM_SEG_PROB_THRES).abs() <= SEM_UP_TIE))
        up_diff = up_card.cpu() != up_cpu
        if bool(diff.any()) or bool((up_diff & ~up_excused).any()):
            raise AssertionError(f"{tag} (c) {c} classes: {int(diff.sum())} quarter-size and "
                                 f"{int((up_diff & ~up_excused).sum())} frame-size pixels differ")
        maps[c] = (m_card, up_card, up_cpu)
        log(f"{tag} (c) {c} + 1 classes, {sem_queries} queries at {quarter[0]}x{quarter[1]}: "
            f"scores card vs CPU max {float((s_card.cpu() - s_cpu).abs().max()):.2e}, the "
            f"quarter-size maps equal ({int(excused.sum())} float64 ties excused), the "
            f"{sem_hw[0]}x{sem_hw[1]} maps differ at {int(up_diff.sum())} pixels (each within "
            f"{SEM_UP_TIE} of a tie); low-confidence share "
            f"{float((up_cpu == -1).float().mean()):.4f}; device ms: scores + map {ms_q:.2f}, "
            f"with the resize {ms_up:.2f}; on {smi}")
    (_, up_ade, cpu_ade), (_, up_coco, cpu_coco) = maps[SEM_CLASSES[0]], maps[SEM_CLASSES[1]]
    union = sem.semantic_dynamic_union(up_ade, up_coco)
    ref_union = sem.semantic_dynamic_union(cpu_ade, cpu_coco)
    flips = union.cpu() != ref_union
    either = (up_ade.cpu() != cpu_ade) | (up_coco.cpu() != cpu_coco)
    if bool((flips & ~either).any()):
        raise AssertionError(f"{tag} (c) the union differs at {int((flips & ~either).sum())} "
                             "pixels where both maps agree")
    flips = int(flips.sum())
    log(f"{tag} (c) the movable-class union: share {float(union.float().mean()):.4f}, "
        f"card vs CPU {flips} pixels apart (only where a map's pixel was excused)")
    masks = root / "semantic"
    try:
        sem.main(["--image-dir", str(rgb_dir), "--out-dir", str(masks), "--device", device])
    except SystemExit as e:
        refusal = str(e)
    else:
        raise AssertionError(f"{tag} (c) semantic_masks ran without OneFormer weights")
    if masks.exists() and any(masks.iterdir()):
        raise AssertionError(f"{tag} (c) semantic_masks wrote masks before refusing")
    log(f"{tag} (c) python -m pgdvs_tpu_torch.preprocess.semantic_masks refuses here, no mask "
        f"written: {refusal[:160]}")
    launches_c = read_launches()
    if any(launches_c.values()):
        raise AssertionError(f"{tag} hand kernels launched: {_nonzero(launches_c)}")
    return launches


# ------------------------------------------------- fine-tuning and ranks

TRAIN_HW = (288, 550)
TRAIN_SOURCES = 10           # one held out per batch: 9 render it
TRAIN_SAMPLES = 256
TRAIN_RAYS = 512
TRAIN_STEPS = 5              # timed, after one warm-up, on one fixed batch
TRAIN_LR = 1e-4
# (b): one float32 step on the card against the CPU
TRAIN_CHECK = {"hw": (48, 64), "n_spatial": 3, "samples": 16, "rays": 64}
# The step's float32 gradient is ill-conditioned at these sizes: the
# ResUNet's InstanceNorm over a few-pixel bottleneck amplifies rounding, and
# a ReLU or a view mask that rounding flips moves a whole term. On the CPU
# at 32x40 (tests/test_torch_port_trainer.py) JAX's float32 step lies 2.2e-5
# (loss) and up to 1.2e-2 of a leaf's largest gradient from its float64
# step, the port's 1.1e-5 and 4.6e-3; more where cuDNN's FFT convolutions
# take part (one card-vs-CPU float32 reading: loss 2.9e-5, worst leaf
# 0.177, the whole gradient 9.3e-3 in L2 norm). So the card is held to the CPU
# strictly in float64 (both models and batches float64; the exact
# sampler's backward is a scatter-add, atomic on CUDA, which reorders sums
# at 1e-16), and in float32 on the loss and on the median leaf, the worst
# leaf reported (the gradient as a whole held in L2 norm). A leaf's error is
# taken against its largest entry, or
# against FLOOR x the largest gradient of any leaf where that is larger: the
# biases ahead of a softmax over views or an InstanceNorm have an exact
# gradient of 0 (shift invariance), so their entries are rounding noise.
TRAIN_LOSS_RTOL = 5e-5       # float32
# float32, the gradient of every leaf as one vector, relative L2 norm (the
# JAX package's float32 step and the port's on the CPU: 2.9e-3 to 1.5e-2)
TRAIN_GRAD_L2 = 3e-2
TRAIN_F64_LOSS_RTOL = 1e-9
TRAIN_F64_GRAD_TOL = 1e-6    # float64, every leaf
GRAD_FLOOR = 1e-6
# (c): run train over [reader]'s first items through torchrun, on NCCL
TRAIN_CLI_ITEMS = 3
TRAIN_CLI_RAYS = 128
TRAIN_CLI_SAMPLES = 64
# [parallel]: two ranks sharing the card over gloo
PARALLEL_RANKS = 2
# dp = 2 against one rank with both views, float64: the order of the sums
PARALLEL_CHECK = {"hw": (32, 40), "n_spatial": 3, "samples": 8, "rays": 64}
PARALLEL_LOSS_RTOL = 1e-9
PARALLEL_GRAD_TOL = 1e-6
PARALLEL_SUMMARY_RTOL = 1e-4  # softsplat's index_add_ is atomic on CUDA (F3)
RANK_TIMEOUT_S = 420


def _train_batch(data, n_rays, seed=SEED):
    """One view of ``sample_ray_batch_src`` (one source held out), as a
    batch of one."""
    from pgdvs_tpu_torch.engines.trainer import sample_ray_batch_src

    b = sample_ray_batch_src(np.random.default_rng(seed), data, n_rays)
    return {k: v[None] for k, v in b.items()}


def _grads(models) -> dict:
    return {f"{i}.{k}": p.grad.detach().double().cpu().numpy()
            for i, m in enumerate(models) for k, p in m.named_parameters()}


def one_step(mesh_kw, batch, cfg, n_rays, device, dtype):
    """(loss, {leaf: gradient}) of one ``make_train_step`` step with
    ``torch.optim.SGD(lr=1)`` from the seed's weights on ``device``, in
    float32 or float64 (models, batch and torch's default dtype)."""
    import torch

    from pgdvs_tpu_torch.parallel.mesh import make_mesh
    from pgdvs_tpu_torch.parallel.sharded import make_train_step
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    models = init_gnt_models(seed=SEED, device=device)
    if dtype == torch.float64:
        models = tuple(m.double() for m in models)
        batch = {k: v.astype(np.float64) for k, v in batch.items()}
    opt = torch.optim.SGD([p for m in models for p in m.parameters()], lr=1.0)
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        loss = make_train_step(make_mesh(device=device, **mesh_kw), models, cfg, opt, n_rays,
                               dtype=dtype)(batch)
    finally:
        torch.set_default_dtype(default)
    return loss, _grads(models)


def grad_l2(got: dict, want: dict) -> float:
    """The relative L2 error of the gradient, every leaf as one vector."""
    diff = sum(float(((got[k] - g) ** 2).sum()) for k, g in want.items())
    return (diff / sum(float((g ** 2).sum()) for g in want.values())) ** 0.5


def grad_errors(got: dict, want: dict, floor=GRAD_FLOOR):
    """{leaf: max |got - want| / max(leaf's largest |want|, floor x the
    largest of every leaf)}."""
    top = max(float(np.abs(g).max()) for g in want.values())
    return {k: float(np.abs(got[k] - g).max()) / max(float(np.abs(g).max()), floor * top)
            for k, g in want.items()}


def _device_kernels(prof, top=5):
    """(launches, summed ms, [(name, ms, launches)] of the ``top`` kernels)
    of a profiler's CUDA events."""
    import collections

    import torch

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    rows = sorted(((n, t, c) for n, (t, c) in by_name.items()), key=lambda r: -r[1])
    return sum(c for *_, c in rows), sum(t for _, t, _ in rows), rows[:top]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(n, rank_args, tag, env=None, timeout=RANK_TIMEOUT_S):
    """``python -m torch.distributed.run --nproc-per-node n chip_smoke.py
    --rank ...`` on this host, a free port; its output logged line by line
    under ``tag``; raises on a non-zero exit or a timeout (the launcher and
    its ranks killed). Returns (output, seconds)."""
    import os

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           str(pathlib.Path(__file__).resolve()), "--rank", *rank_args]
    root = str(pathlib.Path(__file__).resolve().parent)
    full_env = {**os.environ, **(env or {}), "SMOKE_LAUNCH_T": repr(time.time()),
                "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=full_env, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"{tag} torchrun ran past {timeout} s")
    secs = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith("[") or line.startswith("{"):
            log(f"{tag} | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{tag} torchrun exited {proc.returncode}:\n{out[-6000:]}")
    return out, secs


def phase_train(models, root, smi, device="cuda", hw=TRAIN_HW, n_spatial=TRAIN_SOURCES,
                n_samples=TRAIN_SAMPLES, n_rays=TRAIN_RAYS, steps=TRAIN_STEPS,
                check=TRAIN_CHECK, eval_h=READER_EVAL_HW[0], cli_samples=TRAIN_CLI_SAMPLES):
    """[train]: per-scene fine-tuning (``parallel.sharded.make_train_step``,
    the plain network under autograd: no hand kernel has a backward).

    (a) At full width: ``models`` copied (GNT width 64, depth 8, ResUNet),
    one batch of ``sample_ray_batch_src`` on the synthetic scene at ``hw``
    with ``n_spatial`` sources (one held out), ``n_rays`` rays of
    ``n_samples`` exact samples, ``torch.optim.Adam``; float32 with TF32
    off, then the GNT under bf16 autocast: a warm-up step, then ``steps``
    timed ones (CUDA events; ``utils.tracing`` spans around the sampler
    and each step, host and device ms) on the fixed batch, whose losses must fall; ms per step,
    rays/s, peak memory; K1 / K2 launch 0 times. One more step under
    ``utils.tracing.profile_trace``: its top kernels and the trace's size.
    (b) One SGD(lr=1) step at ``check``'s small size on the card and on the
    CPU from the same weights, in float32 (the loss and the median gradient
    leaf) and in float64 (the loss and every leaf). (c) ``run train
    --distributed`` under torchrun, one rank on NCCL, over [reader]'s first
    items for 2 epochs, then ``--resume`` for a third: the result lines,
    the checkpoints and the run config. Returns the launches of (a)."""
    import copy

    import torch

    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.parallel.mesh import make_mesh
    from pgdvs_tpu_torch.parallel.sharded import make_train_step
    from pgdvs_tpu_torch.renderers.config import RenderConfig
    from pgdvs_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    tracing.enable()
    h, w = hw
    data = make_contract_data(h=h, w=w, n_spatial=n_spatial, n_frames=12, tgt_time=0.5)
    with tracing.span("train.sampler"):
        batch = _train_batch(data, n_rays)
    cfg = RenderConfig(n_coarse_samples_per_ray=n_samples)
    launches = None
    for name, dtype in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        ms_ = copy.deepcopy(models)
        opt = torch.optim.Adam([p for m in ms_ for p in m.parameters()], lr=TRAIN_LR)
        step = make_train_step(make_mesh(device=device), ms_, cfg, opt, n_rays, dtype=dtype)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses = [step(batch)]  # warm-up
        times = []
        for _ in range(steps):
            with tracing.span(f"train.step_{name}", device=torch.device(device)):
                loss, ms = _timed(lambda: step(batch), device)
            losses.append(loss)
            times.append(ms)
        got = read_launches()
        launches = got if launches is None else {k: launches[k] + v for k, v in got.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"[train] (a) {name}: losses do not fall: {losses}")
        mean_ms = statistics.mean(times)
        log(f"[train] (a) {name}{' (TF32 off)' if name == 'float32' else ' autocast'}: "
            f"{h}x{w}, {n_spatial - 1} of {n_spatial} sources, {n_samples} exact samples, "
            f"{n_rays} rays: ms/step {mean_ms:.2f} (" + " ".join(f"{t:.2f}" for t in times)
            + f"), {n_rays / mean_ms * 1e3:.0f} rays/s, peak {peak:.2f} GB; losses "
            + " ".join(f"{x:.6f}" for x in losses) + f"; launches {_nonzero(got) or 0}; {smi}")
        if name == "bf16":
            with tracing.profile_trace(root / "train_trace") as prof:
                step(batch)
                if device == "cuda":
                    torch.cuda.synchronize()
            n_k, k_ms, top = _device_kernels(prof)
            size = (root / "train_trace" / "trace.json").stat().st_size
            log(f"[train] (a) profile_trace of one bf16 step: {n_k} kernel launches, "
                f"{k_ms:.2f} ms of kernels; trace {size / 1e6:.1f} MB; top: " + "; ".join(
                    f"{n[:60]} {t:.2f} ms x{c}" for n, t, c in top))
        del ms_, opt, step
    if any(launches.values()):
        raise AssertionError(f"[train] (a) hand kernels launched: {_nonzero(launches)}")
    if device == "cuda":
        torch.cuda.synchronize()
    spans = tracing.summary()["spans"]
    log("[train] (a) spans: " + json.dumps(
        {k: {f: v[f] for f in ("count", "host_ms", "device_ms")} for k, v in spans.items()
         if k.startswith("train.")}))
    tracing.disable()

    # (b) the card against the CPU, one SGD step in float32 and in float64
    ch, cw = check["hw"]
    small = make_contract_data(h=ch, w=cw, n_spatial=check["n_spatial"], n_frames=6)
    sb = _train_batch(small, check["rays"])
    cfg_b = RenderConfig(n_coarse_samples_per_ray=check["samples"])
    for prec, dtype, loss_tol in (("float32", torch.float32, TRAIN_LOSS_RTOL),
                                  ("float64", torch.float64, TRAIN_F64_LOSS_RTOL)):
        t_b = time.perf_counter()
        res = {dev: one_step({}, sb, cfg_b, check["rays"], dev, dtype) for dev in (device, "cpu")}
        errs = grad_errors(res[device][1], res["cpu"][1])
        worst = max(errs, key=errs.get)
        median = statistics.median(errs.values())
        l2 = grad_l2(res[device][1], res["cpu"][1])
        rel = abs(res[device][0] - res["cpu"][0]) / abs(res["cpu"][0])
        ok = rel <= loss_tol and (l2 <= TRAIN_GRAD_L2 if prec == "float32"
                                  else errs[worst] <= TRAIN_F64_GRAD_TOL)
        log(f"[train] (b) one {prec} SGD(lr=1) step at {ch}x{cw}, {check['n_spatial']} sources, "
            f"{check['samples']} samples, {check['rays']} rays, card vs CPU: loss "
            f"{res[device][0]:.10f} / {res['cpu'][0]:.10f} (rel {rel:.2e}, bound {loss_tol}); "
            f"the gradient's relative L2 error {l2:.2e}; {len(errs)} leaves: median "
            f"{median:.2e}, worst {worst} {errs[worst]:.2e} of its largest (bound: "
            + (f"L2 {TRAIN_GRAD_L2}" if prec == "float32"
               else f"every leaf {TRAIN_F64_GRAD_TOL}") + f", floor {GRAD_FLOOR}); "
            f"{time.perf_counter() - t_b:.1f} s")
        if not ok:
            raise AssertionError(f"[train] (b) {prec} card vs CPU out of bounds")

    # (c) run train under torchrun, one rank, NCCL
    if cli_samples:
        out = root / "train"
        argv = ["train", "--distributed", "--device", device, "--data-root", str(root / "scene"),
                "--scene-ids", READER_SCENE, "--dataset-arg", f"tgt_height={eval_h}", "--max-items",
                str(TRAIN_CLI_ITEMS), "--out-dir", str(out), "--n-rays", str(TRAIN_CLI_RAYS),
                "--render-cfg", f"n_coarse_samples_per_ray={cli_samples}"]
        # both runs in one rank process: a launch costs ~15 s before the rank starts
        text, secs = torchrun(1, ["cli", *argv, "--epochs", "2", "--then", *argv, "--epochs",
                                  "1", "--resume"], "[train] (c)")
        results = [json.loads(x) for x in text.splitlines() if x.startswith('{"epochs"')]
        if len(results) != 2:
            raise AssertionError(f"[train] (c) {len(results)} result lines")
        from pgdvs_tpu_torch.engines.checkpoint import list_checkpoints

        n = TRAIN_CLI_ITEMS
        ckpts = [(e, s) for e, s, _ in list_checkpoints(out)]
        want = [(e, n * e) for e in (1, 2, 3)]
        saved = json.loads((out / "config.json").read_text())["render_cfg"]
        if ([r["epochs"] for r in results] != [2, 3]
                or [r["steps"] for r in results] != [2 * n, 3 * n] or ckpts != want
                or saved["n_coarse_samples_per_ray"] != cli_samples
                or not all(np.isfinite(r["final_epoch_loss"]) for r in results)):
            raise AssertionError(f"[train] (c) results {results}, checkpoints {ckpts}")
        log(f"[train] (c) torchrun --nproc-per-node 1, one rank on NCCL: run train "
            f"--distributed (bf16) over {n} items x 2 epochs, then --resume x 1: "
            + "; ".join(json.dumps(r) for r in results)
            + f"; checkpoints {ckpts}, config.json keeps the render config; {secs:.1f} s")
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_parallel(root, smi, eval_items=EVAL_ITEMS, ranks=PARALLEL_RANKS, device="cuda",
                   hw=READER_EVAL_HW, n_samples=256):
    """[parallel]: ``ranks`` ranks sharing the one card over gloo
    (``--dist-backend gloo``; NCCL refuses two ranks on one card), one
    torchrun of ``chip_smoke.py --rank parallel`` (``rank_parallel``): the
    sharded render against one rank, the DP train step against one rank
    with both views, then ``run eval --distributed --devices 2`` over
    [eval]'s items with its checkpoint; its summary.json against [eval]
    (a)'s one-rank run (``hw`` / ``n_samples``: its render size and
    samples, the sharded render's too). Returns {path: the kernels'
    launches summed over the ranks}."""
    t0 = time.perf_counter()
    cfg = {"root": str(root), "eval_items": eval_items, "device": device, "hw": list(hw),
           "n_samples": n_samples}
    (root / "parallel.json").write_text(json.dumps(cfg))
    _, secs = torchrun(ranks, ["parallel", str(root / "parallel.json")], "[parallel]",
                       env={"PGDVS_CKPT_DIR": str(root / "ckpts")})
    recs = [json.loads((root / f"parallel_rank{r}.json").read_text()) for r in range(ranks)]
    want = json.loads((root / "eval" / "summary.json").read_text())
    got = json.loads((root / "parallel_eval" / "summary.json").read_text())
    rel = {k: abs(got["mean"][k] - v) / max(abs(v), 1e-12) for k, v in want["mean"].items()
           if k != "render_wall_s"}
    if got["count"] != want["count"] or sorted(got["mean"]) != sorted(want["mean"]) or max(
            rel.values()) > PARALLEL_SUMMARY_RTOL:
        raise AssertionError(f"[parallel] (c) summary {got} vs [eval] (a) {want}")
    paths = {}
    for key in ("sharded", "eval"):
        tag = "[parallel]" if key == "sharded" else "[parallel][eval]"
        paths[tag] = {k: sum(r[f"launches_{key}"][k] for r in recs) for k in recs[0][
            f"launches_{key}"]}
    log(f"[parallel] (c) run eval --distributed --devices {ranks} over {want['count']} items "
        f"(strided over the ranks): summary.json == [eval] (a)'s "
        f"(count {got['count']}, worst mean rel {max(rel.values()):.2e}, bound "
        f"{PARALLEL_SUMMARY_RTOL}); launches over the ranks {_nonzero(paths['[parallel][eval]'])}")
    log(f"[parallel] torchrun of {ranks} ranks {secs:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s (ranks: " + "; ".join(json.dumps(r["seconds"]) for r in recs) + f"); {smi}; no "
        "speed-up is claimed: both ranks share one card")
    return paths


def rank_parallel(cfg_path):
    """One rank of [parallel] (under torchrun): gloo on the card."""
    import torch

    from pgdvs_tpu_torch import run as cli
    from pgdvs_tpu_torch.data.loader import contract_to_device
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.parallel.mesh import init_distributed, make_mesh, world
    from pgdvs_tpu_torch.parallel.sharded import sharded_render_rays
    from pgdvs_tpu_torch.renderers.config import RenderConfig
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models, render_image_gnt

    cfg = json.loads(pathlib.Path(cfg_path).read_text())
    root = pathlib.Path(cfg["root"])
    import os

    launched = float(os.environ.get("SMOKE_LAUNCH_T", time.time()))
    device = init_distributed("gloo", cfg["device"])
    rank, size = world()
    if rank == 0:
        log(f"[rank] joined the group {time.time() - launched:.1f} s after the launch")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    rec, seconds = {"rank": rank}, {}
    models = init_gnt_models(seed=SEED, device=device)
    mesh = make_mesh(device=device)

    # (a) one 288x550 view's rays over the ranks, the fast preset (K1 patch_rows)
    t0 = time.perf_counter()
    h, w = cfg["hw"]
    d = contract_to_device(make_contract_data(h=h, w=w, n_spatial=10, n_frames=12,
                                              tgt_time=0.5), device)
    args = (d["flat_cam_tgt"], d["flat_cam_src_spatial"], d["static_rgb_src_spatial"], (h, w),
            d["depth_range"], slice_config(None, cfg["n_samples"]))
    ref = render_image_gnt(models, *args) if rank == 0 else None
    sync()
    reset_launches()
    t1 = time.perf_counter()
    out = sharded_render_rays(mesh, models, *args)
    sync()
    shard_s = time.perf_counter() - t1
    rec["launches_sharded"] = read_launches()
    if rank == 0:
        diff = (out["rgb"] - ref["rgb"]).abs()
        n_diff = int((diff.amax(-1) > 0).sum())
        worst = float(diff.max())
        if worst > KERNEL_TOL["rgb"] or not torch.isfinite(out["rgb"]).all():
            raise AssertionError(f"[parallel] (a) sharded render rgb {worst}")
        log(f"[parallel] (a) sharded_render_rays over {size} ranks (gloo, one card), {h}x{w} "
            f"fast preset: rgb vs the one-rank render max {worst:.3e} (bound "
            f"{KERNEL_TOL['rgb']}), {n_diff} of {h * w} rays differ at all; depth max "
            f"{float((out['depth'] - ref['depth']).abs().max()):.3e}; {shard_s:.3f} s; this "
            f"rank's launches {_nonzero(rec['launches_sharded'])}")
    del ref, out
    seconds["render"] = time.perf_counter() - t0

    # (b) the DP step in float64: dp = 2 against one rank with both views
    t0 = time.perf_counter()
    ch, cw = PARALLEL_CHECK["hw"]
    items = [make_contract_data(h=ch, w=cw, n_spatial=PARALLEL_CHECK["n_spatial"], n_frames=6,
                                tgt_time=t) for t in (0.5, 0.35)]
    views = [_train_batch(x, PARALLEL_CHECK["rays"], seed=SEED + i) for i, x in enumerate(items)]
    batch = {k: np.concatenate([v[k] for v in views]) for k in views[0]}
    cfg_b = RenderConfig(n_coarse_samples_per_ray=PARALLEL_CHECK["samples"])
    res = {name: one_step(kw, batch, cfg_b, PARALLEL_CHECK["rays"], device, torch.float64)
           for name, kw in (("one", {"n_devices": 1}), ("dp", {}))}
    errs = grad_errors(res["dp"][1], res["one"][1])
    worst = max(errs, key=errs.get)
    rel = abs(res["dp"][0] - res["one"][0]) / abs(res["one"][0])
    if rank == 0:
        log(f"[parallel] (b) one float64 step of 2 views at {ch}x{cw}, dp = {size} against one "
            f"rank with both: loss rel {rel:.2e} (bound {PARALLEL_LOSS_RTOL}), worst gradient "
            f"leaf {worst} {errs[worst]:.2e} of its largest (bound {PARALLEL_GRAD_TOL}, floor "
            f"{GRAD_FLOOR}), median {statistics.median(errs.values()):.2e}")
    if not (rel <= PARALLEL_LOSS_RTOL and errs[worst] <= PARALLEL_GRAD_TOL):
        raise AssertionError(f"[parallel] (b) rank {rank}: loss rel {rel}, {worst} {errs[worst]}")
    seconds["train_step"] = time.perf_counter() - t0

    # (c) run eval --distributed --devices 2 (the CLI finishes the process group)
    t0 = time.perf_counter()
    reset_launches()
    cli.main(["eval", "--distributed", "--devices", str(size), "--dist-backend", "gloo",
              "--device", device.type, "--data-root", str(root / "scene"), "--scene-ids",
              READER_SCENE, "--max-items", str(cfg["eval_items"]), "--dataset-arg",
              f"tgt_height={h}", "--render-cfg", f"n_coarse_samples_per_ray={cfg['n_samples']}",
              "--out-dir", str(root / "parallel_eval")])
    rec["launches_eval"] = read_launches()
    seconds["eval"] = time.perf_counter() - t0
    rec["seconds"] = {k: round(v, 2) for k, v in seconds.items()}
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    (root / f"parallel_rank{rank}.json").write_text(json.dumps(rec))
    return 0


def rank_cli(argv):
    """One rank of ``python -m pgdvs_tpu_torch.run`` under torchrun: each
    ``--then``-separated argument list in turn, in this process (each run
    joins the process group and leaves it)."""
    import os

    from pgdvs_tpu_torch import run as cli

    t0 = float(os.environ.get("SMOKE_LAUNCH_T", time.time()))
    runs = [[]]
    for a in argv:
        if a == "--then":
            runs.append([])
        else:
            runs[-1].append(a)
    for run in runs:
        log(f"[rank] {run[0]} started {time.time() - t0:.1f} s after the launch")
        cli.main(run)
    log(f"[rank] returned {time.time() - t0:.1f} s after the launch")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return 0


def _timed(fn, device):
    """(result, ms) of ``fn``: CUDA events on the card, the host clock on
    the CPU."""
    if device == "cuda":
        return _event_ms(fn)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        import pgdvs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    name, smi = phase_device()
    phase_build()
    models = init_gnt_models(seed=SEED, device="cuda")
    k1_worst, k1_times = phase_kernel_vs_plain(models[1])
    k2_worst, k2_times = phase_k2_vs_plain(models[1])
    k3_worst, k3_times = phase_k3_vs_plain(models[1])
    kp_worst, kp_times = phase_patch_vs_plain(models[1])
    km_worst, km_times = phase_k2_modes_vs_plain(models[1])
    kp_launches, _, patch = phase_main_path(models)
    phase_ray_kernel(k3_times["ray"])
    phase_view_kernel(models[1], k3_times["view"])
    pro = phase_prologue_kernel(models[1])
    phase_epipolar_kernel()
    k1_launches, _, quad1 = phase_main_path(models, preset="quad", tag="[quad]", n_timed=1)
    quad_img = {what: quad1[what] for what in ("combined_rgb", "static_coarse_rgb")}
    for what in quad_img:
        exact_vs_quad(patch[what], quad_img[what], tag="[main]", what=what, label="patch")
    del patch, quad1
    k2_launches, _, quad = phase_main_path(models, bundle="default", cols=(160, 224))
    ke_launches, _, exact = phase_main_path(models, bundle="default", cols=(160, 224),
                                            preset="exact", tag="[exact]")
    for what in ("combined_rgb", "static_coarse_rgb"):
        exact_vs_quad(exact[what], quad[what], what=what)
    del exact, quad
    # above the old cap of 368 samples per ray, at a reduced size
    phase_main_path(models, h=64, w=96, n_samples=384, rows=(16, 20), cols=(32, 64),
                    n_timed=1, tag="[s384]")
    phase_fine_tiles(models[1])
    phase_new_modes(models, quad_img)
    with tempfile.TemporaryDirectory(prefix="pgdvs_eval_") as tmp:
        root = pathlib.Path(tmp)
        phase_reader(models, root / "scene")
        phase_eval(models, root)
        # launches of fine-tuning (none: no hand kernel has a backward) and
        # over the ranks of [parallel]
        paths = {"[train]": phase_train(models, root, smi), **phase_parallel(root, smi)}
        phase_jpeg(smi)
        phase_geo(root / "geo", smi)
        phase_track_eval(models, root, smi)
        # launches per frame / item of the CoTracker CLI run and of the
        # visualization and DyCheck entry points
        paths.update({"[track-cotracker][cli]": phase_track_cotracker_cli(models, root, smi),
                      "[vis]": phase_vis(models, root, smi),
                      "[mono-vis]": phase_mono_vis(models, root, smi)})
        paths.update({f"[dycheck][{preset}]": want
                      for preset, want in phase_dycheck(models, root, smi).items()})
        paths["[preprocess]"] = phase_preprocess(root / "preprocess", smi, n_frames=PRE_FRAMES)
        paths["[depth]"] = phase_depth(root / "depth", smi, root / "preprocess" / "clip" / "rgbs")
    phase_point_mesh(models, smi)
    phase_track_lk(models, smi)
    phase_track_tapir(models, smi)
    paths["[track-cotracker]"] = phase_track_cotracker(models, smi)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    rows = []
    # K3a / K3b and K2's modes other than unfolded run on no render path:
    # their launches on the paths are 0, read from the [exact] run
    # the prologue alone is a direct call: its launches on the paths are 0,
    # read from the [exact] run (the whole forwards launch its kernel)
    for kname, replaces, worst, times, launches in (
            ("gnt_fused_mono4", "pgdvs_tpu/kernels/gnt_fused_mono4.py:736",
             k1_worst, k1_times, k1_launches),
            ("gnt_fused_mono4_patch",
             "pgdvs_tpu/kernels/gnt_fused_mono4.py:736 (patch_rows, :771-876)",
             kp_worst, kp_times, kp_launches),
            ("gnt_fused_mono3", "pgdvs_tpu/kernels/gnt_fused_mono3.py:444",
             k2_worst, k2_times, k2_launches),
            ("gnt_split_view", "pgdvs_tpu/kernels/gnt_fused.py:345",
             k3_worst["view"], k3_times["view"], ke_launches),
            ("gnt_split_ray", "pgdvs_tpu/kernels/gnt_fused.py:375",
             k3_worst["ray"], k3_times["ray"], ke_launches),
            *((f"gnt_fused_apply_mono3[{mode}]",
               f"pgdvs_tpu/kernels/gnt_fused_mono3.py:444 ({mode})",
               km_worst[mode], km_times[mode], ke_launches) for mode in MONO3_MODES),
            *((f"gnt_prologue[{src}]",
               "pgdvs_tpu/kernels/gnt_fused_mono4.py:736 and gnt_fused_mono3.py:444 "
               f"(rgbfeat_fc + max over views; {src})",
               pro[src][0], pro[src][1], ke_launches) for src in PROLOGUE_ROWS)):
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": "pgdvs_tpu_torch/csrc/gnt_fused.cu",
            "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(worst.values()),
            "ms": times["ms"],
            "plain_ms": times["plain_ms"],
            "bound_ms": times["bound_ms"],
            "bound_by": times["bound_by"],
            # launches per view / frame / item on the CoTracker bundle and
            # the vis and DyCheck entry points
            "launches_by_path": {tag: want[kname] for tag, want in paths.items()},
            # no single PyTorch call computes the GNT forward, a half-block
            # with its weights row, or the prologue (two dense layers, a
            # ReLU, a bf16 rounding and a max over views)
            "library_ms": None,
        })
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit({"parallel": rank_parallel, "cli": rank_cli}[sys.argv[2]](
            *([sys.argv[3]] if sys.argv[2] == "parallel" else [sys.argv[3:]])))
    sys.exit(main())
