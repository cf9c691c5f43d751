#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pgdvs_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device: the card's name and power limit, TF32 switched off;
  2. build: the CUDA kernels compiled from ``pgdvs_tpu_torch/csrc`` with nvcc;
  3. kernel vs plain: K1 (the fused GNT transformer) against its plain torch
     version on the card at small shapes and at one main-path ray tile, with
     both times at that tile;
  4. main path: ``render_novel_view`` on the 288x550, 10-source, 256-sample
     synthetic scene with random weights from a fixed seed; the kernel's
     launch count, finite output of the right shape, a crop of rays held
     against the plain path on the CPU, and seconds per view.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Needs a CUDA device: without one
it exits non-zero before doing anything. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# tolerances of the kernel against its plain version: bf16 operands with f32
# accumulation against the float32 plain network (the bounds the JAX package
# holds its own bf16 kernels to: tests/test_gnt_fused.py)
KERNEL_TOL = {"rgb": 0.02, "weights": 0.01, "inbound_cnt_raw": 0.01}
# the slice's end-to-end bounds (tests/test_gnt_model.py)
SLICE_TOL = {"rgb": 0.04, "depth": 0.1, "inbound_cnt": 0.02}
SEED = 0


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


def _rig(v, r, s, hw=(20, 28), seed=13, behind=False, device="cuda"):
    """Source cameras on a small arc and random points in front of them."""
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
    rf = rng.normal(size=(v, r, s, 35)).astype(np.float32)
    ray_d = torch.from_numpy(ray_d)
    ops = {
        "rgb_feat": torch.from_numpy(rf).to(torch.bfloat16),
        "pts": torch.from_numpy(pts),
        "view_code": sinusoidal_embed(ray_d / ray_d.norm(dim=-1, keepdim=True)),
        "centers": torch.cat([cam.flat_cam_c2w(cams[0])[None, :3, 3],
                              cam.flat_cam_c2w(cams)[:, :3, 3]]),
        "proj": cam.flat_cam_projection(cams),
    }
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
        errs = {}
        for key, tol in KERNEL_TOL.items():
            a, b = got[key], ref[key]
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{name}/{key}: shape {tuple(a.shape)} "
                                     f"vs {tuple(b.shape)} or non-finite")
            err = (a - b).abs()
            bound = tol + (0.02 * b.abs() if key == "rgb" else 0.0)
            errs[key] = float(err.max())
            worst[key] = max(worst[key], errs[key])
            if not bool((err <= bound).all()):
                raise AssertionError(f"{name}/{key}: max err {errs[key]} over tol {tol}")
        log(f"[kernel] {name} {kw}: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
        if name == "main_tile":
            times["ms"] = _time_ms(lambda: gnt_fused_mono4(packed, *args), 5)
            times["plain_ms"] = _time_ms(
                lambda: gnt_fused_mono4_plain(gnt, *args), 3)
            log(f"[kernel] main tile R=2048 S=256 V=10: kernel {times['ms']:.3f} ms, "
                f"plain {times['plain_ms']:.3f} ms")
    return worst, times


def slice_config(n_samples=256):
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset

    return apply_perf_preset(RenderConfig(n_coarse_samples_per_ray=n_samples))


def crop_on_cpu(models, data, cfg, rows, cols):
    """Static layer for a crop of target pixels, rendered by the plain path
    on the CPU from the same sampling maps the card built."""
    import copy

    import torch

    from pgdvs_tpu_torch.core import cameras
    from pgdvs_tpu_torch.models.gnt.projector import build_fused_maps
    from pgdvs_tpu_torch.renderers.static_gnt import render_rays_gnt

    fnet, gnt = models
    src = data["static_rgb_src_spatial"]
    h, w = src.shape[1:3]
    tgt = data["flat_cam_tgt"]
    with torch.no_grad():
        maps = build_fused_maps(src, fnet(src))
        rays_o, rays_d, _uv, _ = cameras.get_rays(
            h, w, cameras.flat_cam_intrinsics(tgt), cameras.flat_cam_c2w(tgt))
        idx = (torch.arange(*rows)[:, None] * w + torch.arange(*cols)[None]).reshape(-1)
        idx = idx.to(rays_o.device)
        out = render_rays_gnt(
            copy.deepcopy(gnt).cpu(), rays_o[idx].cpu(), rays_d[idx].cpu(),
            data["depth_range"].expand(idx.numel(), 2).cpu(), tgt.cpu(),
            data["flat_cam_src_spatial"].cpu(), maps.cpu(), cfg)
    shape = (rows[1] - rows[0], cols[1] - cols[0])
    return {k: out[k].reshape(shape + out[k].shape[1:]) for k in SLICE_TOL}


def phase_main_path(models, device="cuda", h=288, w=550, n_spatial=10,
                    n_frames=12, n_samples=256, rows=(140, 144), cols=(200, 264),
                    n_timed=2):
    """Drive render_novel_view once (counted), check it, then time it."""
    import numpy as np
    import torch

    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.kernels.gnt_fused import gnt_fused_mono4
    from pgdvs_tpu_torch.renderers.compose import render_novel_view

    cfg = slice_config(n_samples)
    data_np = make_contract_data(h=h, w=w, n_spatial=n_spatial,
                                 n_frames=n_frames, tgt_time=0.5)
    data = {k: torch.as_tensor(v).to(device) for k, v in data_np.items()
            if isinstance(v, np.ndarray)}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def render():
        gen = torch.Generator(device=device).manual_seed(SEED)
        out = render_novel_view(models, data, cfg, generator=gen)
        sync()
        return out

    gnt_fused_mono4.launches = 0
    t0 = time.perf_counter()
    out = render()
    first = time.perf_counter() - t0
    launches = gnt_fused_mono4.launches
    if device == "cuda" and launches <= 0:
        raise AssertionError("the main path launched K1 no time")
    rgb = out["combined_rgb"]
    if tuple(rgb.shape) != (h, w, 3) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"combined_rgb {tuple(rgb.shape)} not finite/[{h},{w},3]")
    log(f"[main] {h}x{w}, {n_spatial} sources, {n_samples} samples: first render "
        f"{first:.3f} s (warm-up), K1 launches {launches}")

    crop = crop_on_cpu(models, data, cfg, rows, cols)
    errs = {}
    for key, tol in SLICE_TOL.items():
        a = out[f"static_coarse_{key}"][rows[0]:rows[1], cols[0]:cols[1]].float().cpu()
        errs[key] = float((a - crop[key]).abs().max())
        if not errs[key] <= tol:
            raise AssertionError(f"crop {key}: max err {errs[key]} over {tol}")
    log(f"[main] crop rows {rows} cols {cols} vs plain path on CPU: "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))

    secs = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        render()
        secs.append(time.perf_counter() - t0)
    log(f"[main] s/view over {n_timed} timed runs: mean {statistics.mean(secs):.4f} "
        f"min {min(secs):.4f} max {max(secs):.4f} runs {secs}")
    return launches, secs


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

    name, _smi = phase_device()
    phase_build()
    models = init_gnt_models(seed=SEED, device="cuda")
    worst, times = phase_kernel_vs_plain(models[1])
    launches, _secs = phase_main_path(models)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(json.dumps({"kernels": [{
        "name": "gnt_fused_mono4",
        "route": "cuda",
        "source": "pgdvs_tpu_torch/csrc/gnt_fused.cu",
        "replaces": "pgdvs_tpu/kernels/gnt_fused_mono4.py:736",
        "launches": launches,
        "max_abs_err": max(worst.values()),
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
