#!/usr/bin/env python3
"""Device time by kernel for one render of the PyTorch/CUDA port on one GPU.

    python3 scripts/profile_port_render.py                  # fast preset: patch (K1 patch_rows)
    python3 scripts/profile_port_render.py --preset quad    # unmasked quad (K1)
    python3 scripts/profile_port_render.py --preset exact   # unmasked exact (K2 unfolded)
    python3 scripts/profile_port_render.py --bundle default # masked bundle (K2)
    python3 scripts/profile_port_render.py --bundle default --preset exact  # (K2 unfolded)
    python3 scripts/profile_port_render.py --fine 64        # + 64 fine samples (two passes)
    python3 scripts/profile_port_render.py --bundle default --tracker lk   # the track branch
    python3 scripts/profile_port_render.py \
        --bundle st_gnt_masked_attn_dy_cvd_pcl_clean_track_tapir --tracker tapir
    python3 scripts/profile_port_render.py \
        --bundle st_gnt_masked_attn_dy_cvd_pcl_clean_track_cotracker --tracker cotracker

Renders the 288x550, 10-source, 256-sample synthetic scene of
``chip_smoke.py`` once as a warm-up, times a second render with the host
clock (ending in a synchronise), then profiles a third with
``torch.profiler`` (CPU + CUDA activities). Prints the card's name and power
limit, the unprofiled seconds per view, the kernels with the most self
device time, the sum of all kernel time, and the device busy time (the
union of kernel intervals) against the profiled render's own wall clock,
whose complement is the idle share of a view. With ``--tracker`` the scene
carries ±5 track frames and the render runs the track branch
(``dyn_render_track_temporal="no_tgt"``) with that tracker
(``configs.benchmarks.make_tracker``; TAPIR on seeded random weights
without a checkpoint; CoTracker without one on ``init_cotracker_weights``'
seeded, damped weights, saved as a ``.pth`` in a temporary ``PGDVS_CKPT_DIR``
and loaded by make_tracker, which tracks in chunks of 4096). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_us(events):
    """Length of the union of the kernels' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bundle", default=None, help="named bundle (default: the "
                    "unmasked config)")
    ap.add_argument("--preset", default="fast", choices=("fast", "quad", "exact"),
                    help="fast (the JAX package's preset: patch sampler, or quad with "
                    "the dyn mask), quad (the fast preset on the quad sampler) or "
                    "exact (the reference-faithful sampler)")
    ap.add_argument("--fine", type=int, default=0,
                    help="fine samples per ray (a second pass on the merged samples)")
    ap.add_argument("--tracker", default=None,
                    choices=("lk", "tapir", "tapir_raw_res", "cotracker"),
                    help="run the track branch with this tracker (±5 track frames)")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port_render: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pgdvs_tpu_torch.configs.benchmarks import make_tracker
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.models.tracking.cotracker import CoTrackerModel, init_cotracker_weights
    from pgdvs_tpu_torch.models.tracking.cotracker_port import load_cotracker_checkpoint
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    models = init_gnt_models(seed=chip_smoke.SEED)
    cfg = chip_smoke.slice_config(args.bundle, preset=args.preset,
                                  n_fine_samples_per_ray=args.fine)
    if args.tracker == "cotracker" and load_cotracker_checkpoint() is None:
        # seeded, damped weights saved where make_tracker's loader reads them
        print("[profile] no CoTracker checkpoint: seeded, damped random weights")
        ckpts = tempfile.mkdtemp(prefix="pgdvs_ckpt_")
        os.makedirs(os.path.join(ckpts, "cotracker"))
        torch.save(init_cotracker_weights(CoTrackerModel(), chip_smoke.SEED).state_dict(),
                   os.path.join(ckpts, "cotracker", "cotracker_stride_4_wind_8.pth"))
        old = os.environ.get("PGDVS_CKPT_DIR")
        os.environ["PGDVS_CKPT_DIR"] = ckpts
        try:
            tracker = make_tracker(args.tracker, device="cuda")
        finally:
            if old is None:
                os.environ.pop("PGDVS_CKPT_DIR")
            else:
                os.environ["PGDVS_CKPT_DIR"] = old
            shutil.rmtree(ckpts)
    else:
        tracker = make_tracker(args.tracker, device="cuda")
    if tracker is not None:
        cfg = cfg.replace(dyn_render_track_temporal="no_tgt")
    data_np = make_contract_data(h=288, w=550, n_spatial=10, n_frames=12, tgt_time=0.5,
                                 k_track=chip_smoke.TRACK_K if tracker is not None else 0)
    data = {k: torch.as_tensor(v).cuda() for k, v in data_np.items()
            if isinstance(v, np.ndarray)}

    def render():
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        render_novel_view(models, data, cfg, generator=gen, tracker=tracker)
        torch.cuda.synchronize()

    render()
    t0 = time.perf_counter()
    render()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        prof_wall = time.perf_counter() - t0
    # device-side events only (the kernels and copies themselves), so no
    # time is counted twice under the host ops that launched it
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy = busy_us(kernels) / 1e6
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    total = sum(us for us, _n in by_name.values()) / 1e6
    label = (f"{args.bundle or 'unmasked'}, {args.preset} preset ({cfg.epipolar_mode} sampler, "
             f"{cfg.n_coarse_samples_per_ray} + {args.fine} fine samples"
             + (f", tracker {args.tracker}" if tracker is not None else "") + ")")
    print(f"[profile] {label}: unprofiled render {wall:.4f} s; profiled render "
          f"{prof_wall:.4f} s; kernel time {total:.4f} s; device busy {busy:.4f} s "
          f"= {busy / prof_wall:.2%} of the profiled render's wall clock (idle "
          f"share {1 - busy / prof_wall:.2%})")
    print(f"[profile] {len(kernels)} device events (kernels and copies)")
    for name, (us, n) in rows[:args.top]:
        print(f"[profile] {us / 1e3:10.1f} ms {us / 1e6 / total:6.1%} x{n:<6d} {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
