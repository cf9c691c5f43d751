#!/usr/bin/env python3
"""Exact against quad sampler at full size, with the JAX package's weights.

    JAX_PLATFORMS=cpu python3 scripts/export_jax_gnt_params.py _jax_params/seed0.npz
    python3 scripts/port_exact_vs_quad.py _jax_params/seed0.npz

Loads the weights written by ``scripts/export_jax_gnt_params.py`` (the
random weights of ``scripts/fast_preset_delta.py``) into the port's modules
and renders the 288x550, 10-source, 256-sample synthetic scene of
``chip_smoke.py`` on the exact preset (K3) and on the fast one (quad, K2),
for two configurations: the masked configuration of
``fast_preset_delta.py`` (``RenderConfig(gnt_use_dyn_mask=True)``: static-only
spatial sources, no outlier removal), whose JAX delta docs/BENCHMARK.md:60-66
records, and the ``default`` bundle of ``chip_smoke.py`` phase 6. Prints,
for ``combined_rgb`` and the static layer, PSNR / SSIM of exact against quad
both as ``chip_smoke.py`` reads them (uint8-quantized, full mask) and as
``fast_preset_delta.py`` does (float32 PSNR, SSIM at data range 1 over 3
channels). Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_tree(path):
    """The .npz of export_jax_gnt_params.py -> nested dicts of arrays."""
    import numpy as np

    tree = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def f32_delta(a, b):
    """fast_preset_delta.py's reading: float32 PSNR and SSIM / 3."""
    import numpy as np

    from pgdvs_tpu_torch.metrics.psnr_ssim import masked_ssim

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    ssim = masked_ssim(a, b, np.ones(a.shape[:2] + (1,), np.float32), data_range=1.0) / 3.0
    return psnr, ssim


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("params", help="the .npz of scripts/export_jax_gnt_params.py")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_exact_vs_quad: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    tree = load_tree(args.params)
    fnet, gnt = init_gnt_models(device="cpu")
    fnet.load_state_dict(resunet_state_dict(tree["feature_net"]))
    gnt.load_state_dict(gnt_state_dict(tree["gnt"]))
    models = (fnet.cuda(), gnt.cuda())
    data_np = make_contract_data(h=288, w=550, n_spatial=10, n_frames=12, tgt_time=0.5)
    data = {k: torch.as_tensor(v).cuda() for k, v in data_np.items()
            if isinstance(v, np.ndarray)}
    masked = RenderConfig(gnt_use_dyn_mask=True)
    configs = {
        "masked": {"fast": apply_perf_preset(masked), "exact": masked},
        "default": {p: chip_smoke.slice_config("default", preset=p)
                    for p in ("fast", "exact")},
    }
    for name, cfgs in configs.items():
        outs = {}
        for preset, cfg in cfgs.items():
            gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
            outs[preset] = render_novel_view(models, data, cfg, generator=gen)
        for key in ("combined_rgb", "static_coarse_rgb"):
            tag = f"[{name}, JAX weights]"
            chip_smoke.exact_vs_quad(outs["exact"][key], outs["fast"][key], tag=tag, what=key)
            psnr, ssim = f32_delta(outs["exact"][key].float().cpu().numpy(),
                                   outs["fast"][key].float().cpu().numpy())
            print(f"{tag} exact vs quad ({key}), float32 reading: "
                  f"PSNR {psnr:.3f} dB, SSIM {ssim:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
