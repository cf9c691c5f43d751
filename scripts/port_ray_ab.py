#!/usr/bin/env python3
"""Time the port's view, ray and prologue kernels in the tree this is run
from, to compare two trees on one card.

    python3 scripts/port_ray_ab.py --label change
    (cd _chip_copy/parent && python3 ../../scripts/port_ray_ab.py --label parent)

Imports ``pgdvs_tpu_torch`` and ``chip_smoke`` from the current directory
(so a parent commit unpacked there is timed by the same code), builds that
tree's kernels, and prints one JSON line: the label, the card's name and
power limit, K3a (``gnt_split_view``: one view block alone, ``k_view``, V=10)
and K3b (``gnt_split_ray``: one ray block alone, ``k_ray``) in ms per launch
at the main tile (R=2048, S=256, 20 launches each), K1
(``gnt_fused_mono4``: a whole forward, the prologue and 8 view and 8 ray
blocks) and K1 ``patch_rows`` (``gnt_fused_mono4_patch`` on 4x2 blocks, 24
stencil positions: its prologue combines the patch rows) in ms per 2048-ray
tile (V=10, 5 launches each), with CUDA events after
a warm-up, random weights and inputs from fixed seeds. Run the trees in
turns (parent, change, change, parent) within one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import torch

    if not torch.cuda.is_available():
        print("port_ray_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pgdvs_tpu_torch.kernels.gnt_fused import gnt_fused_mono4, pack_mono4_weights
    from pgdvs_tpu_torch.core.cameras import ray_diff_features
    from pgdvs_tpu_torch.kernels.gnt_fused_patch import gnt_fused_mono4_patch
    from pgdvs_tpu_torch.kernels.gnt_fused_split import (
        gnt_split_ray, gnt_split_view, pack_split_weights,
    )
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gnt = init_gnt_models(seed=cs.SEED, device="cuda")[1]
    split = pack_split_weights(gnt, "cuda")
    ops, hw = cs._rig(**cs.MAIN_TILE)
    v, r, s, _ = ops["rgb_feat"].shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((r, s, 64), generator=gen, device="cuda")
    h = torch.randn((v, r, s, 64), generator=gen, device="cuda").to(torch.bfloat16)
    rd = ray_diff_features(ops["pts"][None], ops["centers"][0], ops["centers"][1:, None, None, :])
    mask = cs._k2_mask(ops, hw, 0.2)
    view_ms = cs._time_ms(lambda: gnt_split_view(q, h, rd, mask, split.view[2]), 20)
    ray_ms = cs._time_ms(lambda: gnt_split_ray(q, split.ray[2]), 20)
    packed = pack_mono4_weights(gnt, "cuda")
    k1_args = (ops["rgb_feat"], ops["pts"], ops["view_code"], ops["centers"], ops["proj"], hw)
    k1_ms = cs._time_ms(lambda: gnt_fused_mono4(packed, *k1_args), 5)
    patch_args = cs._patch_ops(cs.MAIN_TILE, 8, 24)
    k1p_ms = cs._time_ms(lambda: gnt_fused_mono4_patch(packed, *patch_args), 5)
    print(json.dumps({"label": args.label, "device": smi, "tree": os.getcwd(),
                      "k3a_ms_per_launch": view_ms, "k3b_ms_per_launch": ray_ms,
                      "k1_ms_per_tile": k1_ms, "k1_patch_rows_ms_per_tile": k1p_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
