#!/usr/bin/env python3
"""Seconds per view of the port's renders in the tree this is run from, to
compare two trees on one card.

    python3 scripts/port_render_ab.py --label change
    (cd _chip_copy/parent && python3 ../../scripts/port_render_ab.py --label parent)

Imports ``pgdvs_tpu_torch`` and ``chip_smoke`` from the current directory
(so a parent commit unpacked there is timed by the same code), builds that
tree's kernels, and renders the 288x550, 10-source, 256-sample synthetic
scene of ``chip_smoke.py`` (random weights from its seed) on the four
configurations of its main phases: ``main`` (the fast preset: patch),
``quad`` (unmasked quad), ``default`` (the masked bundle on quad) and
``exact`` (``default`` on the exact sampler); per path one warm-up render,
then ``--runs`` renders timed with the host clock, each ending in a
synchronise. Prints one JSON line: the label, the card's name and power
limit, and the seconds of each timed render per path. Run the trees in turns
(parent, change, change, parent) within one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (path, bundle, preset) as chip_smoke.slice_config takes them
PATHS = (("main", None, "fast"), ("quad", None, "quad"), ("default", "default", "fast"),
         ("exact", "default", "exact"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_render_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pgdvs_tpu_torch.data.synthetic import make_contract_data
    from pgdvs_tpu_torch.renderers.compose import render_novel_view
    from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    models = init_gnt_models(seed=cs.SEED, device="cuda")
    data_np = make_contract_data(h=288, w=550, n_spatial=10, n_frames=12, tgt_time=0.5)
    data = {k: torch.as_tensor(v).cuda() for k, v in data_np.items()
            if isinstance(v, np.ndarray)}
    secs = {}
    for path, bundle, preset in PATHS:
        cfg = cs.slice_config(bundle, 256, preset)

        def render():
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
            render_novel_view(models, data, cfg, generator=gen)
            torch.cuda.synchronize()

        render()
        secs[path] = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            render()
            secs[path].append(time.perf_counter() - t0)
    print(json.dumps({"label": args.label, "card": smi, "s_per_view": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
