#!/usr/bin/env python3
"""Write the JAX package's random GNT / ResUNet weights to an .npz file.

    JAX_PLATFORMS=cpu python3 scripts/export_jax_gnt_params.py OUT.npz [--seed 0] [--n-src 10]

The weights are ``init_gnt_params(PRNGKey(seed), *make_gnt_models(),
n_src)``, drawn as ``scripts/fast_preset_delta.py`` draws them, so a
program without JAX can render with the weights of that script's figures
(``scripts/port_exact_vs_quad.py`` does, for the PyTorch port). Keys are the
param tree's paths joined by "/", e.g. ``gnt/params/rgbfeat_fc_0/kernel``.
Runs on the CPU in a few seconds; the file holds a few MB.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def flatten(tree, prefix=""):
    """Nested dicts of arrays -> {"a/b/c": numpy array}."""
    import numpy as np

    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if hasattr(val, "items"):
            out.update(flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val, np.float32)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the .npz file to write")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-src", type=int, default=10)
    args = ap.parse_args()

    import jax
    import numpy as np

    from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models

    models = make_gnt_models()
    params = jax.jit(lambda k: init_gnt_params(k, *models, n_src=args.n_src))(
        jax.random.PRNGKey(args.seed))
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flat)
    print(f"{out}: {len(flat)} arrays, {sum(a.size for a in flat.values())} values")
    return 0


if __name__ == "__main__":
    sys.exit(main())
