"""One rank of the port's multi-process checks (``tests/test_torch_port_parallel.py``).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_dist_worker.py IN_DIR OUT_DIR

Joins a gloo process group on the CPU, then runs, in this order, on every
rank: the mesh layouts; ``sharded_render_rays`` on patch and exact; the
mesh evaluator over five items; ``make_sharded_eval_fn`` over two items,
one per rank; the evaluator's cross-process sum over three items, with
``max_items`` and over one item; the train step of
``IN_DIR/train.npz`` on a dp = 2, an rp = 2 and a one-rank mesh. Rank r
writes ``OUT_DIR/rank{r}.json`` and ``OUT_DIR/rank{r}.npz``. Imports
nothing of JAX (checked at the end), unlike the test that launches it.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pgdvs_tpu_torch.data.loader import contract_to_device  # noqa: E402
from pgdvs_tpu_torch.data.synthetic import make_contract_data  # noqa: E402
from pgdvs_tpu_torch.engines.evaluator import Evaluator  # noqa: E402
from pgdvs_tpu_torch.parallel.mesh import all_gather, all_reduce_sum, init_distributed  # noqa: E402
from pgdvs_tpu_torch.parallel.mesh import make_mesh, world  # noqa: E402
from pgdvs_tpu_torch.parallel.sharded import make_sharded_eval_fn  # noqa: E402
from pgdvs_tpu_torch.parallel.sharded import make_train_step, sharded_render_rays  # noqa: E402
from pgdvs_tpu_torch.renderers.config import RenderConfig, apply_perf_preset  # noqa: E402
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models  # noqa: E402

# the shapes the test holds the ranks' results against
RENDER_CASES = {"patch": (24, 32), "exact": (26, 30)}
EVAL_HW = (32, 40)
S = 8


def render_cfg(mode: str) -> RenderConfig:
    cfg = RenderConfig(n_coarse_samples_per_ray=S, ray_tile=256)
    return apply_perf_preset(cfg) if mode == "patch" else cfg


def render_data(mode: str) -> dict:
    h, w = RENDER_CASES[mode]
    return make_contract_data(h=h, w=w, n_spatial=3, n_frames=6)


def eval_items(n: int):
    return [make_contract_data(h=EVAL_HW[0], w=EVAL_HW[1], n_spatial=3, n_frames=6,
                               tgt_time=0.3 + 0.1 * i) for i in range(n)]


def eval_cfg() -> RenderConfig:
    return RenderConfig(n_coarse_samples_per_ray=S, ray_tile=320)


def load_models(blob: dict, prefix: str):
    """(feature_net, gnt) with the state dicts stored in ``blob`` under
    ``{prefix}feature_net.`` / ``{prefix}gnt.``."""
    fnet, gnt = init_gnt_models(seed=0, device="cpu")
    for name, m in (("feature_net", fnet), ("gnt", gnt)):
        head = f"{prefix}{name}."
        m.load_state_dict({k[len(head):]: torch.from_numpy(v) for k, v in blob.items()
                           if k.startswith(head)})
    return fnet, gnt


def main(in_dir: pathlib.Path, out_dir: pathlib.Path) -> None:
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    rank, size = world()
    res, arrays = {"world": [rank, size]}, {}

    # mesh layouts and the collectives
    for name, kw in (("dp2", {}), ("rp2", {"rp": 2}), ("one", {"n_devices": 1})):
        m = make_mesh(**kw)
        res[f"mesh_{name}"] = {"dp": m.dp, "rp": m.rp, "rank": m.rank, "coord": list(m.coord),
                               "ranks": list(m.ranks), "index": m.index, "count": m.count,
                               "groups": [m.group is not None, m.dp_group is not None,
                                          m.rp_group is not None]}
    mesh = make_mesh()
    t = torch.full((2,), float(rank + 1))
    res["gathered"] = torch.cat(all_gather(t, mesh.group)).tolist()
    res["summed"] = all_reduce_sum(t).tolist()

    # one view's rays over both ranks
    models = init_gnt_models(seed=0, device="cpu")
    for mode, (h, w) in RENDER_CASES.items():
        d = {k: torch.from_numpy(v) for k, v in render_data(mode).items()
             if isinstance(v, np.ndarray)}
        out = sharded_render_rays(mesh, models, d["flat_cam_tgt"], d["flat_cam_src_spatial"],
                                  d["static_rgb_src_spatial"], (h, w), d["depth_range"],
                                  render_cfg(mode))
        for k in ("rgb", "depth", "weights", "inbound_cnt"):
            arrays[f"render_{mode}_{k}"] = out[k].numpy()

    # the mesh evaluator: five items strided over the two ranks
    out = out_dir / "mesh_eval"
    res["mesh_eval"] = Evaluator(models, eval_cfg(), device="cpu", mesh=mesh,
                                 out_dir=str(out)).run(eval_items(5))
    # a batch of two whole views, item r on rank r with the noise of seed r
    fn = make_sharded_eval_fn(mesh, models, eval_cfg())
    batch = fn(contract_to_device(eval_items(2)[rank], "cpu"), seed=rank,
               keys=("combined_rgb",))
    arrays["sharded_eval_combined_rgb"] = batch["combined_rgb"].numpy()
    # the cross-process sum without a mesh
    three = eval_items(3)
    res["sum_full"] = Evaluator(models, eval_cfg(), device="cpu").run(
        three, process_index=rank, process_count=size)
    res["sum_max_items"] = Evaluator(models, eval_cfg(), device="cpu").run(
        three, process_index=rank, process_count=size, max_items=1)
    res["sum_empty_shard"] = Evaluator(models, eval_cfg(), device="cpu").run(
        three[:1], process_index=rank, process_count=size)

    # the train step of train.npz on three meshes, each from the same weights
    blob = dict(np.load(in_dir / "train.npz"))
    batch = {k[len("batch."):]: v for k, v in blob.items() if k.startswith("batch.")}
    for name, kw in (("dp2", {}), ("rp2", {"rp": 2}), ("one", {"n_devices": 1})):
        fnet, gnt = load_models(blob, "sd.")
        m = make_mesh(**kw)
        cfg = RenderConfig(n_coarse_samples_per_ray=S, ray_tile=320)
        opt = torch.optim.SGD([p for mod in (fnet, gnt) for p in mod.parameters()], lr=1.0)
        step = make_train_step(m, (fnet, gnt), cfg, opt, n_rays_per_view=64)
        res[f"loss_{name}"] = step(batch)
        for prefix, mod in (("feature_net", fnet), ("gnt", gnt)):
            for k, p in mod.named_parameters():
                arrays[f"grad_{name}.{prefix}.{k}"] = p.grad.numpy()

    if "jax" in sys.modules:
        raise RuntimeError("the rank imported jax")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    np.savez(out_dir / f"rank{rank}.npz", **arrays)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2]))
