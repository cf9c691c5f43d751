"""Process meshes over ``torch.distributed`` ranks, and their collectives.

The port's counterpart of ``pgdvs_tpu.parallel.mesh``. The JAX package
lays a ``(dp, rp)`` device mesh over the chips of one program; the port
runs one process per GPU (``torchrun``) and lays the same mesh over the
ranks of the process group:

  * axis ``dp``: data parallel over novel views (the reference's NCCL DP);
  * axis ``rp``: ray parallel within a view.

Ranks are placed row-major, ``reshape(dp, rp)``, as the JAX package places
its devices. A world larger than the mesh is cut into consecutive meshes of
``n`` ranks each (``Mesh.index`` of ``Mesh.count``); the evaluator strides
items over them as over processes. With no process group initialised the
mesh is this one process, with no collectives.

Every collective of ``parallel/`` and the evaluator goes through this
module: NCCL takes CUDA tensors; gloo (two ranks sharing one card, or the
CPU) is given CPU tensors, so CUDA tensors are staged through the host for
it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist


def mesh_shape(n: int, dp: Optional[int] = None, rp: int = 1) -> Tuple[int, int]:
    """(dp, rp) of a mesh of ``n`` ranks; ValueError where the JAX package's
    ``make_mesh`` raises for the same (n, dp, rp)."""
    if dp is None:
        if n % rp != 0:
            raise ValueError(f"{n} devices not divisible by rp={rp}")
        dp = n // rp
    if dp * rp != n:
        raise ValueError(f"dp({dp}) * rp({rp}) != n_devices({n})")
    return dp, rp


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def init_distributed(backend: Optional[str] = None, device="cuda") -> torch.device:
    """Join the process group that ``torchrun`` (``python -m
    torch.distributed.run``) describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    On ``device="cuda"`` the rank takes card ``LOCAL_RANK`` modulo the cards
    present (so ranks may share one card) and makes it the current device;
    ``backend`` defaults to nccl there and to gloo on the CPU. NCCL refuses
    two ranks on one card: give ``backend="gloo"`` for that. Returns this
    rank's device.
    """
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs the torchrun environment; {missing} unset "
                           "(launch with python -m torch.distributed.run)")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') without a card")
        index = int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                device_id=device if backend == "nccl" else None)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, rp) mesh of ranks.

    ``ranks``: the world ranks of the mesh, row-major; ``rank``: this
    process's index among them; ``group`` / ``dp_group`` / ``rp_group``: the
    process groups of the whole mesh, of this rank's dp column and of its rp
    row (None where that group is this rank alone); ``index`` / ``count``:
    which of the world's meshes this is, and how many there are.
    """

    dp: int
    rp: int
    rank: int
    ranks: Tuple[int, ...]
    device: torch.device
    group: Any = None
    dp_group: Any = None
    rp_group: Any = None
    index: int = 0
    count: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.rp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "rp": self.rp}

    @property
    def coord(self) -> Tuple[int, int]:
        """This rank's (dp, rp) coordinate."""
        return divmod(self.rank, self.rp)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, rp: int = 1,
              device=None) -> Mesh:
    """Build a (dp, rp) mesh of ``n_devices`` ranks (default: the world; at
    most the world, as the JAX package takes the first ``n_devices``
    devices). A world of more ranks is cut into consecutive meshes of that
    size, which must divide it. Every rank of the world calls this, in the
    same order, since each group is made collectively.

    ``device``: this rank's device (default: the current CUDA device where
    a card is present, else the CPU).
    """
    rank, size = world()
    n = size if n_devices is None else min(n_devices, size)
    dp, rp = mesh_shape(n, dp, rp)
    if size % n != 0:
        raise ValueError(f"a world of {size} ranks does not divide into meshes of {n}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    index = rank // n
    mine = {}
    for g in range(size // n):
        ranks = list(range(g * n, (g + 1) * n))
        # every rank makes every group, in one order (new_group is collective)
        made = {"group": _new_group(ranks)}
        for j in range(rp):
            made[("dp", j)] = _new_group(ranks[j::rp])
        for i in range(dp):
            made[("rp", i)] = _new_group(ranks[i * rp:(i + 1) * rp])
        if g == index:
            mine = made
    local = rank - index * n
    i, j = divmod(local, rp)
    return Mesh(dp=dp, rp=rp, rank=local, ranks=tuple(range(index * n, (index + 1) * n)),
                device=torch.device(device), group=mine.get("group"),
                dp_group=mine.get(("dp", j)), rp_group=mine.get(("rp", i)),
                index=index, count=size // n)


def _new_group(ranks: List[int]):
    return dist.new_group(ranks) if len(ranks) > 1 else None


# --- collectives --------------------------------------------------------------

def _comm_device() -> torch.device:
    """Where the backend takes its tensors: the current card for NCCL, the
    host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


WORLD = "world"


def all_reduce_sum(t: torch.Tensor, group=WORLD) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (the world by default; None: this rank
    alone), on ``t``'s device; ``t`` is left as it was."""
    if group is None or not initialized():
        return t.clone()
    buf = t.detach().to(_comm_device(), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=None if isinstance(group, str) else group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """``t`` of every rank of ``group`` (None: this rank alone), in rank
    order, on ``t``'s device; every rank's ``t`` has one shape and dtype."""
    if group is None or not initialized():
        return [t]
    buf = t.detach().contiguous().to(_comm_device())
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, buf, group=group)
    return [o.to(t.device) for o in out]


def broadcast_(t: torch.Tensor, src: int, group) -> None:
    """Overwrite ``t`` in place with world rank ``src``'s ``t`` over
    ``group`` (None: nothing to do)."""
    if group is None or not initialized():
        return
    buf = t.detach().to(_comm_device(), copy=True)
    dist.broadcast(buf, src=src, group=group)
    with torch.no_grad():
        t.copy_(buf.to(t.device))


def broadcast_object(obj, src: int = 0):
    """World rank ``src``'s ``obj`` (picklable), on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if initialized():
        dist.barrier()
