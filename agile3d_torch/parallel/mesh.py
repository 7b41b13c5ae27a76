"""Process groups for the parallel paths (counterpart of the JAX package's
``parallel/mesh.py``), the collectives that their shard-local bodies call,
and the launcher of the ranks.

The JAX package is one controller: one process drives every device through
``jax.shard_map`` over a ``("dp", "sp")`` mesh. Here each rank is a process
of a ``torch.distributed`` group, and a shard-local body runs in every rank
at once. ``make_mesh`` lays the world out as ``n_dp x n_sp`` (rank =
``dp_index * n_sp + sp_index``, JAX's ``reshape(n_dp, n_sp)``) and gives
each axis its own group. Rank r of an axis owns rows ``[r L, (r + 1) L)``
of every padded level, as ``P(axis)`` gives shard r in JAX, so rows stay
sorted across shards.

The collectives carry JAX's names (``psum``, ``pmax``, ``pmin``,
``all_gather`` tiled on dim 0, ``axis_index``), so a shard-local body reads
line for line like its JAX counterpart. They carry no gradient. On a
``gloo`` group a CUDA tensor is staged through the host; bf16 and f16 are
reduced in f32 and rounded once, bool as int32 (a sum of one value with
zeros, as the halo exchange and the click-feature gathers do, is exact).
A group that fails to form, or a collective that fails, raises: nothing
falls back to one process.

Backends: ``nccl`` for CUDA, ``gloo`` for the CPU; NCCL refuses two ranks on
one device, so a ``nccl`` layout of more ranks than cards is refused here,
before any process starts. ``spawn`` starts ranks with the ``spawn`` start
method and a ``FileStore`` rendezvous under a temporary directory (no TCP
port); ``launch`` runs a function on the caller's group when it already is
one of the right size (``torchrun``, or a caller's own ``spawn``) and
spawns the ranks otherwise.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import NamedTuple

import torch
import torch.distributed as dist

# long enough for rank 0's validation while the others wait at a barrier;
# a rank that dies ends the others through the launcher, not the timeout
GROUP_TIMEOUT = datetime.timedelta(hours=6)


class ParallelLayoutError(ValueError):
    """A layout the processes or the cards cannot hold; the CLIs exit with
    its one line."""


class Axis(NamedTuple):
    """One mesh axis as seen from this rank: its group (None when the axis
    has one rank), its size, this rank's index on it and the backend."""

    name: str
    group: object
    size: int
    index: int
    backend: str


# an axis of one rank, as one process is: every collective is the identity
ONE_RANK = Axis("one", None, 1, 0, "")


class Mesh(NamedTuple):
    """``shape`` {"dp": n_dp, "sp": n_sp}; ``axes`` {name: Axis};
    ``device``: this rank's device."""

    shape: dict
    axes: dict
    device: torch.device

    def __getitem__(self, name):
        return self.axes[name]


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_layout(world: int, backend: str) -> None:
    """Refuse a ``nccl`` world of more ranks than CUDA devices (NCCL
    refuses two ranks on one device)."""
    if backend == "nccl":
        have = torch.cuda.device_count()
        if world > have:
            raise ParallelLayoutError(
                f"{world} ranks on nccl need {world} CUDA devices, this "
                f"machine has {have}: NCCL takes one rank per card")


def rank_device(device) -> torch.device:
    """This rank's device: the CPU, or card ``rank % cards`` (rank r on
    ``cuda:r`` under nccl; every rank on the one card of a one-card gloo
    group)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def make_mesh(n_dp: int | None = None, n_sp: int = 1, *, device) -> Mesh:
    """The ``(dp, sp)`` layout of the current group (every rank calls it, in
    the same order); ``device`` is the CPU or the card ("cuda"), and each
    rank takes its own (``rank_device``). ``n_dp`` defaults to the world
    over ``n_sp``. The layout must hold the world exactly; without a group,
    only the one-rank layout exists."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_dp is None:
        n_dp = world // n_sp
    if n_dp * n_sp != world:
        raise ParallelLayoutError(
            f"mesh {n_dp}x{n_sp} needs {n_dp * n_sp} processes, have {world}")
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    groups = {"dp": {}, "sp": {}}
    if dist.is_initialized():
        # every rank creates every group, in one order
        for s in range(n_sp):
            ranks = [d * n_sp + s for d in range(n_dp)]
            groups["dp"][s] = dist.new_group(ranks) if n_dp > 1 else None
        for d in range(n_dp):
            ranks = [d * n_sp + s for s in range(n_sp)]
            groups["sp"][d] = dist.new_group(ranks) if n_sp > 1 else None
    d_idx, s_idx = divmod(rank, n_sp)
    axes = {"dp": Axis("dp", groups["dp"].get(s_idx), n_dp, d_idx, backend),
            "sp": Axis("sp", groups["sp"].get(d_idx), n_sp, s_idx, backend)}
    return Mesh({"dp": n_dp, "sp": n_sp}, axes, rank_device(device))


# ---------------------------------------------------------------------------
# Collectives (no gradient)
# ---------------------------------------------------------------------------

def _wire(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A fresh copy of x in a dtype and on a device the backend takes."""
    dt = {torch.bool: torch.int32, torch.bfloat16: torch.float32,
          torch.float16: torch.float32}.get(x.dtype, x.dtype)
    y = x.detach().to(dtype=dt)
    if axis.backend == "gloo" and y.is_cuda:
        return y.cpu()
    return y.clone().contiguous()


def _reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    if axis.size == 1:
        return x
    y = _wire(x, axis)
    dist.all_reduce(y, op=op, group=axis.group)
    return y.to(device=x.device, dtype=x.dtype)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum of x over the axis' ranks (``jax.lax.psum``)."""
    return _reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ranks' x concatenated on dim 0 in rank order
    (``jax.lax.all_gather(..., tiled=True)``); x has one shape on every
    rank. The list form, which every torch version takes."""
    if axis.size == 1:
        return x
    y = _wire(x, axis)
    parts = [torch.empty_like(y) for _ in range(axis.size)]
    dist.all_gather(parts, y, group=axis.group)
    return torch.cat(parts).to(device=x.device, dtype=x.dtype)


def axis_index(axis: Axis) -> int:
    return axis.index


def barrier(axis: Axis | None = None) -> None:
    """Wait for every rank of ``axis`` (of the world without one)."""
    if not dist.is_initialized():
        return
    group = None if axis is None else axis.group
    if axis is not None and axis.size == 1:
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group,
                     device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


# ---------------------------------------------------------------------------
# Launching the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn, world: int, backend: str, device: str,
               tmp: str, threads: int, args: tuple) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, keep its result
    for the parent."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        # the ranks share the launching process's threads
        torch.set_num_threads(max(1, threads // world))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    try:
        result = fn(*args)
        barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world: int, *args, device, backend: str | None = None) -> list:
    """Run ``fn(*args)`` on ``world`` new ranks of one group (``spawn``
    start method, a ``FileStore`` under a temporary directory) and return
    each rank's result in rank order. ``device``: the CPU or the card;
    ``backend`` defaults to its own (``backend_for``). ``fn`` and its
    arguments are pickled by the start method: module-level functions only.
    A rank that raises ends the others and re-raises here."""
    import torch.multiprocessing as mp

    backend = backend or backend_for(device)
    check_layout(world, backend)
    with tempfile.TemporaryDirectory(prefix="agile3d_ranks_") as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, world, backend, str(device), tmp,
                                 torch.get_num_threads(), args),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def launch(world: int, fn, *args, device):
    """``fn(*args)`` on ``world`` ranks, returning rank 0's result (None on
    the other ranks of a caller's group): in the caller's group when one
    exists, under ``torchrun``'s environment when it names one (either must
    have ``world`` processes), else on ranks spawned here (``nccl`` for a
    CUDA device, ``gloo`` for the CPU)."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ParallelLayoutError(
                f"{world} ranks asked for inside a group of "
                f"{dist.get_world_size()}")
        return fn(*args)
    backend = backend_for(device)
    check_layout(world, backend)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if os.environ["WORLD_SIZE"] != str(world):
            raise ParallelLayoutError(
                f"{world} ranks asked for under torchrun's WORLD_SIZE="
                f"{os.environ['WORLD_SIZE']}: give torchrun {world} "
                f"processes")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://",
                                timeout=GROUP_TIMEOUT)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    return spawn(fn, world, *args, device=device, backend=backend)[0]
