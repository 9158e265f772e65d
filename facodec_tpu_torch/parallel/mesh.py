"""Data parallelism over GPUs (port of facodec_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a `data` mesh axis: the batch is
sharded over it, the parameters replicated, and the partitioner inserts the
gradient all-reduce. The port runs one process per GPU (a rank), each with
a replica of the modules and its rows of the global batch, and reduces
explicitly:

- `init_distributed` joins the process group from the environment that
  `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
  NCCL for CUDA devices, gloo for the CPU or where the caller names it. In
  one plain process (no WORLD_SIZE) it does nothing. A group that does not
  form raises; a group still up when the process exits is ended first.
- `all_reduce_mean_` averages gradients over the ranks in flat buckets of a
  fixed size, one collective a bucket (`ReduceOp.AVG` on NCCL, a sum and a
  division by the world size on gloo), written back in place. The train
  steps call it between `torch.autograd.grad` and each optimizer's update,
  so the clip sees the global gradient on every rank. DDP's wrapper is not
  used: the steps take their gradients with `torch.autograd.grad`, which
  never runs the hooks its reducer hangs on.
- `global_mean` makes a loss term that is a nonlinear function of a batch
  mean (the focal loss's weight on the batch-mean cross-entropy) see the
  global batch's mean, with the rank's own gradient.
- `row_shard` tells the draw sites (dropout, the quantizer dropout's rows,
  the residual mask) the global batch and the rank's rows of it: each rank
  draws what the one-process step draws for the whole batch and keeps its
  own rows (`rand_rows`, `global_rows`), so a data-parallel step equals the
  one-process step with the draws on, as the JAX SPMD step does.
- `make_devices` gives the devices of batch-parallel inference
  (`api.FACodec.shard_inference`), one replica each.
"""

from __future__ import annotations

import atexit
import contextlib
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2**20  # DDP's default bucket
TIMEOUT = timedelta(minutes=10)
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether this process was started as a rank (WORLD_SIZE is set)."""
    return "WORLD_SIZE" in os.environ


def rank_device(device="cuda") -> torch.device:
    """The rank's device: the CPU when asked, the index given, else
    cuda:LOCAL_RANK. Raises where that card is not visible."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", 0))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= count:
        raise RuntimeError(f"rank device cuda:{index} asked for, but torch sees {count} CUDA "
                           "device(s); pass device='cpu' (--device cpu) to run ranks on the CPU")
    return torch.device("cuda", index)


def init_distributed(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group from torchrun's environment; returns whether
    this process is a rank. NCCL for CUDA devices, gloo for the CPU or
    where `backend` names it. A no-op without WORLD_SIZE, or in a group
    already formed."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: WORLD_SIZE is set but {missing} are not "
                           "(torchrun sets all of RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                           "MASTER_PORT)")
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT)
    atexit.unregister(_end_group)  # once, however often a group is formed
    atexit.register(_end_group)
    return True


def _end_group() -> None:
    """End the process group, if it is still up, before the interpreter
    finalizes: a gloo group left to Python's teardown could destroy its
    transport threads in any order and abort the rank (SIGABRT, "terminate
    called without an active exception") after its work was done."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """Whether this process runs as a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def data_world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_world() -> Tuple[int, int]:
    """(local rank, ranks on this node): torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE, else the group's rank and size (one node); (0, 1)
    without a group."""
    rank, world = data_world()
    if world == 1:
        return 0, 1
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def rank_rows(global_rows: int, rank: int, world: int) -> slice:
    """The rank's contiguous rows of a global batch; `world` must divide it."""
    if global_rows % world:
        raise ValueError(f"a global batch of {global_rows} rows does not split over {world} "
                         "ranks")
    n = global_rows // world
    return slice(rank * n, (rank + 1) * n)


def make_devices() -> List[torch.device]:
    """The replica devices of batch-parallel inference: every visible GPU.
    Raises where there is none."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_devices: every visible replica GPU asked for, torch sees none; "
                           "name the devices (e.g. devices=['cpu', 'cpu']) to run elsewhere")
    return [torch.device("cuda", i) for i in range(count)]


@contextlib.contextmanager
def rank_store() -> Iterator[Dict[str, str]]:
    """The rendezvous of ranks that this process starts on this host: a
    TCPStore that this process holds, on a port the OS picks as the store
    binds it. Yields the environment (MASTER_ADDR, MASTER_PORT and
    TORCHELASTIC_USE_AGENT_STORE, as torchrun's agent sets them) under which
    each rank's `init_distributed` joins that store as a client; the store
    closes when the block ends. The port stays bound from its choice to the
    group's end, so no other process (another group's ranks, an outgoing
    connection) can take it between the two, as it could from a port
    probed, closed and handed to rank 0 to bind again."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                          timeout=TIMEOUT)
    try:
        yield dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                   TORCHELASTIC_USE_AGENT_STORE="True")
    finally:
        del store


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    """Consecutive tensors of one dtype and device, up to BUCKET_BYTES each
    (a larger tensor alone)."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def _bucketed_(tensors: Sequence[torch.Tensor], collective) -> None:
    for bucket in _buckets(tensors):
        if len(bucket) == 1 and bucket[0].is_contiguous():
            collective(bucket[0].view(-1))
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        offset = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[offset: offset + n].view_as(t))
            offset += n


@dataclass
class ReduceStats:
    """Collectives issued by `all_reduce_mean_` in this process, and their bytes."""

    calls: int = 0
    bytes: int = 0


REDUCED = ReduceStats()


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average `tensors` over the ranks in place: one all-reduce per flat
    bucket of up to BUCKET_BYTES, counted in `REDUCED`."""
    world = dist.get_world_size()
    nccl = dist.get_backend() == "nccl"

    def reduce(flat: torch.Tensor) -> None:
        if nccl:
            dist.all_reduce(flat, op=dist.ReduceOp.AVG)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat.div_(world)
        REDUCED.calls += 1
        REDUCED.bytes += flat.numel() * flat.element_size()

    _bucketed_(list(tensors), reduce)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite `tensors` in place with rank `src`'s, in flat buckets."""
    _bucketed_(list(tensors), lambda flat: dist.broadcast(flat, src))


def reduce_gradients(params: Sequence[torch.Tensor],
                     grads: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
    """The step's gradients, averaged over the ranks where this process is
    one: a None gradient becomes zeros first, so every rank sends the same
    buckets. In one plain process, `grads` unchanged."""
    if not is_distributed():
        return list(grads)
    full = [torch.zeros_like(p) if g is None else g.contiguous()
            for p, g in zip(params, grads, strict=True)]
    all_reduce_mean_(full)
    return full


def average_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over the ranks in one collective (the global
    batch's values where each is a mean over equal rows); unchanged in
    one plain process."""
    if not is_distributed() or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce_mean_([flat])
    return dict(zip(keys, flat.unbind()))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """A rank's mean over its rows -> the value of the global batch's mean
    (the ranks hold equal rows), with the gradient of the rank's own mean:
    averaged over the ranks, the gradients of f(global_mean(x)) are those
    of f of the global mean. x itself in one process or a group of one."""
    if data_world()[1] == 1:
        return x
    g = x.detach().clone()
    all_reduce_mean_([g])
    return g + (x - x.detach())


# -------------------------------------------------------------- draws


@dataclass(frozen=True)
class RowShard:
    """A rank's rows [offset, offset + rows) of a global batch."""

    global_rows: int
    offset: int
    rows: int


_SHARD: Optional[RowShard] = None  # process-wide: the backward's recompute runs on other threads


@contextlib.contextmanager
def row_shard(global_rows: int, offset: int, rows: int) -> Iterator[None]:
    """Inside the block, draws of a batch of `rows` rows are drawn at the
    global batch's shape and cut to [offset, offset + rows)."""
    global _SHARD
    old, _SHARD = _SHARD, RowShard(global_rows, offset, rows)
    try:
        yield
    finally:
        _SHARD = old


def step_rows(rows: int):
    """The row shard of a data-parallel step over equal per-rank batches of
    `rows` rows (the global batch is rows * world, this rank's rows at
    rank * rows); a no-op in one plain process."""
    rank, world = data_world()
    if world == 1:
        return contextlib.nullcontext()
    return row_shard(rows * world, rank * rows, rows)


def global_rows(rows: int) -> Tuple[int, int]:
    """(global batch rows, this rank's offset) for a draw over a batch of
    `rows` rows: (rows, 0) outside a row shard."""
    if _SHARD is None:
        return rows, 0
    if rows != _SHARD.rows:
        raise ValueError(f"a draw over {rows} rows inside a row shard of {_SHARD.rows} rows")
    return _SHARD.global_rows, _SHARD.offset


def rand_rows(shape: Sequence[int], generator: torch.Generator, device) -> torch.Tensor:
    """torch.rand(shape) over a batch (rows first): inside a row shard, the
    global batch's draw cut to this rank's rows."""
    total, offset = global_rows(shape[0])
    u = torch.rand((total, *shape[1:]), generator=generator, device=device)
    return u if total == shape[0] else u[offset: offset + shape[0]]
