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

Tensor parallelism (the JAX mesh's `model` axis, `tensor_parallel: N`):
`form_layout(n_model)` lays the ranks out as a (data, model) grid in
data-major order, as `facodec_tpu/parallel/mesh.py` `make_mesh` reshapes
its devices: rank r is data rank r // n_model and model rank r % n_model,
and every rank joins its data group (the ranks of one model rank) and its
model group (the ranks of one data rank) by `dist.new_group`. Under a
layout `data_world`, `local_world`, the draws' row shard, `global_mean` and
`average_metrics` follow the data group: the ranks of one model group hold
the same rows and compute the same replicated values. `reduce_gradients`
averages a gradient of a parameter sharded over the model group
(parallel/sharding.py) over the data group only, and every other gradient
over the whole world, as before. `world_rank` is the rank in the whole
group (rank 0 writes).
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
    global _LAYOUT
    _LAYOUT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """Whether this process runs as a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world_rank() -> Tuple[int, int]:
    """(rank, world size) of the whole process group; (0, 1) without one."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class Layout:
    """A rank's place in the (data, model) grid, and its two groups."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    world_group: object  # the default group the subgroups were made in


_LAYOUT: Optional[Layout] = None


def form_layout(n_model: int) -> Optional[Layout]:
    """Lay the process group out as (world // n_model data, n_model model)
    ranks, data-major, and return this rank's place; None (no layout) for
    a model axis of 1. Every rank calls it, with the same n_model: each
    subgroup is made by every rank. Raises where n_model does not divide
    the world, as `make_mesh` fails with fewer devices than the model axis."""
    global _LAYOUT
    rank, world = world_rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"a world of {world} rank(s) is not divisible by a model axis of "
                         f"{n_model} (tensor_parallel); start a multiple of {n_model} ranks")
    if n_model == 1:
        _LAYOUT = None
        return None
    if (_LAYOUT is not None and _LAYOUT.n_model == n_model
            and _LAYOUT.world_group is dist.group.WORLD):
        return _LAYOUT
    n_data = world // n_model
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    d, m = divmod(rank, n_model)
    _LAYOUT = Layout(n_data, n_model, d, m, data_groups[m], model_groups[d], dist.group.WORLD)
    return _LAYOUT


def layout() -> Optional[Layout]:
    """This rank's (data, model) layout where one was formed in the
    current process group, else None."""
    if _LAYOUT is None or not is_distributed() or _LAYOUT.world_group is not dist.group.WORLD:
        return None
    return _LAYOUT


def data_world() -> Tuple[int, int]:
    """(data rank, data ranks): the rank and size of the process group, or
    under a layout its data rank and data axis; (0, 1) without a group."""
    lay = layout()
    if lay is not None:
        return lay.data_rank, lay.n_data
    return world_rank()


def local_world() -> Tuple[int, int]:
    """(local data rank, data ranks on this node): torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE, else the group's rank and size (one node), each over
    the model axis under a layout (a node holds whole model groups); (0, 1)
    without a group."""
    rank, world = world_rank()
    if world == 1:
        return 0, 1
    lay = layout()
    n_model = 1 if lay is None else lay.n_model
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local_size % n_model:
        raise ValueError(f"{local_size} ranks on this node do not hold whole model groups of "
                         f"{n_model}")
    return local_rank // n_model, local_size // n_model


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
    """Collectives of one kind issued in this process, and their bytes."""

    calls: int = 0
    bytes: int = 0

    def add(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()


REDUCED = ReduceStats()  # `all_reduce_mean_`: gradients, metrics, global means
MODEL_SUMS = ReduceStats()  # `model_sum_`: the sharded heads' input gradients, the clip's sums
GATHERED = ReduceStats()  # `gather_model`: the sharded heads' outputs (bytes sent)


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average `tensors` over the ranks of `group` (default: every rank) in
    place: one all-reduce per flat bucket of up to BUCKET_BYTES, counted in
    `REDUCED`."""
    world = dist.get_world_size(group)
    nccl = dist.get_backend(group) == "nccl"

    def reduce(flat: torch.Tensor) -> None:
        if nccl:
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            flat.div_(world)
        REDUCED.add(flat)

    _bucketed_(list(tensors), reduce)


@torch.no_grad()
def model_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over this rank's model group in place (one all-reduce,
    counted in `MODEL_SUMS`); returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=layout().model_group)
    MODEL_SUMS.add(t)
    return t


@torch.no_grad()
def gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's tensors concatenated along `dim`, in model-rank
    order (one all-gather, counted in `GATHERED`)."""
    lay = layout()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(lay.n_model)]
    dist.all_gather(parts, t, group=lay.model_group)
    GATHERED.add(t)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite `tensors` in place with rank `src`'s, in flat buckets."""
    _bucketed_(list(tensors), lambda flat: dist.broadcast(flat, src))


def is_sharded(param: torch.Tensor) -> bool:
    """Whether `param` is a row shard over the model group
    (parallel/sharding.py marks it)."""
    return getattr(param, "tp_shard", None) is not None


def reduce_gradients(params: Sequence[torch.Tensor],
                     grads: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
    """The step's gradients, averaged over the ranks where this process is
    one: a None gradient becomes zeros first, so every rank sends the same
    buckets. A sharded parameter's gradient is averaged over the data group
    only (the model group's ranks hold other rows of it); every other one
    over the whole world (the model group's ranks hold the same value, and
    the world's mean keeps their replicas equal). In one plain process,
    `grads` unchanged."""
    if not is_distributed():
        return list(grads)
    full = [torch.zeros_like(p) if g is None else g.contiguous()
            for p, g in zip(params, grads, strict=True)]
    lay = layout()
    if lay is None:
        all_reduce_mean_(full)
        return full
    sharded = [is_sharded(p) for p in params]
    all_reduce_mean_([g for g, s in zip(full, sharded) if not s])
    if lay.n_data > 1:
        all_reduce_mean_([g for g, s in zip(full, sharded) if s], group=lay.data_group)
    return full


def _data_group():
    lay = layout()
    return None if lay is None else lay.data_group


def average_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over the data ranks in one collective (the
    global batch's values where each is a mean over equal rows); unchanged
    in one plain process or a data axis of one."""
    if data_world()[1] == 1 or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce_mean_([flat], group=_data_group())
    return dict(zip(keys, flat.unbind()))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """A rank's mean over its rows -> the value of the global batch's mean
    (the data ranks hold equal rows), with the gradient of the rank's own
    mean: averaged over the ranks, the gradients of f(global_mean(x)) are
    those of f of the global mean. x itself in one process or a data axis
    of one."""
    if data_world()[1] == 1:
        return x
    g = x.detach().clone()
    all_reduce_mean_([g], group=_data_group())
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
