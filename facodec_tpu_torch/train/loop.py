"""Codec training loop (port of facodec_tpu/train/loop.py `run_training`).

    run_training(config_path=None, fields=None, dataset=None, max_steps=None,
                 device="cuda", ...)

Builds the five codec-stage modules from a reference-schema config.yml
(needs pyyaml), from module fields, or from `config.FLAGSHIP_TRAIN`, with
seeded random weights drawn on the CPU (as the API builds them), one AdamW
per module (train/optimizers.py), and runs the fused GAN step
(train/step.py) over `PseudoDataset` or the dataset given, with the JAX
loop's defaults: batch 4, 80-frame segments, length buckets of 80 frames,
a log every 10 steps, a checkpoint every 1000 steps and at each epoch's
end, the seed from the config. Keys of the config's top level (batch_size,
max_len, log_interval, save_interval, epochs, seed, ...) can be given as
keyword arguments, which win.

Checkpoints are torch files `FAcodec_epoch_<e>_step_<s>.pth` in `log_dir`:
`net` (one state dict per module, which `utils.weights.load_torch_checkpoint`
reads), `optimizer` (each AdamW's moments and step count, which is the
learning-rate schedule's step), the states of the step's and the data's
generators, `step` and `epoch`. The newest 5 are kept, and a run resumes
from the latest. The TensorBoard writer is optional, as in the JAX loop.

The config keys of the JAX loop's step are read as it reads them:
`split_step: true` runs the split step (train/step.py
`make_codec_train_step_split`), `remat: true` recomputes the forward in the
backward, and, with a log writer, the factorization probes
(train/probes.py) are logged every `probe_interval` steps (default
1000 * log_interval). `donate_params` is accepted and changes nothing: it
is an XLA buffer-aliasing switch of the JAX loop, with no effect on any
number. Where `F0_path` names a file that exists and `inline_f0` is not
false, the loop reads it as the JDC F0 teacher (the reference's
`modules/JDC/bst.t7` layout, through `models.jdc.load_jdc_checkpoint`),
prints `inline F0 teacher: <path>`, and the step runs the teacher on every
mel segment in place of the batch's F0, as the JAX loop does; a file that
does not load raises.

Data parallelism (the JAX loop's `data` mesh axis): started as a rank
(`torchrun`, or `cli/train.py`, which starts one rank per visible GPU), the
loop joins the process group (parallel/mesh.py `init_distributed`: NCCL on
cuda:LOCAL_RANK, gloo on the CPU), broadcasts rank 0's parameters after
seeding or resuming, and runs the data-parallel step (train/step.py) on
its rows of each batch: every rank reads the same seeded order and draws
every row's crop, so the crop generator stays in step, and keeps its
contiguous share of the global batch of `batch_size` rows (`rank_batch`);
the ranks of a node must divide it. Across nodes each node is a JAX host:
it iterates `shard_iterator(rank=node, world_size=nodes)` and its ranks
split its batch. Only rank 0 writes checkpoints and TensorBoard, and every
rank waits at a barrier after each save; every rank resumes from the
latest checkpoint. The generators' states are saved once: they agree
across ranks by construction.

Tensor parallelism (`tensor_parallel: N`, the JAX loop's `model` mesh
axis): the ranks form a (world // N data, N model) layout
(parallel/mesh.py `form_layout`, data-major as JAX's `make_mesh`); the JAX
loop's data axis, gcd(batch_size, devices // N), is the world over N here,
since the ranks are started to fit it (cli/train.py), and it must divide
the batch. A world that N does not divide raises, one plain process with
N over 1 too, as `make_mesh` fails with fewer devices than N. The whole
weights are seeded (or resumed) and broadcast as above, then every rank
keeps its rows of the wide heads (parallel/sharding.py `shard_training`,
`tp_param_shardings`'s rule at its default `min_elems`, as the JAX loop
applies it) and of their AdamW moments. The ranks of one model
group take the same rows of each batch and make the same draws;
checkpoints hold the whole tensors, gathered over the model group before
rank 0 writes, so they load into one process and back. The probes run on
every rank of a tensor-parallel run (their heads gather), and rank 0 logs
them.

Draws: the step's (dropout, quantizer dropout, residual mask) from a
generator on the device seeded with seed + 1; the data order from seed
114514 + epoch; the segment crops from a CPU generator seeded with seed.
The dataset's own draws are its own (PseudoDataset: numpy, its seed).
"""

from __future__ import annotations

import glob
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from facodec_tpu_torch.config import FLAGSHIP_TRAIN
from facodec_tpu_torch.models.jdc import load_jdc_checkpoint
from facodec_tpu_torch.models.builder import build_train_from_fields, train_fields
from facodec_tpu_torch.parallel.mesh import (broadcast_, data_world, form_layout,
                                             init_distributed, is_distributed, layout,
                                             local_world, rank_device, rank_rows, world_rank)
from facodec_tpu_torch.parallel.sharding import (shard_training, whole_optimizer_state,
                                                 whole_state_dict)
from facodec_tpu_torch.train.data import (PseudoDataset, prefetch, segment_batch,
                                          shard_iterator, to_device)
from facodec_tpu_torch.train.optimizers import AdamW, build_optimizers
from facodec_tpu_torch.train.probes import log_probe_audio, make_probe_fn
from facodec_tpu_torch.train.step import make_codec_train_step, make_codec_train_step_split
from facodec_tpu_torch.utils.config import load_config
from facodec_tpu_torch.utils.weights import init_random_

CKPT_GLOB = "FAcodec_epoch_*_step_*.pth"
MODULES = ("encoder", "quantizer", "decoder", "fa_predictors", "discriminator")


@dataclass
class TrainState:
    """What a run leaves: the modules, their optimizers, the step reached,
    the epoch, the last step's metrics (floats), per logged step its host
    time in seconds (a step's dispatch until its metrics are read), and the
    frozen modules a run trains against (redecoder training's codec) and
    the run's generators (`step`, `data`) as the run left them."""

    models: Dict[str, nn.Module]
    optimizers: Dict[str, AdamW]
    step: int
    epoch: int
    metrics: Dict[str, float] = field(default_factory=dict)
    step_times: Dict[int, float] = field(default_factory=dict)
    frozen: Dict[str, nn.Module] = field(default_factory=dict)
    generators: Dict[str, torch.Generator] = field(default_factory=dict)


def _step_of(path: str):
    m = re.search(r"epoch_(\d+)_step_(\d+)", os.path.basename(path))
    return (int(m.group(2)), int(m.group(1)), os.path.getmtime(path))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, CKPT_GLOB)), key=_step_of)
    return os.path.abspath(ckpts[-1]) if ckpts else None


def whole_states(state: TrainState) -> Tuple[Dict, Dict]:
    """(net, optimizer) of a checkpoint: each module's state dict and each
    AdamW's, with every shard gathered whole under tensor parallelism (a
    collective there: every rank calls it)."""
    if layout() is None:
        return ({k: m.state_dict() for k, m in state.models.items()},
                {k: o.state_dict() for k, o in state.optimizers.items()})
    return ({k: whole_state_dict(m) for k, m in state.models.items()},
            {k: whole_optimizer_state(o) for k, o in state.optimizers.items()})


def save_checkpoint(ckpt_dir: str, state: TrainState, generators: Mapping[str, torch.Generator],
                    keep: int = 5, states: Optional[Tuple[Dict, Dict]] = None) -> str:
    """Write a checkpoint of `state` (its `whole_states`, or `states` where
    they were gathered already) and keep the newest `keep`."""
    path = os.path.abspath(os.path.join(
        ckpt_dir, f"FAcodec_epoch_{state.epoch:05d}_step_{state.step:05d}.pth"))
    net, optimizer = states or whole_states(state)
    torch.save(dict(net=net, optimizer=optimizer,
                    generators={k: g.get_state() for k, g in generators.items()},
                    step=state.step, epoch=state.epoch), path)
    for old in sorted(glob.glob(os.path.join(ckpt_dir, CKPT_GLOB)), key=_step_of)[:-keep]:
        os.remove(old)
    return path


def load_checkpoint(path: str, state: TrainState,
                    generators: Mapping[str, torch.Generator]) -> None:
    """Restore modules, optimizers, generators, step and epoch in place."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for k, m in state.models.items():
        m.load_state_dict(ckpt["net"][k])
    for k, o in state.optimizers.items():
        o.load_state_dict(ckpt["optimizer"][k])
    for k, g in generators.items():
        g.set_state(ckpt["generators"][k])
    state.step, state.epoch = int(ckpt["step"]), int(ckpt["epoch"])


def check_device(who: str, device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device {device!r} asked for, but torch sees no CUDA "
                           f"device; pass device='cpu' (--device cpu) to train on the CPU")


def seeded(models: Mapping[str, nn.Module], names, seed: int, device: str
           ) -> Dict[str, nn.Module]:
    """The modules `names`, seeded random weights drawn on the CPU in that
    order from one generator, on `device`."""
    gen = torch.Generator().manual_seed(seed)
    for name in names:
        init_random_(models[name], gen)
    return {name: models[name].to(device) for name in names}


def build_models(fields: Mapping[str, Mapping[str, Any]], seed: int, device: str
                 ) -> Dict[str, nn.Module]:
    """The five modules with seeded random weights drawn on the CPU, on `device`."""
    check_device("run_training", device)
    return seeded(build_train_from_fields(fields), MODULES, seed, device)


def join_ranks(device: str) -> str:
    """The process's device: `device` in one plain process; where it was
    started as a rank, the rank's (cuda:LOCAL_RANK, or the CPU) once it has
    joined the process group."""
    if init_distributed(device):
        return str(rank_device(device))
    return device


def rank_batch(batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's contiguous rows of its node's batch (all of it in one
    plain process). `full_waves` keeps the batch's padded length, so the
    timbre encoder sees the shapes the one-process step sees."""
    local_rank, local_size = local_world()
    if local_size == 1:
        return dict(batch)
    rows = rank_rows(len(batch["wave_lens"]), local_rank, local_size)
    return {k: v[rows] for k, v in batch.items()}


def broadcast_models(*groups: Mapping[str, nn.Module]) -> None:
    """Rank 0's parameters and buffers on every rank (after seeding or
    resuming); nothing in one plain process."""
    if is_distributed():
        broadcast_([t for models in groups for m in models.values()
                    for t in (*m.parameters(), *m.buffers())])


def inline_f0_teacher(cfg: Mapping[str, Any], device: str) -> Optional[nn.Module]:
    """The JDC teacher of `F0_path` on `device` where that file exists and
    `inline_f0` is not false (the JAX loop's rule), else None."""
    f0_path = cfg.get("F0_path", "")
    if not (cfg.get("inline_f0", True) and f0_path and os.path.exists(f0_path)):
        return None
    teacher = load_jdc_checkpoint(f0_path, device)
    print(f"inline F0 teacher: {f0_path}")
    return teacher


def _default_writer(log_dir: str):
    """tensorboardX's writer where it is installed, as the JAX loop makes it."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(os.path.join(log_dir, "tensorboard"))
    except Exception:
        return None


def run_training(config_path: Optional[str] = None,
                 fields: Optional[Mapping[str, Mapping[str, Any]]] = None, dataset=None,
                 max_steps: Optional[int] = None, device: str = "cuda", log_writer=None,
                 log_dir: Optional[str] = None, **options) -> TrainState:
    """Train the codec; see the module docstring. `log_writer=False` turns
    the TensorBoard writer off; None makes one where TensorBoard imports."""
    cfg: Dict[str, Any] = {}
    if config_path is not None:
        cfg = dict(load_config(config_path))
        if fields is None:
            fields = train_fields(cfg["model_params"])
    cfg.update(options)
    fields = FLAGSHIP_TRAIN if fields is None else fields
    log_dir = log_dir or cfg.get("log_dir", "runs/facodec_tpu_torch")
    os.makedirs(log_dir, exist_ok=True)
    seed = int(cfg.get("seed", 0))
    base_lr = float(cfg.get("base_lr", (cfg.get("loss_params") or {}).get("base_lr", 1e-4)))

    device = join_ranks(device)
    lay = form_layout(int(cfg.get("tensor_parallel", 1)))
    rank_rows(int(cfg.get("batch_size", 4)), *local_world())  # the node's data ranks divide it
    models = build_models(fields, seed, device)
    optimizers = build_optimizers(models, base_lr=base_lr)
    state = TrainState(models, optimizers, step=0, epoch=0)
    generators = dict(step=torch.Generator(device=device).manual_seed(seed + 1),
                      data=torch.Generator().manual_seed(seed))
    resume = latest_checkpoint(log_dir)
    if resume:
        load_checkpoint(resume, state, generators)
        print(f"resumed from {resume} (epoch {state.epoch}, step {state.step})")
    broadcast_models(models)
    shards = shard_training(models, optimizers, lay)
    if lay is not None and world_rank()[0] == 0:
        print(f"tensor parallel: data {lay.n_data} x model {lay.n_model}; sharded {shards}")
    make_step = (make_codec_train_step_split if cfg.get("split_step", False)
                 else make_codec_train_step)
    step_fn = make_step(models, optimizers, remat=bool(cfg.get("remat", False)),
                        f0_teacher=inline_f0_teacher(cfg, device))

    if dataset is None:
        # labels within the heads' classes (the flagship's are the defaults)
        heads = fields["fa_predictors"]
        dataset = PseudoDataset(length=cfg.get("pseudo_dataset_len", 100), seed=seed,
                                n_phones=heads.get("n_phone_classes", 1024),
                                n_speakers=heads.get("n_speakers", 20000))
    max_frames = int(cfg.get("max_len", 80))

    def prepare(batch):
        seg = segment_batch(batch, max_frames=max_frames, generator=generators["data"])
        return to_device(rank_batch(seg), device)

    return train_loop(state, step_fn, generators, dataset, cfg, prepare, log_dir, log_writer,
                      max_steps, int(cfg.get("bucket_frames", 80)), make_probe_fn(models))


def train_loop(state: TrainState, step_fn, generators: Mapping[str, torch.Generator], dataset,
               cfg: Mapping[str, Any], prepare, log_dir: str, log_writer, max_steps: Optional[int],
               bucket_frames: Optional[int], probe=None) -> TrainState:
    """The epochs of a run, from `state`: batches of `dataset` in the seeded
    order, `prepare`d a few ahead, one `step_fn` each; the metrics logged
    every `log_interval` steps, `probe`'s audio every `probe_interval`
    steps (where both a probe and a writer are given), a checkpoint every
    `save_interval` steps and at each epoch's end, until `max_steps`.
    `log_writer=False` logs nothing; None makes a TensorBoard writer where
    TensorBoard imports. Where the process is a rank, only rank 0 logs and
    saves, and the ranks meet at a barrier after each save; under tensor
    parallelism every rank gathers the checkpoint's shards first and runs
    the probes."""
    rank, world = world_rank()
    data_rank, data_size = data_world()
    local_size = local_world()[1]
    if rank != 0:
        log_writer = False
    elif log_writer is None:
        log_writer = _default_writer(log_dir)
    tp = layout() is not None
    probing = [bool(log_writer)]
    if tp:  # every rank of a model group runs a probe that rank 0 logs
        dist.broadcast_object_list(probing, src=0)

    def save() -> None:
        states = whole_states(state) if tp else None
        if rank == 0:
            save_checkpoint(log_dir, state, generators, states=states)
        if world > 1:
            dist.barrier()

    log_interval = int(cfg.get("log_interval", 10))
    save_interval = int(cfg.get("save_interval", 1000))
    probe_interval = int(cfg.get("probe_interval", 1000 * log_interval))
    metrics: Dict[str, torch.Tensor] = {}
    for epoch in range(state.epoch, int(cfg.get("epochs", 1000))):
        state.epoch = epoch
        batches = shard_iterator(dataset, int(cfg.get("batch_size", 4)),
                                 rank=data_rank // local_size,
                                 world_size=data_size // local_size,
                                 epoch=epoch, bucket_frames=bucket_frames)
        for seg in prefetch(batches, prepare, depth=int(cfg.get("prefetch", 2))):
            t0 = time.perf_counter()
            metrics, _ = step_fn(seg, generators["step"])
            state.step += 1
            if state.step % log_interval == 0:
                values = {k: float(v) for k, v in metrics.items()}
                state.step_times[state.step] = time.perf_counter() - t0
                if log_writer:
                    for k, v in values.items():
                        log_writer.add_scalar(f"train/{k}", v, state.step)
                    log_writer.add_scalar("train/time", state.step_times[state.step],
                                          state.step)
            if probe is not None and probing[0] and state.step % probe_interval == 0:
                audio = probe(seg)
                if log_writer:
                    log_probe_audio(log_writer, audio, state.step)
            if state.step % save_interval == 0:
                save()
            if max_steps is not None and state.step >= max_steps:
                break
        else:
            if (epoch + 1) % int(cfg.get("save_freq", 1)) == 0:
                state.epoch = epoch + 1
                save()
            continue
        break
    state.metrics = {k: float(v) for k, v in metrics.items()}
    state.generators = dict(generators)
    return state
