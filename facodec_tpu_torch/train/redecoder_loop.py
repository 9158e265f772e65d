"""Stage-2 redecoder training loop (port of
facodec_tpu/train/redecoder_loop.py `run_redecoder_training`).

    run_redecoder_training(config_path=None, fields=None, dataset=None, max_steps=None,
                           device="cuda", log_writer=None, log_dir=None,
                           pretrained_encoder=None, ...)

Builds a frozen codec encoder and quantizer (the JAX builder's
`stage="encoder"`) and the redecoder stage (`encoder`, the Redecoder;
`decoder`; `discriminator`) from a reference-schema config.yml (needs
pyyaml), from fields as `config.FLAGSHIP_REDECODER_TRAIN` holds them (the
codec's under `codec`), or from that config, and runs the redecoder GAN
step (train/redecoder_step.py) with the JAX loop's defaults: batch 4,
80-frame segments, a log every 10 steps, a checkpoint every 1000 steps and
at each epoch's end, the seed from the config. Batches carry `wave_seg`,
`full_waves` and `wave_lens` only. Keys of the config's top level can be
given as keyword arguments, which win; `split_step: true` runs the split
step and `remat: true` recomputes the forward in the backward.

The frozen codec has seeded random weights (seed 1, as the JAX loop's
PRNGKey(1)); with `pretrained_encoder` (the argument, else the config's
key, which the JAX loop reads and skips where the file is missing) its
`encoder` and `quantizer` come from a torch checkpoint: a file of the
reference layout, or a checkpoint of the port's codec trainer
(`FAcodec_epoch_*_step_*.pth`, its `net`), so the two stages run in one
pipeline. Orbax checkpoints of the JAX trainer are not read. The frozen
modules take no gradient and no update.

Checkpoints are the codec loop's (train/loop.py), of the three redecoder
modules, their optimizers and the generators; the newest 5 are kept and a
run resumes from the latest. Draws as in the codec loop: the step's
dropout from a generator on the device seeded with seed + 1, the crops
from a CPU generator seeded with seed. Data parallelism is the codec
loop's (train/loop.py): started as a rank, the loop joins the group,
broadcasts rank 0's frozen codec and trained modules, and steps on its
rows of each batch; rank 0 alone writes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn as nn

from facodec_tpu_torch.config import FLAGSHIP_REDECODER_TRAIN
from facodec_tpu_torch.models.builder import (build_encoder_stage_from_fields,
                                              build_redecoder_train_from_fields,
                                              encoder_stage_fields, redecoder_train_fields)
from facodec_tpu_torch.train.data import PseudoDataset, segment_batch, to_device
from facodec_tpu_torch.parallel.mesh import form_layout, local_world, rank_rows
from facodec_tpu_torch.train.loop import (TrainState, broadcast_models, check_device,
                                          join_ranks, latest_checkpoint, load_checkpoint,
                                          rank_batch, seeded, train_loop)
from facodec_tpu_torch.train.optimizers import build_optimizers
from facodec_tpu_torch.train.redecoder_step import (make_redecoder_train_step,
                                                    make_redecoder_train_step_split)
from facodec_tpu_torch.utils.config import load_config
from facodec_tpu_torch.utils.weights import load_torch_checkpoint

CODEC_MODULES = ("encoder", "quantizer")
MODULES = ("encoder", "decoder", "discriminator")
CODEC_SEED = 1
BATCH_KEYS = ("wave_seg", "full_waves", "wave_lens")


def build_frozen_codec(fields: Mapping[str, Mapping[str, Any]], device: str,
                       pretrained_encoder: Optional[str] = None) -> Dict[str, nn.Module]:
    """The frozen encoder and quantizer: seeded, then the checkpoint's
    weights where one is given; no parameter takes a gradient."""
    check_device("run_redecoder_training", device)
    codec = seeded(build_encoder_stage_from_fields(fields), CODEC_MODULES, CODEC_SEED, device)
    if pretrained_encoder:
        load_torch_checkpoint(codec, pretrained_encoder)
    for m in codec.values():
        m.requires_grad_(False)
    return codec


def build_redecoder_models(fields: Mapping[str, Mapping[str, Any]], seed: int, device: str
                           ) -> Dict[str, nn.Module]:
    """The three trained modules, seeded random weights drawn on the CPU."""
    check_device("run_redecoder_training", device)
    return seeded(build_redecoder_train_from_fields(fields), MODULES, seed, device)


def run_redecoder_training(config_path: Optional[str] = None,
                           fields: Optional[Mapping[str, Mapping[str, Any]]] = None,
                           dataset=None, max_steps: Optional[int] = None, device: str = "cuda",
                           log_writer=None, log_dir: Optional[str] = None,
                           pretrained_encoder: Optional[str] = None, **options) -> TrainState:
    """Train the redecoder against a frozen codec; see the module docstring.
    The state's `frozen` holds the codec. `log_writer=False` turns the
    TensorBoard writer off; None makes one where TensorBoard imports."""
    cfg: Dict[str, Any] = {}
    if config_path is not None:
        cfg = dict(load_config(config_path))
        if fields is None:
            mp = cfg["model_params"]
            fields = dict(redecoder_train_fields(mp), codec=encoder_stage_fields(mp))
    cfg.update(options)
    fields = FLAGSHIP_REDECODER_TRAIN if fields is None else fields
    log_dir = log_dir or cfg.get("log_dir", "runs/facodec_redecoder")
    os.makedirs(log_dir, exist_ok=True)
    seed = int(cfg.get("seed", 0))
    base_lr = float(cfg.get("base_lr", (cfg.get("loss_params") or {}).get("base_lr", 1e-4)))
    if pretrained_encoder is None:
        pretrained_encoder = cfg.get("pretrained_encoder") or None
        if pretrained_encoder and not os.path.exists(pretrained_encoder):
            print(f"pretrained_encoder {pretrained_encoder} not found: the codec keeps its "
                  "seeded weights")
            pretrained_encoder = None
    elif not os.path.exists(pretrained_encoder):
        raise FileNotFoundError(f"run_redecoder_training: pretrained_encoder "
                                f"{pretrained_encoder} not found")

    device = join_ranks(device)
    form_layout(1)  # data parallelism only, as the JAX redecoder loop
    rank_rows(int(cfg.get("batch_size", 4)), *local_world())  # the node's ranks divide it
    codec = build_frozen_codec(fields["codec"], device, pretrained_encoder)
    models = build_redecoder_models(fields, seed, device)
    optimizers = build_optimizers(models, base_lr=base_lr)
    state = TrainState(models, optimizers, step=0, epoch=0, frozen=codec)
    generators = dict(step=torch.Generator(device=device).manual_seed(seed + 1),
                      data=torch.Generator().manual_seed(seed))
    resume = latest_checkpoint(log_dir)
    if resume:
        load_checkpoint(resume, state, generators)
        print(f"resumed from {resume} (epoch {state.epoch}, step {state.step})")
    broadcast_models(codec, models)
    make_step = (make_redecoder_train_step_split if cfg.get("split_step", False)
                 else make_redecoder_train_step)
    step_fn = make_step(codec, models, optimizers, remat=bool(cfg.get("remat", False)))

    if dataset is None:
        dataset = PseudoDataset(length=cfg.get("pseudo_dataset_len", 100), seed=seed)
    max_frames = int(cfg.get("max_len", 80))

    def prepare(batch):
        seg = segment_batch(batch, max_frames=max_frames, generator=generators["data"])
        return to_device(rank_batch({k: seg[k] for k in BATCH_KEYS}), device)

    return train_loop(state, step_fn, generators, dataset, cfg, prepare, log_dir, log_writer,
                      max_steps, cfg.get("bucket_frames"))
