"""Training-step benchmark of the port: the whole flagship GAN step (both
phases, all five modules, teachers offline) on one card (port of the JAX
package's `bench_train.py`).

    python -m facodec_tpu_torch bench train [--batch 4] [--seg-frames 80]
        [--fast] [--device cuda] [--config-path cfg]

Prints one JSON line:
  {"metric": "train_step_ms", "value": N, "unit": "ms", "batch": B,
   "seg_frames": F, "audio_s_per_s": R, ...}

The step is `make_codec_train_step` (or `make_codec_train_step_split`) of
`config.FLAGSHIP_TRAIN` (seed 0) on one seeded batch of `batch` x
`seg_frames` frames, with full waves of twice the segment. Steps chain
through the models and the optimizers' state, so ITERS steps issued back to
back and one read of the last step's loss time ITERS steps; the step time
is the fastest of REPEATS such runs over ITERS. `audio_s_per_s` is seconds
of training audio per second. `pipeline_step_ms` runs the same step fed by
the input pipeline (`PseudoDataset` -> `shard_iterator` -> `segment_batch`
-> `to_device`, prepared ahead by `prefetch`), and `pipeline_overhead_pct`
is its cost over the step alone.

The JAX variables keep their meaning: FACODEC_TRAIN_REMAT=1 recomputes in
the backward; FACODEC_TRAIN_SPLIT=1|0 picks the split step (default: split
at batch >= 8); FACODEC_TRAIN_PAIRED_G (default 1): the port's split step
makes phase G's one discriminator pass over concat(fake, real), so 0 with
the split step is refused; FACODEC_TRAIN_PRECISION other than float32 is
refused, as the step refuses it. `--fast` times one step instead of
REPEATS runs of ITERS, with and without the pipeline. It runs on the card
unless given `--device cpu`; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from facodec_tpu_torch.bench import REPEATS, require_device, synchronize
from facodec_tpu_torch.config import FLAGSHIP_TRAIN
from facodec_tpu_torch.train.data import (PseudoDataset, prefetch, segment_batch,
                                          shard_iterator, to_device)
from facodec_tpu_torch.train.loop import build_models
from facodec_tpu_torch.train.optimizers import build_optimizers
from facodec_tpu_torch.train.step import make_codec_train_step, make_codec_train_step_split

SR, HOP = 24000, 300
ITERS = 4


def train_options(batch: int) -> dict:
    """precision, remat, split and paired_g from the JAX bench's variables."""
    split_env = os.environ.get("FACODEC_TRAIN_SPLIT", "")
    opts = dict(precision=os.environ.get("FACODEC_TRAIN_PRECISION", "float32"),
                remat=os.environ.get("FACODEC_TRAIN_REMAT", "0") == "1",
                split=split_env == "1" if split_env else batch >= 8,
                paired_g=os.environ.get("FACODEC_TRAIN_PAIRED_G", "1") != "0")
    if opts["split"] and not opts["paired_g"]:
        raise NotImplementedError("FACODEC_TRAIN_PAIRED_G=0: the port's split step makes one "
                                  "discriminator pass over concat(fake, real) in phase G; two "
                                  "separate passes are not ported")
    return opts


def bench_batch(fields, batch: int, seg_frames: int, device: torch.device) -> dict:
    """The JAX bench's seeded batch (numpy, seed 0), labels within the heads'
    classes, on `device`."""
    heads = fields["fa_predictors"]
    tw = seg_frames * HOP
    rng = np.random.default_rng(0)
    return to_device(dict(
        wave_seg=(rng.standard_normal((batch, tw)) * 0.1).astype(np.float32),
        mel_seg=(rng.standard_normal((batch, seg_frames, 80)) * 0.5).astype(np.float32),
        f0=(np.abs(rng.standard_normal((batch, seg_frames))) * 200).astype(np.float32),
        phone_ids=rng.integers(0, heads["n_phone_classes"], (batch, seg_frames)).astype(np.int32),
        spk_labels=rng.integers(0, heads["n_speakers"], (batch,)).astype(np.int32),
        full_waves=(rng.standard_normal((batch, 2 * tw)) * 0.1).astype(np.float32),
        wave_lens=np.full(batch, 2 * tw, np.int32),
    ), device)


def main(batch: int = 4, seg_frames: int = 80, fast: bool = False, device: str = "cuda",
         config_path: Optional[str] = None) -> dict:
    dev = require_device(device, "bench train")
    opts = train_options(batch)
    fields = FLAGSHIP_TRAIN
    if config_path:
        from facodec_tpu_torch.models.builder import train_fields
        from facodec_tpu_torch.utils.config import load_config

        fields = train_fields(load_config(config_path).model_params)
    models = build_models(fields, 0, str(dev))
    make = make_codec_train_step_split if opts["split"] else make_codec_train_step
    step_fn = make(models, build_optimizers(models, base_lr=1e-4), remat=opts["remat"],
                   precision=opts["precision"])
    data = bench_batch(fields, batch, seg_frames, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    repeats, iters = (1, 1) if fast else (REPEATS, ITERS)
    metrics, _ = step_fn(data, gen)  # warm-up
    float(metrics["loss/gen_all"])
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics, _ = step_fn(data, gen)
        float(metrics["loss/gen_all"])
        ts.append(time.perf_counter() - t0)
    dt = min(ts) / iters

    # the same step fed by the input pipeline, prepared ahead on a thread
    n_pipe = repeats * iters
    tw = seg_frames * HOP
    dur = 2 * tw / SR  # full waves of twice the segment, as the step above
    heads = fields["fa_predictors"]
    ds = PseudoDataset(length=(n_pipe + 2) * batch, seed=1, min_s=dur, max_s=dur,
                       n_phones=heads["n_phone_classes"], n_speakers=heads["n_speakers"])
    crops = torch.Generator().manual_seed(0)

    def prepare(b):
        seg = segment_batch(b, max_frames=seg_frames, generator=crops)
        return to_device({k: v for k, v in seg.items() if k in data}, dev)

    it = prefetch(shard_iterator(ds, batch, shuffle=False), prepare, depth=2)
    metrics, _ = step_fn(next(it), gen)  # outside the timed window
    float(metrics["loss/gen_all"])
    synchronize(dev)
    t0 = time.perf_counter()
    n_done = 0
    for seg in it:
        metrics, _ = step_fn(seg, gen)
        n_done += 1
        if n_done >= n_pipe:
            break
    float(metrics["loss/gen_all"])
    it.close()  # ends the prefetch thread
    dt_pipe = (time.perf_counter() - t0) / n_done

    audio_per_step = batch * seg_frames * HOP / SR
    result = {
        "metric": "train_step_ms",
        "value": round(dt * 1e3, 1),
        "unit": "ms",
        **opts,
        "batch": batch,
        "seg_frames": seg_frames,
        "audio_s_per_s": round(audio_per_step / dt, 2),
        "pipeline_step_ms": round(dt_pipe * 1e3, 1),
        "pipeline_overhead_pct": round((dt_pipe / dt - 1) * 100, 1),
    }
    print(json.dumps(result), flush=True)
    return result


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--seg-frames", type=int, default=80)


def run(args: argparse.Namespace) -> dict:
    return main(batch=args.batch or 4, seg_frames=args.seg_frames, fast=bool(args.fast),
                device=args.device, config_path=args.config_path)
