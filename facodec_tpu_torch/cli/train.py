"""`python -m facodec_tpu_torch train` and `train-redecoder`: train the
codec (train/loop.py) and, against a frozen codec, the redecoder
(train/redecoder_loop.py).

    python -m facodec_tpu_torch train [--config-path config.yml] [--max-steps N]
        [--device cuda|cpu] [--log-dir DIR]
    python -m facodec_tpu_torch train-redecoder [--config-path config.yml] [--max-steps N]
        [--device cuda|cpu] [--log-dir DIR] [--pretrained-encoder CKPT]

Without --config-path `train` trains `config.FLAGSHIP_TRAIN` and
`train-redecoder` `config.FLAGSHIP_REDECODER_TRAIN`, with the JAX loops'
defaults on `PseudoDataset`; a config file (pyyaml) gives the models and
the loop's keys. Checkpoints go to --log-dir (else the config's `log_dir`,
else runs/facodec_tpu_torch or runs/facodec_redecoder), and a run resumes
from the latest. --pretrained-encoder takes the frozen codec's encoder and
quantizer from a torch checkpoint, such as one `train` wrote.

Several GPUs (data parallelism, parallel/mesh.py): under `torchrun
--nproc_per_node=N -m facodec_tpu_torch train ...` each process joins the
group from torchrun's environment and trains on its rows of each batch.
Started alone on the card, the command starts gcd(batch_size, visible
GPUs) ranks itself, one per GPU (the JAX loop's "every device" default;
CUDA_VISIBLE_DEVICES limits it), and runs in this process where that is 1.
`--device cpu` with WORLD_SIZE set runs gloo ranks on the CPU. A rank that
fails ends every rank, and the command exits non-zero.
"""

from __future__ import annotations

import argparse
import math
import os

import torch

from facodec_tpu_torch.parallel.mesh import data_world, launched, rank_store
from facodec_tpu_torch.train.loop import run_training
from facodec_tpu_torch.train.redecoder_loop import run_redecoder_training
from facodec_tpu_torch.utils.config import load_config


def add_args(p: argparse.ArgumentParser, default: str = "FLAGSHIP_TRAIN") -> None:
    p.add_argument("--config-path", default=None,
                   help=f"reference-schema config.yml (needs pyyaml); default {default}")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--log-dir", default=None)


def add_redecoder_args(p: argparse.ArgumentParser) -> None:
    add_args(p, "FLAGSHIP_REDECODER_TRAIN")
    p.add_argument("--pretrained-encoder", default=None,
                   help="torch checkpoint of the frozen codec's encoder and quantizer "
                        "(default: seeded weights)")


def _report(state):
    """Print the run's end (on rank 0 only, where the process is a rank)."""
    if data_world()[0] == 0:
        print(f"trained to step {state.step} (epoch {state.epoch}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(state.metrics.items())))
    return state


def n_ranks(config_path, device: str) -> int:
    """The ranks to start on this node: gcd(batch_size, visible GPUs) on the
    card, 1 on the CPU or under torchrun (which started them)."""
    if launched() or torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return 1
    batch_size = int(load_config(config_path).get("batch_size", 4)) if config_path else 4
    return math.gcd(batch_size, torch.cuda.device_count())


def _rank_main(rank: int, world: int, store_env: dict, fn, kwargs) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), **store_env)
    _report(fn(**kwargs))


def launch(fn, config_path, device: str, **kwargs):
    """fn(config_path=..., device=..., **kwargs) in this process, or in one
    spawned rank per GPU (`n_ranks`); returns the state, or True after the
    ranks have ended (rank 0 reports)."""
    kwargs = dict(kwargs, config_path=config_path, device=device)
    n = n_ranks(config_path, device)
    if n == 1:
        return _report(fn(**kwargs))
    import torch.multiprocessing as mp

    print(f"starting {n} data-parallel ranks, one per GPU", flush=True)
    with rank_store() as store_env:
        mp.start_processes(_rank_main, args=(n, store_env, fn, kwargs), nprocs=n, join=True,
                           start_method="spawn")
    return True


def main(args: argparse.Namespace):
    return launch(run_training, args.config_path, args.device, max_steps=args.max_steps,
                  log_dir=args.log_dir)


def main_redecoder(args: argparse.Namespace):
    return launch(run_redecoder_training, args.config_path, args.device,
                  max_steps=args.max_steps, log_dir=args.log_dir,
                  pretrained_encoder=args.pretrained_encoder)
