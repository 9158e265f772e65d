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
"""

from __future__ import annotations

import argparse

from facodec_tpu_torch.train.loop import run_training
from facodec_tpu_torch.train.redecoder_loop import run_redecoder_training


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
    print(f"trained to step {state.step} (epoch {state.epoch}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(state.metrics.items())))
    return state


def main(args: argparse.Namespace):
    return _report(run_training(config_path=args.config_path, max_steps=args.max_steps,
                                device=args.device, log_dir=args.log_dir))


def main_redecoder(args: argparse.Namespace):
    return _report(run_redecoder_training(
        config_path=args.config_path, max_steps=args.max_steps, device=args.device,
        log_dir=args.log_dir, pretrained_encoder=args.pretrained_encoder))
