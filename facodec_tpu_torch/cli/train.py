"""`python -m facodec_tpu_torch train`: train the codec (train/loop.py).

    python -m facodec_tpu_torch train [--config-path config.yml] [--max-steps N]
        [--device cuda|cpu] [--log-dir DIR]

Without --config-path it trains `config.FLAGSHIP_TRAIN` with the JAX
loop's defaults on `PseudoDataset`; a config file (pyyaml) gives the model
and the loop's keys. Checkpoints go to --log-dir (else the config's
`log_dir`, else runs/facodec_tpu_torch), and a run resumes from the latest.
"""

from __future__ import annotations

import argparse

from facodec_tpu_torch.train.loop import run_training


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config-path", default=None,
                   help="reference-schema config.yml (needs pyyaml); default FLAGSHIP_TRAIN")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--log-dir", default=None)


def main(args: argparse.Namespace):
    state = run_training(config_path=args.config_path, max_steps=args.max_steps,
                         device=args.device, log_dir=args.log_dir)
    print(f"trained to step {state.step} (epoch {state.epoch}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(state.metrics.items())))
    return state
