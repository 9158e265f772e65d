"""Command-line entry points (`python -m facodec_tpu_torch <command>`).

Each command builds its model from `--config-path` (the reference config.yml
schema; needs pyyaml) or, by default, from the published fields in
`facodec_tpu_torch.config`, with the weights of `--ckpt-path` (a torch
checkpoint) or seeded random ones, on `--device` (default `cuda`; it raises
where torch sees no CUDA device).
"""

from __future__ import annotations

import argparse
from typing import Optional

from facodec_tpu_torch.api import FACodec, FARedecoder
from facodec_tpu_torch.config import FLAGSHIP, FLAGSHIP_REDECODER


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cpu where there is no CUDA card)")


def load_codec(config_path: Optional[str], ckpt_path: Optional[str], n_c: int,
               device: str) -> FACodec:
    if config_path:
        return FACodec.from_config(config_path, ckpt_path, n_c=n_c, device=device)
    return FACodec.from_fields(FLAGSHIP, n_c=n_c, device=device, ckpt_path=ckpt_path)


def load_redecoder(config_path: Optional[str], ckpt_path: Optional[str],
                   device: str) -> FARedecoder:
    if config_path:
        return FARedecoder.from_config(config_path, ckpt_path, device=device)
    return FARedecoder.from_fields(FLAGSHIP_REDECODER, device=device, ckpt_path=ckpt_path)
