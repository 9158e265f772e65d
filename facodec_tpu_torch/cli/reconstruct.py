"""Codec round trip on a wav file (port of facodec_tpu/cli/reconstruct.py).

    python -m facodec_tpu_torch reconstruct --source in.wav [--output out.wav]
        [--ckpt-path ckpt] [--config-path cfg] [--n-c 2] [--max-seconds 30]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os

from facodec_tpu_torch.cli import add_device_arg, load_codec


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--source", type=str, required=True)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--ckpt-path", type=str, default=None)
    p.add_argument("--config-path", type=str, default=None)
    p.add_argument("--n-c", type=int, default=2)
    p.add_argument("--max-seconds", type=float, default=30.0,
                   help="crop the input to this many seconds, as the reference does")
    add_device_arg(p)


def main(args: argparse.Namespace) -> str:
    from facodec_tpu_torch.api import SR
    from facodec_tpu_torch.utils.audio import load_wav, save_wav

    codec = load_codec(args.config_path, args.ckpt_path, args.n_c, args.device)
    wave = load_wav(args.source)
    wave = wave[: int(args.max_seconds * SR)]
    recon = codec.reconstruct(wave)
    out = args.output or os.path.join("reconstructed", os.path.basename(args.source))
    save_wav(out, recon)
    print(out)
    return out
