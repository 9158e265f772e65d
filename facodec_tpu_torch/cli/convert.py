"""Zero-shot voice conversion of a wav file (port of
facodec_tpu/cli/convert.py).

    python -m facodec_tpu_torch convert --source src.wav --target tgt.wav
        [--output out.wav] [--codec-ckpt ...] [--redecoder-ckpt ...]
        [--codec-config ...] [--redecoder-config ...] [--device cuda]

`--use-p-code` is accepted and has no effect, as in facodec_tpu/cli/convert.py:
the conversion feeds the content codes only.
"""

from __future__ import annotations

import argparse
import os

from facodec_tpu_torch.cli import add_device_arg, load_codec, load_redecoder


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--source", type=str, required=True)
    p.add_argument("--target", type=str, required=True)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--codec-ckpt", type=str, default=None)
    p.add_argument("--redecoder-ckpt", type=str, default=None)
    p.add_argument("--codec-config", type=str, default=None)
    p.add_argument("--redecoder-config", type=str, default=None)
    p.add_argument("--use-p-code", action="store_true",
                   help="accepted for the JAX CLI's command line; has no effect")
    add_device_arg(p)


def main(args: argparse.Namespace) -> str:
    from facodec_tpu_torch.api import convert_voice
    from facodec_tpu_torch.utils.audio import load_wav, save_wav

    codec = load_codec(args.codec_config, args.codec_ckpt, 1, args.device)
    red = load_redecoder(args.redecoder_config, args.redecoder_ckpt, args.device)
    src = load_wav(args.source)
    tgt = load_wav(args.target)
    converted = convert_voice(codec, red, src, tgt)
    s = os.path.splitext(os.path.basename(args.source))[0]
    t = os.path.splitext(os.path.basename(args.target))[0]
    out = args.output or os.path.join("converted", f"vc_{s}_{t}.wav")
    save_wav(out, converted)
    print(out)
    return out
