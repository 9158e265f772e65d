"""Command-line dispatcher of the port.

    python -m facodec_tpu_torch <command> [args]

  reconstruct   codec round trip on a wav
  encode        wav -> .fac code file
  decode        .fac -> wav
  convert       zero-shot voice conversion (codec + redecoder)
  stream        chunked streaming round trip, with its per-chunk latency
  serve         HTTP inference server (and, with --stream-port, live streams;
                with --artifact, from an exported artifact)
  export        AOT artifacts of the codec's functions (torch.export)
  train         codec GAN training, resuming from the latest checkpoint
  train-redecoder
                redecoder GAN training against a frozen codec (stage 2),
                resuming from the latest checkpoint

Each command runs on the card unless given `--device cpu`. `train` and
`train-redecoder` run data-parallel over every visible GPU (one rank each,
started by the command, or by `torchrun`), and `serve --shard-inference`
serves over every visible GPU.
"""

from __future__ import annotations

import argparse
import sys

from facodec_tpu_torch.cli import codec as codec_cli
from facodec_tpu_torch.cli import convert as convert_cli
from facodec_tpu_torch.cli import export_model as export_cli
from facodec_tpu_torch.cli import reconstruct as reconstruct_cli
from facodec_tpu_torch.cli import serve as serve_cli
from facodec_tpu_torch.cli import stream as stream_cli
from facodec_tpu_torch.cli import train as train_cli


def main(argv=None):
    parser = argparse.ArgumentParser(prog="facodec_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    reconstruct_cli.add_args(sub.add_parser("reconstruct"))
    convert_cli.add_args(sub.add_parser("convert"))
    codec_cli.add_encode_args(sub.add_parser("encode"))
    codec_cli.add_decode_args(sub.add_parser("decode"))
    stream_cli.add_args(sub.add_parser("stream"))
    serve_cli.add_args(sub.add_parser("serve"))
    export_cli.add_args(sub.add_parser("export"))
    train_cli.add_args(sub.add_parser("train"))
    train_cli.add_redecoder_args(sub.add_parser("train-redecoder"))
    commands = {"reconstruct": reconstruct_cli.main, "convert": convert_cli.main,
                "encode": codec_cli.main_encode, "decode": codec_cli.main_decode,
                "stream": stream_cli.main, "serve": serve_cli.main, "export": export_cli.main,
                "train": train_cli.main,
                "train-redecoder": train_cli.main_redecoder}
    args = parser.parse_args(argv)
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
