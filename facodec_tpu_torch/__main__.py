"""Command-line dispatcher of the port.

    python -m facodec_tpu_torch <command> [args]

  reconstruct   codec round trip on a wav
  encode        wav -> .fac code file
  decode        .fac -> wav
  convert       zero-shot voice conversion (codec + redecoder)
  stream        chunked streaming round trip, with its per-chunk latency
  serve         HTTP inference server (and, with --stream-port, live streams)

Each command runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys

from facodec_tpu_torch.cli import codec as codec_cli
from facodec_tpu_torch.cli import convert as convert_cli
from facodec_tpu_torch.cli import reconstruct as reconstruct_cli
from facodec_tpu_torch.cli import serve as serve_cli
from facodec_tpu_torch.cli import stream as stream_cli


def main(argv=None):
    parser = argparse.ArgumentParser(prog="facodec_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    reconstruct_cli.add_args(sub.add_parser("reconstruct"))
    convert_cli.add_args(sub.add_parser("convert"))
    codec_cli.add_encode_args(sub.add_parser("encode"))
    codec_cli.add_decode_args(sub.add_parser("decode"))
    stream_cli.add_args(sub.add_parser("stream"))
    serve_cli.add_args(sub.add_parser("serve"))
    commands = dict(reconstruct=reconstruct_cli.main, convert=convert_cli.main,
                    encode=codec_cli.main_encode, decode=codec_cli.main_decode,
                    stream=stream_cli.main, serve=serve_cli.main)
    args = parser.parse_args(argv)
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
