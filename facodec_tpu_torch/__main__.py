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
  bench         one-card benchmarks, one JSON line each: `bench` or
                `bench roundtrip` (encode_decode_rtf, bench.py), `bench
                streaming` (streaming_chunk_p50_ms, bench_streaming.py),
                `bench train` (train_step_ms, bench_train.py)

Each command runs on the card unless given `--device cpu`. `train` and
`train-redecoder` run data-parallel over every visible GPU (one rank each,
started by the command, or by `torchrun`), and `serve --shard-inference`
serves over every visible GPU.
"""

from __future__ import annotations

import argparse
import sys

from facodec_tpu_torch import bench, bench_streaming, bench_train
from facodec_tpu_torch.cli import codec as codec_cli
from facodec_tpu_torch.cli import convert as convert_cli
from facodec_tpu_torch.cli import export_model as export_cli
from facodec_tpu_torch.cli import reconstruct as reconstruct_cli
from facodec_tpu_torch.cli import serve as serve_cli
from facodec_tpu_torch.cli import stream as stream_cli
from facodec_tpu_torch.cli import train as train_cli

BENCHES = {"roundtrip": bench, "streaming": bench_streaming, "train": bench_train}


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
    p_bench = sub.add_parser("bench")
    p_bench.add_argument("what", nargs="?", default="roundtrip", choices=tuple(BENCHES))
    for module in BENCHES.values():
        module.add_args(p_bench)
    commands = {"reconstruct": reconstruct_cli.main, "convert": convert_cli.main,
                "encode": codec_cli.main_encode, "decode": codec_cli.main_decode,
                "stream": stream_cli.main, "serve": serve_cli.main, "export": export_cli.main,
                "train": train_cli.main,
                "train-redecoder": train_cli.main_redecoder,
                "bench": lambda args: BENCHES[args.what].run(args)}
    args = parser.parse_args(argv)
    if args.command == "bench" and args.what != "roundtrip" and args.precision:
        parser.error(f"bench {args.what} runs float32; --precision is the round trip's")
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
