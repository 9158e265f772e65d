"""Export AOT artifacts on `torch.export` (utils/export.py).

    python -m facodec_tpu_torch export --out artifact/ [--config-path cfg.yml]
        [--ckpt-path x.pth] [--batch 1] [--seconds 10] [--precision hybrid]
        [--device cuda]

One artifact per (batch, seconds) signature, the bucketed-serving model of
cli/serve.py, exported on the device it will serve on (there is no
cross-export). Load it with `facodec_tpu_torch.utils.export.ExportedCodec`;
serve it with `python -m facodec_tpu_torch serve --artifact DIR --ckpt-path
CKPT`. The checkpoint only sets the weights traced through: the artifact
stores none, and takes any checkpoint of the same architecture.
The precisions are the JAX package's export choices; `export_codec` takes
`int8` too, and refuses `hybrid_int8` as the JAX package's does.
"""

from __future__ import annotations

import argparse


def add_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    from facodec_tpu_torch.cli import add_device_arg

    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--config-path", default=None,
                   help="reference-schema config.yml (needs pyyaml); default: the "
                        "published FLAGSHIP fields")
    p.add_argument("--ckpt-path", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--precision", default="hybrid",
                   choices=["float32", "hybrid", "bfloat16", "bfloat16_act"])
    add_device_arg(p)
    return p


def main(args) -> int:
    from facodec_tpu_torch.cli import load_codec
    from facodec_tpu_torch.utils.export import export_codec

    codec = load_codec(args.config_path, args.ckpt_path, 2, args.device, args.precision)
    report = export_codec(codec, args.out, batch=args.batch, seconds=args.seconds)
    for name, r in report.items():
        print(f"  {name}: {r['bytes'] / 1e6:.2f} MB, exported in {r['seconds']:.1f} s")
    print(f"artifact written to {args.out}")
    return 0
