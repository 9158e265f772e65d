"""`python -m facodec_tpu_torch validate`: the parity gate of a checkpoint
(port of facodec_tpu/cli/validate.py's harness).

Runs the codec round trip of a checkpoint on a test wave and holds it to a
stored golden of the reference's outputs: bit-exact factorized codes and a
mel-L1 of the reconstruction within `--mel-threshold` (1e-3 by default,
BASELINE.json's north star).

    python -m facodec_tpu_torch validate --ckpt pytorch_model.bin --config config.yml \\
        --golden golden.npz [--wav x.wav | --seconds 2.0] [--device cuda|cpu]

The flags, the one JSON line and the exit codes are the JAX command's:
  {"codes_bit_exact", "mel_l1", "mel_l1_threshold", "timbre_max_abs_diff",
   "source", "ckpt", "pass"}
exit 0 = parity holds, 1 = parity broken, 3 = nothing to compare against.

The test wave is `--wav` (through `utils/audio.load_wav`) or the JAX
command's deterministic chirp of `--seconds`, cut to a multiple of the
300-sample hop. The golden is an .npz of `codes_p`, `codes_c`, `codes_r`,
`timbre` and `recon` (the JAX command's `--emit-golden` layout). The
mel-L1 is the mean absolute difference of the 80-bin normalised log-mel
(`ops/spectral.py`, the training front end) of the two reconstructions
over their common frames. The codec runs on `--device` (the card unless
the CPU is asked for) in float32 with TF32 off, as every `FACodec` call
does; `--config` is a reference-schema config.yml (pyyaml), or the same
schema as .json where pyyaml is not installed.

Departures from the JAX command: it downloads nothing (without `--ckpt`
and `--config` it prints the error line and exits 3, as the JAX command
does where the HF download is unavailable), and it has no live route
through the torch reference checkout and no `--emit-golden` (both need
that checkout, which the port does not read: they print the JAX command's
error line and exit 3). `--reference-dir` is accepted for the JAX
command's command line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from facodec_tpu_torch.cli import add_device_arg

MEL_L1_THRESHOLD = 1e-3
HOP = 300
SR = 24000


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ckpt", type=str, default="",
                   help="torch checkpoint (.bin/.pth) of encoder, quantizer and decoder")
    p.add_argument("--config", type=str, default="",
                   help="model config (reference schema, .yml, or .json without pyyaml)")
    p.add_argument("--wav", type=str, default="",
                   help="24 kHz test wav; empty = deterministic synthetic chirp")
    p.add_argument("--golden", type=str, default="",
                   help="stored reference golden .npz to compare against")
    p.add_argument("--emit-golden", type=str, default="",
                   help="needs the torch reference checkout, which the port does not read: "
                        "exits 3")
    p.add_argument("--reference-dir", type=str, default="",
                   help="accepted for the JAX command's command line; not read")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--mel-threshold", type=float, default=MEL_L1_THRESHOLD,
                   help="mel-L1 pass threshold (BASELINE.json north star)")
    add_device_arg(p)


def _test_wave(path: str, seconds: float) -> np.ndarray:
    """`path` through `load_wav`, or the deterministic multi-tone chirp of
    `seconds` (pitch movement and energy), cut to a multiple of the hop: a
    copy of the JAX command's `_test_wave`."""
    if path:
        from facodec_tpu_torch.utils.audio import load_wav

        w = load_wav(path)
    else:
        t = np.arange(int(seconds * SR)) / SR
        w = (0.4 * np.sin(2 * np.pi * (150 + 80 * t) * t)
             + 0.2 * np.sin(2 * np.pi * 420 * t)).astype(np.float32)
        w *= np.exp(-0.5 * ((t - t[-1] / 2) / (t[-1] / 3)) ** 2).astype(np.float32)
    n = len(w) // HOP * HOP
    return np.asarray(w[:n], np.float32)


def mel_l1(a: np.ndarray, b: np.ndarray) -> float:
    """L1 over the 80-bin normalised log-mel of (B, T) waves, on the CPU in
    float32, over the frames both have."""
    from facodec_tpu_torch.ops.spectral import LogMelSpectrogram

    mel = LogMelSpectrogram()
    with torch.no_grad():
        ma = mel(torch.from_numpy(np.asarray(a, np.float32)))
        mb = mel(torch.from_numpy(np.asarray(b, np.float32)))
    n = min(ma.shape[1], mb.shape[1])
    return float(torch.mean(torch.abs(ma[:, :n] - mb[:, :n])))


def _fail(error: str) -> int:
    print(json.dumps({"pass": False, "error": error}))
    return 3


def main(args: argparse.Namespace) -> int:
    wave = _test_wave(args.wav, args.seconds)
    if not (args.ckpt and args.config):
        print("[validate] no HF download in the port; pass --ckpt/--config explicitly",
              file=sys.stderr)
        return _fail("no checkpoint available")
    if args.emit_golden:
        print("[validate] the golden is the torch reference's; the port does not run it",
              file=sys.stderr)
        return _fail("torch reference unavailable for golden")
    if not args.golden:
        print("[validate] the live torch-reference route is not ported; pass --golden",
              file=sys.stderr)
        return _fail("no comparison source: provide --golden (from --emit-golden on a torch "
                     "machine) or --reference-dir")
    ref = dict(np.load(args.golden))

    from facodec_tpu_torch.api import FACodec

    codec = FACodec.from_config(args.config, args.ckpt, n_c=2, device=args.device)
    f = codec.encode(wave[None])
    recon = codec.reconstruct(wave[None])

    codes_ok = all(np.array_equal(np.asarray(getattr(f, k), np.int64),
                                  np.asarray(ref[k], np.int64))
                   for k in ("codes_p", "codes_c", "codes_r"))
    n = min(recon.shape[-1], ref["recon"].shape[-1])
    l1 = mel_l1(recon[:, :n], ref["recon"][:, :n])
    timbre_md = float(np.max(np.abs(f.timbre - ref["timbre"])))
    threshold = args.mel_threshold
    ok = bool(codes_ok and l1 <= threshold)
    print(json.dumps({
        "codes_bit_exact": bool(codes_ok),
        "mel_l1": round(l1, 8),
        "mel_l1_threshold": threshold,
        "timbre_max_abs_diff": round(timbre_md, 8),
        "source": "golden-file",
        "ckpt": args.ckpt,
        "pass": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m facodec_tpu_torch.cli.validate")
    add_args(parser)
    raise SystemExit(main(parser.parse_args()))
