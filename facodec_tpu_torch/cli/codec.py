"""encode / decode between wav files and `.fac` code files (port of
facodec_tpu/cli/codec.py).

    python -m facodec_tpu_torch encode --input in.wav [--output out.fac]
        [--no-normalize] [--normalize-db -16] [--n-c 2]
        [--streaming-threshold 30] [--chunk-frames 80] [--device cuda]
    python -m facodec_tpu_torch decode --input in.fac [--output out.wav]
        [--no-residual] [--no-restore-loudness] [--streaming-threshold 30]
        [--chunk-frames 80] [--device cuda]

As in the reference's compress path, the input is loudness-normalized to
-16 dB LUFS before encoding; the measured input loudness rides in the `.fac`
header as `input_db`, and decode restores it. Inputs longer than
--streaming-threshold seconds go through the exact bounded-memory streaming
route (`FACodec.encode_streaming` / `decode_streaming`), as in the JAX CLI:
the codes equal the one-shot encoder's, and the timbre is taken from the
first 10 s.
"""

from __future__ import annotations

import argparse
import os

from facodec_tpu_torch.cli import add_device_arg, load_codec


def _model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--ckpt-path", type=str, default=None)
    p.add_argument("--config-path", type=str, default=None)


def _streaming_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--streaming-threshold", type=float, default=30.0,
                   help="inputs longer than this many seconds take the bounded-memory "
                        "streaming route")
    p.add_argument("--chunk-frames", type=int, default=80,
                   help="streaming route's chunk size in latent frames")


def add_encode_args(p: argparse.ArgumentParser) -> None:
    _model_args(p)
    p.add_argument("--n-c", type=int, default=2)
    p.add_argument("--normalize-db", type=float, default=-16.0,
                   help="loudness-normalize the input to this LUFS before encoding")
    p.add_argument("--no-normalize", action="store_true")
    _streaming_args(p)
    add_device_arg(p)


def add_decode_args(p: argparse.ArgumentParser) -> None:
    _model_args(p)
    p.add_argument("--no-residual", action="store_true",
                   help="decode from prosody + content only (lower bitrate)")
    p.add_argument("--no-restore-loudness", action="store_true")
    _streaming_args(p)
    add_device_arg(p)


def main_encode(args: argparse.Namespace) -> str:
    import numpy as np

    from facodec_tpu_torch.api import SR
    from facodec_tpu_torch.ops.loudness import normalize_loudness
    from facodec_tpu_torch.utils.audio import load_wav

    codec = load_codec(args.config_path, args.ckpt_path, args.n_c, args.device)
    wave = load_wav(args.input)
    input_db = None
    if not args.no_normalize:
        wave, input_db = normalize_loudness(wave, SR, args.normalize_db)
    if len(wave) / SR > args.streaming_threshold:
        f = codec.encode_streaming(wave, chunk_frames=args.chunk_frames)
    else:
        f = codec.encode(wave)
    if input_db is not None and np.isfinite(input_db):
        f.metadata["input_db"] = float(input_db)
    out = args.output or os.path.splitext(args.input)[0] + ".fac"
    out = f.save(out)
    n_books = f.codes_p.shape[1] + f.codes_c.shape[1] + (
        f.codes_r.shape[1] if f.codes_r is not None else 0)
    kbps = n_books * 10 * (f.sample_rate / f.hop_length) / 1000.0
    print(f"{out} ({kbps:.1f} kbps + timbre)")
    return out


def main_decode(args: argparse.Namespace) -> str:
    from facodec_tpu_torch.codec_file import FACodecFile
    from facodec_tpu_torch.ops.loudness import normalize_loudness
    from facodec_tpu_torch.utils.audio import save_wav

    codec = load_codec(args.config_path, args.ckpt_path, 2, args.device)
    f = FACodecFile.load(args.input)
    if f.codes_p.shape[-1] * f.hop_length / f.sample_rate > args.streaming_threshold:
        wave = codec.decode_streaming(f, use_residual=not args.no_residual,
                                      chunk_frames=args.chunk_frames)
    else:
        wave = codec.decode(f, use_residual=not args.no_residual)
    input_db = f.metadata.get("input_db")
    if input_db is not None and not args.no_restore_loudness:
        # restore the loudness the input had before normalization
        wave_r, _ = normalize_loudness(wave[0], f.sample_rate, float(input_db))
        wave = wave_r[None]
    out = args.output or os.path.splitext(args.input)[0] + ".decoded.wav"
    save_wav(out, wave, f.sample_rate)
    print(out)
    return out
