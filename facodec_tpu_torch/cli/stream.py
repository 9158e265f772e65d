"""Streaming reconstruction of a wav through the exact chunked session, the
real-time path, with its per-chunk latency (port of
facodec_tpu/cli/stream.py).

    python -m facodec_tpu_torch stream --source in.wav [--output out.wav]
        [--chunk-frames 16] [--n-c 2] [--timbre-from ref.wav]
        [--ckpt-path ckpt] [--config-path cfg] [--device cuda]

With --timbre-from the stream is conditioned on that utterance's timbre
(streaming zero-shot voice normalization); otherwise on the source's own,
from a first pass over it.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from facodec_tpu_torch.cli import add_device_arg, load_codec


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--source", type=str, required=True)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--ckpt-path", type=str, default=None)
    p.add_argument("--config-path", type=str, default=None)
    p.add_argument("--chunk-frames", type=int, default=16)
    p.add_argument("--n-c", type=int, default=2)
    p.add_argument("--timbre-from", type=str, default=None)
    add_device_arg(p)


def main(args: argparse.Namespace) -> str:
    import torch

    from facodec_tpu_torch.models.streaming import HOP, StreamingFACodec
    from facodec_tpu_torch.utils.audio import SR, load_wav, save_wav

    codec = load_codec(args.config_path, args.ckpt_path, args.n_c, args.device)
    wave = load_wav(args.source)
    step = args.chunk_frames * HOP
    T = len(wave) // step * step
    wave = wave[:T]

    timbre_src = load_wav(args.timbre_from) if args.timbre_from else wave
    timbre = torch.from_numpy(codec.timbre_of(timbre_src)).to(codec.device)

    sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder,
                            chunk_frames=args.chunk_frames, n_c=args.n_c)
    est, dst = sess.init_encode_state(1), sess.init_decode_state(1)
    w = torch.from_numpy(np.ascontiguousarray(wave))[None].to(codec.device)
    out, lat = [], []
    for i in range(0, T, step):
        t0 = time.perf_counter()
        # encode and decode in one call per chunk
        est, dst, y, _ = sess.roundtrip_chunk(est, dst, w[:, i : i + step], timbre)
        if y is None:  # small chunks buffer until the priming step
            continue
        y = y.cpu().numpy()  # the chunk's wave on the host, as a real-time consumer needs it
        lat.append(time.perf_counter() - t0)
        out.append(y)
    outs_t, _ = sess.flush_encode(est, timbre)
    dst, y = sess.decode_chunk(dst, outs_t)
    out.append(y.cpu().numpy())

    recon = np.concatenate(out, axis=1)[0]
    dst_path = args.output or os.path.join("reconstructed", "stream_" + os.path.basename(args.source))
    save_wav(dst_path, recon)
    warm = lat[2:] if len(lat) > 3 else lat
    print(f"{dst_path} (chunk {step / SR * 1e3:.0f} ms, p50 latency "
          f"{np.percentile(warm, 50) * 1e3:.1f} ms over {len(lat)} chunks)")
    return dst_path
