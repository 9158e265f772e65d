"""Offline data assembly (port of facodec_tpu/cli/assemble_data.py): keep
the transcript rows whose wav exists and lasts min-s to max-s seconds (1 to
60 by default), shuffle them with a seeded `random.Random`, and split them
90/10 into `train.txt` and `val.txt` in the target directory.

Manifest row: `path\\tsid\\tlang\\ttext\\tphones`.

    python -m facodec_tpu_torch.cli.assemble_data --transcripts a.txt b.txt
        --target-dir ./data [--min-s 1] [--max-s 60] [--val-frac 0.1] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import random


def wav_duration_s(path: str) -> float:
    """Duration from the header's frame count, the samples memory-mapped,
    not decoded."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path, mmap=True)
    return data.shape[0] / sr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="facodec_tpu_torch.cli.assemble_data")
    p.add_argument("--transcripts", type=str, nargs="+", required=True)
    p.add_argument("--target-dir", type=str, default="./data")
    p.add_argument("--min-s", type=float, default=1.0)
    p.add_argument("--max-s", type=float, default=60.0)
    p.add_argument("--val-frac", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    raw = []
    for t in args.transcripts:
        with open(t, encoding="utf-8") as f:
            raw += f.readlines()

    clean = []
    for line in raw:
        parts = line.rstrip("\n").split("\t")
        if not parts or not parts[0] or not os.path.exists(parts[0]):
            continue
        try:
            dur = wav_duration_s(parts[0])
        except Exception:  # not a wav scipy reads: the row is left out, as in JAX
            continue
        if args.min_s <= dur <= args.max_s:
            clean.append(line if line.endswith("\n") else line + "\n")

    random.Random(args.seed).shuffle(clean)
    n_train = int(len(clean) * (1.0 - args.val_frac))
    os.makedirs(args.target_dir, exist_ok=True)
    with open(os.path.join(args.target_dir, "train.txt"), "w", encoding="utf-8") as f:
        f.writelines(clean[:n_train])
    with open(os.path.join(args.target_dir, "val.txt"), "w", encoding="utf-8") as f:
        f.writelines(clean[n_train:])
    print(f"[assemble_data] {n_train} train / {len(clean) - n_train} val")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
