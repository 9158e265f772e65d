"""Host-side training data pipeline (port of facodec_tpu/train/data.py).

numpy copies of the JAX pipeline: `PseudoDataset` (random 1-30 s noise
utterances with random teacher targets, drawn from numpy's generator of its
seed as the JAX one draws them), `FileListDataset` (manifest rows
`path\\tsid\\t...` with optional `<wav>.targets.npz` teacher targets),
`collate` (sorted by length, zero-padded, frame counts bucketed),
`shard_iterator` (a rank's slice of a shuffled order), `prefetch` (a
background thread that prepares batches ahead) and `segment_batch` (one
random fixed-length crop per utterance). The data order and the crops draw
from torch.Generators seeded by the caller. `compute_mel` is the port's
own log-mel (ops/spectral.py) on the CPU.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from facodec_tpu_torch.ops.spectral import LogMelSpectrogram
from facodec_tpu_torch.utils.audio import load_wav

SR = 24000
HOP = 300
MAX_FRAMES = 80


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = SR
    hop_length: int = HOP
    n_mels: int = 80


@functools.lru_cache(maxsize=4)
def _log_mel(sample_rate: int, hop_length: int) -> LogMelSpectrogram:
    return LogMelSpectrogram(sample_rate, hop_length)


def compute_mel(wave: np.ndarray, cfg: MelConfig = MelConfig()) -> np.ndarray:
    """(T,) wave -> (T // hop, 80) normalised log-mel, float32 numpy."""
    with torch.no_grad():
        mel = _log_mel(cfg.sample_rate, cfg.hop_length)(
            torch.from_numpy(np.asarray(wave, np.float32))[None])
    return mel[0, : len(wave) // cfg.hop_length, : cfg.n_mels].numpy()


class PseudoDataset:
    """Random-noise utterances with random teacher targets."""

    def __init__(self, length: int = 100, seed: int = 0, min_s: float = 1.0,
                 max_s: float = 30.0, cfg: MelConfig = MelConfig(),
                 n_phones: int = 1024, n_speakers: int = 20000):
        self.length, self.cfg = length, cfg
        self.rng = np.random.default_rng(seed)
        self.min_s, self.max_s = min_s, max_s
        self.n_phones, self.n_speakers = n_phones, n_speakers

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        dur = self.rng.uniform(self.min_s, self.max_s)
        hop = self.cfg.hop_length
        T = int(dur * self.cfg.sample_rate) // hop * hop
        wave = (self.rng.standard_normal(T) * 0.05).astype(np.float32)
        frames = T // hop
        return dict(
            wave=wave, mel=compute_mel(wave, self.cfg),
            f0=np.abs(self.rng.standard_normal(frames)).astype(np.float32) * 200.0,
            phone_ids=self.rng.integers(0, self.n_phones, frames).astype(np.int32),
            spk_label=np.int32(self.rng.integers(0, self.n_speakers)),
        )


class FileListDataset:
    """Manifest rows `path\\tsid\\tlang\\ttext\\tphones`; teacher targets from
    `<wav>.targets.npz` (f0, phone_ids, spk_label) where present, else zeros
    and the row's speaker id."""

    def __init__(self, manifest: str, root: str = "", cfg: MelConfig = MelConfig()):
        self.cfg = cfg
        self.rows: List[Tuple[str, int]] = []
        with open(manifest) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if not parts or not parts[0]:
                    continue
                path = os.path.join(root, parts[0]) if root else parts[0]
                sid = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
                self.rows.append((path, sid))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path, sid = self.rows[idx]
        hop = self.cfg.hop_length
        wave = load_wav(path, self.cfg.sample_rate)
        wave = wave[: len(wave) // hop * hop]
        frames = len(wave) // hop
        tgt_path = path + ".targets.npz"
        if os.path.exists(tgt_path):
            tgt = np.load(tgt_path)
            f0 = tgt["f0"][:frames].astype(np.float32)
            phone_ids = tgt["phone_ids"][:frames].astype(np.int32)
            spk = np.int32(tgt["spk_label"])
        else:
            f0 = np.zeros(frames, np.float32)
            phone_ids = np.zeros(frames, np.int32)
            spk = np.int32(sid % 20000)
        return dict(wave=wave, mel=compute_mel(wave, self.cfg), f0=f0, phone_ids=phone_ids,
                    spk_label=spk)


def collate(items: Sequence[Dict[str, np.ndarray]],
            bucket_frames: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Zero-pad utterances sorted by length, longest first. `bucket_frames`
    rounds the padded frame count up to a multiple (the waves to that many
    hops), as the JAX pipeline does to keep its compiled shapes few."""
    items = sorted(items, key=lambda d: len(d["wave"]), reverse=True)
    B = len(items)
    max_T = max(len(d["wave"]) for d in items)
    max_F = max(d["mel"].shape[0] for d in items)
    if bucket_frames:
        frames = max(-(-max_T // HOP), max_F)
        max_F = -(-frames // bucket_frames) * bucket_frames
        max_T = max_F * HOP
    n_mels = items[0]["mel"].shape[1]
    waves = np.zeros((B, max_T), np.float32)
    mels = np.zeros((B, max_F, n_mels), np.float32)
    f0 = np.zeros((B, max_F), np.float32)
    phone_ids = np.zeros((B, max_F), np.int32)
    spk = np.zeros(B, np.int32)
    wave_lens = np.zeros(B, np.int32)
    mel_lens = np.zeros(B, np.int32)
    for i, d in enumerate(items):
        T, F = len(d["wave"]), d["mel"].shape[0]
        waves[i, :T] = d["wave"]
        mels[i, :F] = d["mel"]
        f0[i, :F] = d["f0"][:F]
        phone_ids[i, :F] = d["phone_ids"][:F]
        spk[i] = d["spk_label"]
        wave_lens[i], mel_lens[i] = T, F
    return dict(waves=waves, mels=mels, f0=f0, phone_ids=phone_ids, spk_labels=spk,
                wave_lens=wave_lens, mel_lens=mel_lens)


def shard_iterator(dataset, batch_size: int, rank: int = 0, world_size: int = 1,
                   seed: int = 114514, shuffle: bool = True, epoch: int = 0,
                   bucket_frames: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Collated batches of this rank's slice of the dataset; the order is a
    permutation drawn from a generator seeded with seed + epoch."""
    order = np.arange(len(dataset))
    if shuffle:
        gen = torch.Generator().manual_seed(seed + epoch)
        order = torch.randperm(len(dataset), generator=gen).numpy()
    order = order[rank::world_size]
    for i in range(0, len(order) - batch_size + 1, batch_size):
        yield collate([dataset[int(j)] for j in order[i: i + batch_size]],
                      bucket_frames=bucket_frames)


def prefetch(iterator: Iterator, prepare, depth: int = 2) -> Iterator:
    """`prepare(item)` for the next `depth` items on one background thread,
    so that the host prepares batch N + 1 while the card runs step N. One
    worker keeps `prepare`'s draws in iteration order; an exception in the
    worker is raised at the consumer. depth <= 0 prepares in line."""
    if depth <= 0:
        for item in iterator:
            yield prepare(item)
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def _put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if stop.is_set() or not _put(prepare(item)):
                    return
        except BaseException as e:
            _put(e)
            return
        _put(done)

    t = threading.Thread(target=worker, daemon=True, name="facodec-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def segment_batch(batch: Dict[str, np.ndarray], max_frames: int = MAX_FRAMES, hop: int = HOP,
                  generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
    """One random crop of min(min(mel_lens), max_frames) frames per
    utterance, start drawn from `generator`; the train step's batch."""
    mel_lens = batch["mel_lens"]
    seg = int(min(mel_lens.min(), max_frames))
    B = len(mel_lens)
    wave_seg = np.zeros((B, seg * hop), np.float32)
    mel_seg = np.zeros((B, seg, batch["mels"].shape[-1]), np.float32)
    f0 = np.zeros((B, seg), np.float32)
    phone_ids = np.zeros((B, seg), np.int32)
    for i in range(B):
        L = int(mel_lens[i])
        start = 0
        if L > seg:
            if generator is None:
                raise ValueError("segment_batch draws its crops from a torch.Generator; pass one")
            start = int(torch.randint(0, L - seg, (1,), generator=generator))
        mel_seg[i] = batch["mels"][i, start: start + seg]
        f0[i] = batch["f0"][i, start: start + seg]
        phone_ids[i] = batch["phone_ids"][i, start: start + seg]
        wave_seg[i] = batch["waves"][i, start * hop: (start + seg) * hop]
    return dict(wave_seg=wave_seg, mel_seg=mel_seg, f0=f0, phone_ids=phone_ids,
                spk_labels=batch["spk_labels"], full_waves=batch["waves"],
                wave_lens=batch["wave_lens"])


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device`; to a card from pinned memory,
    without a host wait."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
