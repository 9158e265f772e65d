"""Continuous batching of concurrent live streams.

Port of facodec_tpu/models/stream_batch.py. A `BatchedStreamGroup` holds
`capacity` slots of stacked streaming state (encoder and decoder carries of
a `StreamingFACodec`), so that one masked batched step per tick advances
every live stream of one chunk size:

  * `join` primes a stream at batch 1 (the session's first step) and writes
    its state into a free slot;
  * `tick({slot: chunk})` runs one steady encode + decode step over the
    whole group; slots without a chunk (stragglers, free slots) keep their
    state bit for bit (`torch.where` along each leaf's batch axis);
  * `flush` takes one slot's state out for the stream's final
    (end-reflect) frame, and `leave` frees the slot.

Every op of the step is batch-parallel, so a slot's output depends only on
its own state, chunk and timbre row; it equals an independent batch-1
session to float tolerance (batched kernels may sum in another order).

Each leaf's batch axis is found structurally, from states built at batch 1
and 2: conv carries are (B, T, C) but the LSTM's are (layers, B, H).
Host-side object, not thread-safe by itself (cli/stream_serve.py's
dispatcher serializes it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from facodec_tpu_torch.api import float32_exact

HOP = 300


def tree_map(fn: Callable, tree, *rest):
    """fn over the tensors of nested dicts / tuples / lists of equal shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _batch_axes(small, big) -> Any:
    """Tree of per-leaf batch axes: the one axis whose size differs between
    the same state built at two batch sizes."""

    def axis(a, b):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diff) != 1:
            raise ValueError(f"cannot locate the batch axis: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        return diff[0]

    return tree_map(axis, small, big)


def _mask_merge(mask: torch.Tensor, new, old, axes):
    """new where mask (along each leaf's batch axis), else old, bit for bit."""

    def merge(n, o, ax):
        shape = [1] * n.ndim
        shape[ax] = mask.shape[0]
        return torch.where(mask.reshape(shape), n, o)

    return tree_map(merge, new, old, axes)


def _insert(group, one, slot: int, axes):
    """A copy of the stacked tree with the batch-1 tree `one` in `slot`."""

    def put(g, s, ax):
        g = g.clone()
        g.narrow(ax, slot, 1).copy_(s)
        return g

    return tree_map(put, group, one, axes)


def _extract(group, slot: int, axes):
    """The batch-1 tree of `slot`."""
    return tree_map(lambda g, ax: g.narrow(ax, slot, 1).clone(), group, axes)


class BatchedStreamGroup:
    """Up to `capacity` concurrent streams of one `StreamingFACodec` session
    (its chunk size), advanced by one batched step per tick."""

    def __init__(self, session, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sess = session
        self.capacity = B = capacity
        self._enc_axes = _batch_axes(session.init_encode_state(1).core,
                                     session.init_encode_state(2).core)
        self._dec_axes = _batch_axes(session.init_decode_state(1)[0],
                                     session.init_decode_state(2)[0])
        self.enc_core = session.init_encode_state(B).core
        self.dec_core = session.init_decode_state(B)[0]
        self.device = next(session.encoder.parameters()).device
        self.timbre = torch.zeros(B, session.quantizer.in_dim, device=self.device)
        self.active = np.zeros(B, bool)

    # ----------------------------------------------------------- membership
    def free_slots(self) -> int:
        return int(self.capacity - self.active.sum())

    def join(self, prime_wave: torch.Tensor, timbre: torch.Tensor
             ) -> Tuple[int, torch.Tensor, list]:
        """Admit a stream. prime_wave (1, prime_frames * HOP), the session's
        whole priming span; timbre (1, d). Returns (slot, first emission
        (1, (prime_frames - 1) * HOP), first codes)."""
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            raise RuntimeError("stream group full")
        slot = int(free[0])
        sess = self.sess
        est, outs, codes = sess.encode_chunk(sess.init_encode_state(1), prime_wave, timbre)
        if outs is None:
            raise ValueError(f"join needs the full priming span "
                             f"({sess.prime_frames * HOP} samples)")
        dst, wave = sess.decode_chunk(sess.init_decode_state(1), outs)
        self.enc_core = _insert(self.enc_core, est.core, slot, self._enc_axes)
        self.dec_core = _insert(self.dec_core, dst[0], slot, self._dec_axes)
        self.timbre[slot] = timbre[0]
        self.active[slot] = True
        return slot, wave, codes

    def leave(self, slot: int) -> None:
        self.active[slot] = False

    # ----------------------------------------------------------- advancing
    @torch.no_grad()
    def tick(self, chunks: Dict[int, np.ndarray], with_codes: bool = False):
        """Advance every slot in `chunks` ({slot: (chunk_frames * HOP,)
        wave}) by one batched step; the other slots keep their state.
        Returns {slot: (chunk_frames * HOP,) output wave} and, with
        `with_codes`, also {slot: [codes_p, codes_c, codes_r]}, each
        (n, chunk_frames) numpy."""
        if not chunks:
            return ({}, {}) if with_codes else {}
        B, step = self.capacity, self.sess.chunk_frames * HOP
        waves = np.zeros((B, step), np.float32)
        mask = np.zeros(B, bool)
        for slot, w in chunks.items():
            if not self.active[slot]:
                raise ValueError(f"slot {slot} is not active")
            waves[slot] = np.asarray(w, np.float32).reshape(step)
            mask[slot] = True
        sess = self.sess
        with float32_exact():
            outs, codes, enc = sess._encode_step(torch.from_numpy(waves).to(self.device),
                                                 self.timbre, self.enc_core, False)
            wave, dec = sess._decode_step(outs, self.dec_core, False)
        m = torch.from_numpy(mask).to(self.device)
        self.enc_core = _mask_merge(m, enc, self.enc_core, self._enc_axes)
        self.dec_core = _mask_merge(m, dec, self.dec_core, self._dec_axes)
        out = wave.cpu().numpy()
        waves_out = {slot: out[slot] for slot in chunks}
        if not with_codes:
            return waves_out
        codes = [c.cpu().numpy() for c in codes]
        return waves_out, {slot: [c[slot] for c in codes] for slot in chunks}

    @torch.no_grad()
    def flush(self, slot: int) -> np.ndarray:
        """The stream's final (end-reflect) frame, (HOP,) wave. Does not
        advance or free the slot (call `leave` after)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        sess = self.sess
        enc1 = _extract(self.enc_core, slot, self._enc_axes)
        dec1 = _extract(self.dec_core, slot, self._dec_axes)
        with float32_exact():
            outs_t, _ = sess._flush_step(self.timbre[slot : slot + 1], enc1)
            wave_t, _ = sess._decode_step(outs_t, dec1, False)
        return wave_t.cpu().numpy()[0]
