"""Training-time probes, the factorization audit (port of
facodec_tpu/train/probes.py): decode every stream subset (prosody, content,
residual and their combinations) and a timbre swap, each sample in the next
sample's timbre, logged as TensorBoard audio so that disentanglement can be
judged by ear."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from facodec_tpu_torch.api import float32_exact

SUBSETS = {
    "prosody": (True, False, False),
    "content": (False, True, False),
    "residual": (False, False, True),
    "prosody+content": (True, True, False),
    "prosody+residual": (True, False, True),
    "full": (True, True, True),
}


def make_probe_fn(models: Mapping[str, nn.Module]):
    """Returns `probe(batch) -> {name: wave (B, Tw)}` over the models'
    current weights: one eval encode of the batch, then a decode of each
    stream subset and of the timbre swap, with no graph; the modules' train
    or eval mode is left as it was (no draw is made)."""
    encoder, quantizer, decoder = models["encoder"], models["quantizer"], models["decoder"]

    @torch.no_grad()
    def probe(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with float32_exact():
            z = encoder(batch["wave_seg"][:, :, None])
            _, _, timbre, (z_p, z_c, z_r) = quantizer.forward_v2(
                z, batch["wave_seg"], n_c=2, full_waves=batch["full_waves"],
                wave_lens=batch["wave_lens"], return_quantized=True)

            def decode(streams_sum, tvec):
                return decoder(quantizer._timbre_condition(streams_sum, tvec))[:, :, 0]

            out = {}
            for name, use in SUBSETS.items():
                s = torch.zeros_like(z_p)
                for part, on in zip((z_p, z_c, z_r), use):
                    if on:
                        s = s + part
                out[f"probe/{name}"] = decode(s, timbre)
            out["probe/timbre_swap"] = decode(z_p + z_c + z_r, torch.roll(timbre, 1, dims=0))
        out["probe/ground_truth"] = batch["wave_seg"]
        return out

    return probe


def log_probe_audio(log_writer, audio: Mapping[str, torch.Tensor], step: int,
                    sample_rate: int = 24000, max_items: int = 1) -> None:
    for name, wave in audio.items():
        w = wave.detach().cpu().numpy()
        for b in range(min(max_items, w.shape[0])):
            log_writer.add_audio(f"{name}/{b}", np.clip(w[b], -1, 1)[:, None], step,
                                 sample_rate=sample_rate)
