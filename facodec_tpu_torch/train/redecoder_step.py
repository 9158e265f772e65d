"""Stage-2 (redecoder) GAN training step (port of
facodec_tpu/train/redecoder_step.py).

A frozen codec encoder and quantizer give each segment its prosody and
content codes and its timbre (`frozen_encode`: `forward_v2` in eval,
n_c = 2, the masked timbre over the full waves, no graph). The Redecoder
(train mode, its WN's dropout drawn from the step's generator) and the DAC
decoder make the wave, and they train against the discriminator on
mel * 15 + feature matching + adversarial; the multi-scale STFT and wave L1
losses are logged but are not in the loss. There are no predictor heads
and no teachers.

`make_redecoder_train_step` is the fused step:
  phase D: the discriminator loss on the fake without its gradient and the
           real wave, in two discriminator calls, as the JAX step makes
           them; the discriminator's update;
  phase G: the generator loss against the *updated* discriminator; one
           backward into the Redecoder and the decoder only; their updates.
`make_redecoder_train_step_split` runs the frozen encode once, as its own
phase, then phase D with its own generator forward without a graph, then
phase G with the forward again, with its graph, from the same generator
state, so that both forwards draw the same dropout masks. `remat=True`
recomputes the generator forward and both losses in the backward
(train/step.py); the JAX redecoder step has no such option, and the port
gives it the codec step's.

In a data-parallel step (a rank of a process group) the draws, the
gradient reduction and the metrics are the codec step's (train/step.py):
the one-process step of the global batch on every rank.

batch: wave_seg (B, Tw), full_waves (B, Tmax), wave_lens (B,).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn as nn

from facodec_tpu_torch.api import float32_exact
from facodec_tpu_torch.losses import (
    discriminator_loss, generator_adv_losses, l1_loss, mel_spectrogram_loss,
    multi_scale_stft_loss,
)
from facodec_tpu_torch.parallel.mesh import average_metrics, step_rows
from facodec_tpu_torch.train.optimizers import AdamW
from facodec_tpu_torch.train.step import (_no_mark, disc_update, gen_update, maybe_checkpoint,
                                          replay_checkpoint)

REDECODER_GEN_KEYS = ("encoder", "decoder")
LAMBDA_MEL = 15.0


@torch.no_grad()
def frozen_encode(codec_models: Mapping[str, nn.Module], batch: Mapping[str, torch.Tensor]):
    """(codes [p (B, 1, T), c (B, 2, T), r (B, 3, T)], timbre (B, D)) of the
    frozen codec, with no graph."""
    z = codec_models["encoder"](batch["wave_seg"][:, :, None])
    _, codes, timbre = codec_models["quantizer"].forward_v2(
        z, batch["wave_seg"], n_c=2, full_waves=batch["full_waves"],
        wave_lens=batch["wave_lens"])
    return codes, timbre


def redecoder_forward(models: Mapping[str, nn.Module], codes, timbre: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """The generator: Redecoder in train mode, then the decoder -> (B, Tw, 1)."""
    z = models["encoder"](codes[0], codes[1], timbre, train=True, generator=generator)
    return models["decoder"](z)


def redecoder_gen_loss(pred_wave: torch.Tensor, disc: nn.Module,
                       batch: Mapping[str, torch.Tensor]):
    """(mel * 15 + feature + adversarial, {loss/*: value}) against `disc`."""
    pw, rw = pred_wave[:, :, 0], batch["wave_seg"]
    mel_l = mel_spectrogram_loss(pw, rw)
    stft_l = multi_scale_stft_loss(pw, rw)
    wav_l = l1_loss(pw, rw)
    d_fake = disc(pred_wave)
    with torch.no_grad():  # the real wave's maps carry no generator gradient
        d_real = disc(rw[:, :, None])
    adv_l, feat_l = generator_adv_losses(d_fake, d_real)
    loss = mel_l * LAMBDA_MEL + feat_l + adv_l
    return loss, {"loss/gen_all": loss, "loss/mel": mel_l, "loss/stft": stft_l,
                  "loss/wav_l1": wav_l, "loss/adv_g": adv_l, "loss/feature": feat_l}


def _make_step(codec_models: Mapping[str, nn.Module], models: Mapping[str, nn.Module],
               optimizers: Mapping[str, AdamW], remat: bool, split: bool):
    disc = models["discriminator"]

    def disc_loss_fn(fake, real):
        return discriminator_loss(disc(fake), disc(real))

    def forward(codes, timbre, generator):
        if remat:
            return replay_checkpoint(lambda: redecoder_forward(models, codes, timbre, generator),
                                     generator)
        return redecoder_forward(models, codes, timbre, generator)

    def train_step(batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator],
                   mark: Optional[Callable[[str], None]] = None):
        mark = mark or _no_mark
        with float32_exact(), step_rows(batch["wave_seg"].shape[0]):
            codes, timbre = frozen_encode(codec_models, batch)
            mark("encode")
            real = batch["wave_seg"][:, :, None]
            if split:
                start = None if generator is None else generator.get_state()
                with torch.no_grad():
                    fake = redecoder_forward(models, codes, timbre, generator)
            else:
                pred_wave = forward(codes, timbre, generator)
                fake = pred_wave.detach()
                mark("forward")
            d_loss, d_grads, d_norm = disc_update(optimizers["discriminator"], disc_loss_fn,
                                                  fake, real, remat)
            del fake
            mark("disc")
            if split:
                if generator is not None:
                    generator.set_state(start)  # phase G draws phase D's masks
                pred_wave = forward(codes, timbre, generator)
                mark("forward")
            loss, metrics = maybe_checkpoint(remat, redecoder_gen_loss, pred_wave, disc, batch)
            mark("gen_loss")
            grads = gen_update(loss, optimizers, REDECODER_GEN_KEYS, metrics, mark)
            metrics["loss/disc"] = d_loss
            metrics["grad_norm/discriminator"] = d_norm
            metrics = average_metrics({k: v.detach() for k, v in metrics.items()})
        grads["discriminator"] = d_grads
        return metrics, grads

    return train_step


def make_redecoder_train_step(codec_models: Mapping[str, nn.Module],
                              models: Mapping[str, nn.Module], optimizers: Mapping[str, AdamW],
                              remat: bool = False):
    """codec_models: the frozen `encoder` and `quantizer`; models: `encoder`
    (the Redecoder), `decoder`, `discriminator`, with one AdamW each.
    Returns `train_step(batch, generator, mark=None) -> (metrics, grads)`,
    as the codec step does: metrics `loss/*` of the JAX step, `loss/disc`
    and `grad_norm/<module>` before the clip; marks "encode", "forward",
    "disc", "gen_loss", "backward", "update"."""
    return _make_step(codec_models, models, optimizers, remat, split=False)


def make_redecoder_train_step_split(codec_models: Mapping[str, nn.Module],
                                    models: Mapping[str, nn.Module],
                                    optimizers: Mapping[str, AdamW], remat: bool = False):
    """The split step (module docstring); marks "encode", "disc" (phase D
    with its own forward), "forward" (phase G's), "gen_loss", "backward",
    "update"."""
    return _make_step(codec_models, models, optimizers, remat, split=True)
