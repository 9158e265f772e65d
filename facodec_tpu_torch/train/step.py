"""The codec GAN training step (port of facodec_tpu/train/step.py,
`make_codec_train_step` and `make_codec_train_step_split`).

The fused step runs one generator forward and keeps its autograd graph for
the whole step:

  phase D: the discriminator loss on one pass over concat(fake without its
           gradient, real), then the discriminator's update;
  phase G: spectral losses, and the adversarial and feature-matching
           losses against the *updated* discriminator (a call on the fake
           and one on the real wave, as the fused JAX step makes them), the
           predictor losses with their gradient-reversal branches, the VQ
           losses; one backward into the four generator modules only (the
           discriminator's gradients from phase G are not taken), then
           their updates.

The split step has the same phases, but phase D runs its own generator
forward without a graph, and phase G runs the generator forward again, with
its graph, against the updated discriminator, with one discriminator pass
over concat(fake, real) (JAX's `paired_g`). Both forwards draw the same
dropout masks, as the JAX split step's two phases take the same key: the
step saves its generator's state before phase D and restores it before
phase G.

`remat=True` recomputes in the backward what the forward would store, as
`jax.checkpoint` does: the generator forward, the discriminator loss and
phase G's loss run under `torch.utils.checkpoint` (non-reentrant).
`checkpoint` replays only torch's global RNG, and every draw here comes
from an explicit generator, so `replay_checkpoint` sets the generator back
to the state the first run started from for the recompute (and restores it
after): the recompute draws the very masks the forward drew. The kernels'
custom ops run again inside the recompute.

The loss weights are the reference's. The step runs in float32 with TF32
off (`api.float32_exact`), as the codec's calls do; bfloat16 training is not
ported and raises (ROADMAP Queue 1, item 10). Teacher targets (phones,
speaker) come in the batch, and so does F0 unless an `f0_teacher` is given:
a `models.jdc.JDCNet` (in eval, frozen) that the step runs on
`batch["mel_seg"]` under `torch.no_grad()` before anything else, as the
JAX step runs its teacher inline (the reference's semantics). It is outside
every `remat` checkpoint and every optimizer, and its F0 replaces
`batch["f0"]` for the step's losses; with a `mark`, its part is "teacher".

Data parallelism: where this process is a rank of a process group
(parallel/mesh.py), the batch is its rows of a global batch of equal
shares; the step draws every mask for the global batch and keeps its rows,
reduces each gradient over the ranks before the update that clips it (a
None gradient as zeros), and returns the metrics averaged over the ranks,
so every rank makes the one-process step's update of the global batch. In
one plain process nothing is reduced.

batch (tensors on the models' device, fixed shapes):
  wave_seg (B, Tw), mel_seg (B, F, 80), f0 (B, F) (not read with a
  teacher), phone_ids (B, F), spk_labels (B,), full_waves (B, Tmax),
  wave_lens (B,).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from facodec_tpu_torch.api import float32_exact
from facodec_tpu_torch.ops.precision import INT8_POLICIES
from facodec_tpu_torch.losses import (
    cross_entropy, discriminator_loss, focal_loss, generator_adv_losses, l1_loss, log_norm,
    mel_spectrogram_loss, multi_scale_stft_loss, smooth_l1_loss,
)
from facodec_tpu_torch.parallel.mesh import average_metrics, reduce_gradients, step_rows
from facodec_tpu_torch.train.optimizers import GEN_KEYS, AdamW
from facodec_tpu_torch.train.targets import normalize_f0

# loss weights hard-coded by the reference
LAMBDA_MEL = 15.0
LAMBDA_FEAT = 1.0
LAMBDA_ADV = 1.0
LAMBDA_COMMIT = 0.25
LAMBDA_CODEBOOK = 1.0
LAMBDA_F0 = 1.0
LAMBDA_UV = 1.0
LAMBDA_CONTENT = 5.0
LAMBDA_SPK = 1.0


def replay_checkpoint(fn: Callable, generator: Optional[torch.Generator]):
    """fn() under non-reentrant `checkpoint`, whose recompute draws from
    `generator` what the first run drew: it starts from the state the first
    run started from and leaves the generator as it found it."""
    if generator is None:
        return checkpoint(fn, use_reentrant=False, preserve_rng_state=False)
    start = generator.get_state()
    runs = []

    def body():
        found = generator.get_state()
        generator.set_state(start)
        out = fn()
        if runs:  # a recompute
            generator.set_state(found)
        runs.append(1)
        return out

    return checkpoint(body, use_reentrant=False, preserve_rng_state=False)


def maybe_checkpoint(remat: bool, fn: Callable, *args):
    """fn(*args), recomputed in the backward where `remat` (no draws inside)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def gen_forward(models: Mapping[str, nn.Module], batch: Mapping[str, torch.Tensor],
                generator: Optional[torch.Generator]):
    """(pred_wave (B, Tw, 1), commitment, codebook, preds, rev_preds)."""
    wave = batch["wave_seg"][:, :, None]
    z = models["encoder"](wave)
    outs, quantized, commit, cb, timbre = models["quantizer"].forward_v2(
        z, batch["wave_seg"], n_c=2, full_waves=batch["full_waves"],
        wave_lens=batch["wave_lens"], train=True, generator=generator)
    preds, rev_preds = models["fa_predictors"](quantized, timbre)
    return models["decoder"](outs), commit, cb, preds, rev_preds


def disc_pair(disc: nn.Module, fake: torch.Tensor, real: torch.Tensor):
    """One discriminator pass over concat(fake, real), split back per input
    (no discriminator op mixes batch rows)."""
    both = disc(torch.cat([fake, real], dim=0))
    B = fake.shape[0]
    return [[f[:B] for f in fm] for fm in both], [[f[B:] for f in fm] for fm in both]


def gen_loss(gen_outs, disc: nn.Module, batch: Mapping[str, torch.Tensor],
             paired: bool = False):
    """(total generator loss, {loss/*: value}) against `disc`; `paired`
    runs the fake and the real wave through it in one pass."""
    pred_wave, commit, cb, preds, rev_preds = gen_outs
    pw, rw = pred_wave[:, :, 0], batch["wave_seg"]
    mel_l = mel_spectrogram_loss(pw, rw)
    stft_l = multi_scale_stft_loss(pw, rw)
    wav_l = l1_loss(pw, rw)

    if paired:
        d_fake, d_real = disc_pair(disc, pred_wave, rw[:, :, None])
    else:
        d_fake = disc(pred_wave)
        with torch.no_grad():  # the real wave's maps carry no generator gradient
            d_real = disc(rw[:, :, None])
    adv_l, feat_l = generator_adv_losses(d_fake, d_real)

    f0_targets = normalize_f0(batch["f0"])
    real_norm = log_norm(batch["mel_seg"])
    T = min(preds["f0"].shape[1], f0_targets.shape[-1])
    f0_t, uv_t = f0_targets[:, :T], real_norm[:, :T]
    f0_l = smooth_l1_loss(preds["f0"][:, :T, 0], f0_t)
    uv_l = smooth_l1_loss(preds["uv"][:, :T, 0], uv_t)
    rev_f0_l = smooth_l1_loss(rev_preds["rev_f0"][:, :T, 0], f0_t)
    rev_uv_l = smooth_l1_loss(rev_preds["rev_uv"][:, :T, 0], uv_t)
    phone_t = batch["phone_ids"][:, :T]
    content_l = focal_loss(preds["content"][:, :T], phone_t)
    rev_content_l = focal_loss(rev_preds["rev_content"][:, :T], phone_t)
    spk_l = cross_entropy(preds["timbre"], batch["spk_labels"])
    x_spk_l = (cross_entropy(rev_preds["x_timbre"], batch["spk_labels"])
               if rev_preds["x_timbre"] is not None else torch.zeros_like(spk_l))

    loss = (mel_l * LAMBDA_MEL + feat_l * LAMBDA_FEAT + adv_l * LAMBDA_ADV
            + commit * LAMBDA_COMMIT + cb * LAMBDA_CODEBOOK
            + (f0_l + rev_f0_l) * LAMBDA_F0 + (uv_l + rev_uv_l) * LAMBDA_UV
            + (content_l + rev_content_l) * LAMBDA_CONTENT + (spk_l + x_spk_l) * LAMBDA_SPK)
    metrics = {
        "loss/gen_all": loss, "loss/mel": mel_l, "loss/stft": stft_l, "loss/wav_l1": wav_l,
        "loss/adv_g": adv_l, "loss/feature": feat_l, "loss/commitment": commit,
        "loss/codebook": cb, "loss/f0": f0_l, "loss/uv": uv_l, "loss/rev_f0": rev_f0_l,
        "loss/rev_uv": rev_uv_l, "loss/content": content_l, "loss/rev_content": rev_content_l,
        "loss/spk": spk_l, "loss/rev_spk": x_spk_l,
    }
    return loss, metrics


def disc_update(d_opt: AdamW, loss_fn: Callable, fake: torch.Tensor, real: torch.Tensor,
                remat: bool):
    """Phase D's loss, its gradients (averaged over the ranks in a
    data-parallel step) and the discriminator's update: (loss, gradients,
    their norm before the clip)."""
    d_loss = maybe_checkpoint(remat, loss_fn, fake, real)
    d_grads = reduce_gradients(d_opt.params,
                               torch.autograd.grad(d_loss, d_opt.params, allow_unused=True))
    return d_loss, d_grads, d_opt.step(d_grads)


def gen_update(loss: torch.Tensor, optimizers: Mapping[str, AdamW], keys: Sequence[str],
               metrics: Dict[str, torch.Tensor], mark: Callable[[str], None]) -> Dict[str, list]:
    """One backward of phase G's loss into the modules `keys` only, the
    gradients averaged over the ranks in a data-parallel step, then their
    updates; adds `grad_norm/<module>` to `metrics`."""
    params = [p for key in keys for p in optimizers[key].params]
    flat = reduce_gradients(params, torch.autograd.grad(loss, params, allow_unused=True))
    mark("backward")
    grads: Dict[str, list] = {}
    for key in keys:
        n = len(optimizers[key].params)
        grads[key], flat = flat[:n], flat[n:]
        metrics[f"grad_norm/{key}"] = optimizers[key].step(grads[key])
    mark("update")
    return grads


def _no_mark(name: str) -> None:
    pass


def _check_precision(precision: str) -> None:
    if str(precision).lower() in INT8_POLICIES:
        raise ValueError(f"precision={precision!r} is inference-only: the W8A8 round() has zero "
                         "gradient, so training under it would silently stop updating the "
                         "quantized convs. Use float32.")
    if precision != "float32":
        raise NotImplementedError(f"precision={precision!r} training is not ported; the step "
                                  "trains in float32 (ROADMAP Queue 1, item 10)")


def with_teacher_f0(f0_teacher: nn.Module, batch: Mapping[str, torch.Tensor]
                    ) -> Mapping[str, torch.Tensor]:
    """`batch` with `f0` from the teacher on its mel segment."""
    with torch.no_grad():
        f0, _ = f0_teacher(batch["mel_seg"])
    return {**batch, "f0": f0}


def _make_step(models: Mapping[str, nn.Module], optimizers: Mapping[str, AdamW], remat: bool,
               split: bool, f0_teacher: Optional[nn.Module]):
    disc = models["discriminator"]
    if f0_teacher is not None:
        f0_teacher.eval()

    def disc_loss_fn(fake, real):
        return discriminator_loss(*disc_pair(disc, fake, real))

    def forward(batch, generator):
        if remat:
            return replay_checkpoint(lambda: gen_forward(models, batch, generator), generator)
        return gen_forward(models, batch, generator)

    def train_step(batch: Mapping[str, torch.Tensor], generator: Optional[torch.Generator],
                   mark: Optional[Callable[[str], None]] = None):
        mark = mark or _no_mark
        with float32_exact(), step_rows(batch["wave_seg"].shape[0]):
            if f0_teacher is not None:
                batch = with_teacher_f0(f0_teacher, batch)
                mark("teacher")
            real = batch["wave_seg"][:, :, None]
            if split:
                start = None if generator is None else generator.get_state()
                with torch.no_grad():
                    fake = gen_forward(models, batch, generator)[0]
            else:
                gen_outs = forward(batch, generator)
                fake = gen_outs[0].detach()
                mark("forward")

            # phase D
            d_loss, d_grads, d_norm = disc_update(optimizers["discriminator"], disc_loss_fn,
                                                  fake, real, remat)
            del fake
            mark("disc")

            # phase G, against the updated discriminator
            if split:
                if generator is not None:
                    generator.set_state(start)  # phase G draws phase D's masks
                gen_outs = forward(batch, generator)
                mark("forward")
            loss, metrics = maybe_checkpoint(remat, gen_loss, gen_outs, disc, batch, split)
            mark("gen_loss")
            grads = gen_update(loss, optimizers, GEN_KEYS, metrics, mark)
            metrics["loss/disc"] = d_loss
            metrics["grad_norm/discriminator"] = d_norm
            metrics = average_metrics({k: v.detach() for k, v in metrics.items()})
        grads["discriminator"] = d_grads
        return metrics, grads

    return train_step


def make_codec_train_step(models: Mapping[str, nn.Module], optimizers: Mapping[str, AdamW],
                          remat: bool = False, precision: str = "float32",
                          f0_teacher: Optional[nn.Module] = None):
    """Returns `train_step(batch, generator, mark=None) -> (metrics, grads)`.
    `generator` (on the models' device) feeds every draw of the generator
    forward. Metrics are 0-d tensors on the device: every `loss/*` of the JAX
    step, `loss/disc` and `grad_norm/<module>` before the clip. `grads` are
    the gradients the updates took: {module: [tensor, or None where a
    parameter got none, in the optimizer's order]}. `mark`, if given, is
    called with each part's name as the host finishes issuing it:
    "forward", "disc" (phase D with its update), "gen_loss", "backward",
    "update" (a profiler's phase boundaries), after "teacher" where an
    `f0_teacher` (module docstring) gives the step its F0."""
    _check_precision(precision)
    return _make_step(models, optimizers, remat, split=False, f0_teacher=f0_teacher)


def make_codec_train_step_split(models: Mapping[str, nn.Module],
                                optimizers: Mapping[str, AdamW], remat: bool = False,
                                precision: str = "float32",
                                f0_teacher: Optional[nn.Module] = None):
    """The split step (module docstring), with `make_codec_train_step`'s
    signature and returns; its phase G makes one discriminator pass over
    concat(fake, real), as the JAX split step's default `paired_g` does.
    Marks: "disc" (phase D: its forward, loss and update), "forward" (phase
    G's forward), "gen_loss", "backward", "update", after "teacher" with an
    `f0_teacher`."""
    _check_precision(precision)
    return _make_step(models, optimizers, remat, split=True, f0_teacher=f0_teacher)
