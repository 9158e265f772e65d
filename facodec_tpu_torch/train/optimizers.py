"""Per-module optimizers (port of facodec_tpu/train/optimizers.py).

One AdamW per module, as optax's `chain(clip_by_global_norm(clip),
adamw(exponential_decay(base_lr, 1, gamma), b1, b2, eps, weight_decay))`
computes it, not as `torch.optim.AdamW` does:
- the clip scales by max_norm / norm only where norm >= max_norm
  (`clip_grad_norm_` divides by norm + 1e-6 always);
- eps is added to the bias-corrected sqrt(v);
- the decoupled weight decay is added to the Adam direction before the
  learning rate scales both: p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p);
- the learning rate is base_lr * gamma^k at the k-th update (k from 0): the
  exponential schedule stepped after every update. Its step count is
  `count`, saved with the moments.
The clip is 10 for the discriminator and 1000 for each generator module
(`GEN_KEYS`). A parameter that got no gradient takes a zero one, so weight
decay still moves it, as it does under optax. Under tensor parallelism
(parallel/sharding.py) a module's parameters may hold rows of a sharded
one: the clip's norm then sums the shards' squares over the model group,
so every rank clips by the whole gradient's norm.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from facodec_tpu_torch.parallel.mesh import is_sharded, model_sum_

GEN_KEYS = ("encoder", "quantizer", "decoder", "fa_predictors")


def global_norm(tensors: Sequence[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor; where
    `sharded` marks tensors that are row shards over the model group, over
    the whole tensors they are rows of."""
    tensors = list(tensors)
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    parts = [[t for t, s in zip(tensors, sharded, strict=True) if s == want]
             for want in (True, False)]
    sq = [torch.sum(torch.stack(torch._foreach_norm(ts)) ** 2) if ts
          else torch.zeros((), device=tensors[0].device) for ts in parts]
    return torch.sqrt(model_sum_(sq[0]) + sq[1])


class AdamW:
    """optax's clipped AdamW with an exponential schedule, over the named
    parameters of one module, updated in place from a list of gradients."""

    def __init__(self, named_params: Iterable, base_lr: float = 1e-4, gamma: float = 0.999996,
                 clip_norm: Optional[float] = None, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-9, weight_decay: float = 0.1):
        named = list(named_params)
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.base_lr, self.gamma, self.clip_norm = base_lr, gamma, clip_norm
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.base_lr * self.gamma ** self.count

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """One update from `grads` (aligned with the parameters; None is a
        zero gradient). Returns the gradients' global norm before the clip."""
        g = [torch.zeros_like(p) if t is None else t.detach().clone()
             for p, t in zip(self.params, grads, strict=True)]
        norm = global_norm(g, [is_sharded(p) for p in self.params])
        if self.clip_norm is not None:
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            torch._foreach_mul_(g, scale)
        lr = self.lr
        self.count += 1
        # optax computes the bias corrections in float32
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        return norm

    def state_dict(self) -> Dict:
        return dict(count=self.count, mu=dict(zip(self.names, self.mu)),
                    nu=dict(zip(self.names, self.nu)))

    def load_state_dict(self, state: Mapping) -> None:
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.names):
                raise ValueError(f"AdamW.load_state_dict: {key} names do not match the "
                                 "parameters")
        with torch.no_grad():
            for name, mu, nu in zip(self.names, self.mu, self.nu):
                mu.copy_(state["mu"][name])
                nu.copy_(state["nu"][name])
        self.count = int(state["count"])


def build_optimizers(models: Mapping[str, nn.Module], base_lr: float = 1e-4,
                     gamma: float = 0.999996, disc_clip: float = 10.0,
                     gen_clip: float = 1000.0) -> Dict[str, AdamW]:
    """One AdamW per module, with the reference's clip norms."""
    return {key: AdamW(m.named_parameters(), base_lr, gamma,
                       disc_clip if key == "discriminator" else gen_clip)
            for key, m in models.items()}
