"""Supervision losses of the predictor heads and the energy target (port of
facodec_tpu/losses/supervision.py): cross-entropy, the reference's focal
loss (the focal weight on the batch-mean CE), smooth L1 (beta 1) and
`log_norm`. In a data-parallel step the focal weight reads the global
batch's mean CE (parallel/mesh.py `global_mean`), as the JAX SPMD step's
does; the other losses are means of equal rows, which the gradient
all-reduce averages exactly."""

from __future__ import annotations

import torch

from facodec_tpu_torch.parallel.mesh import global_mean


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over leading dims; logits (..., C), integer labels (...)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return torch.mean(nll)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    logp = global_mean(cross_entropy(logits, labels))
    p = torch.exp(-logp)
    return torch.pow(1.0 - p, gamma) * logp


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * torch.square(d) / beta, d - 0.5 * beta))


def log_norm(x: torch.Tensor, mean: float = -4.0, std: float = 4.0, dim: int = -1) -> torch.Tensor:
    """Frame energy of a normalised log-mel: log ||exp(x * std + mean)||_2
    over the mel axis; (B, T, n_mels) -> (B, T)."""
    return torch.log(torch.linalg.vector_norm(torch.exp(x * std + mean), dim=dim))
