"""Training-target transforms (port of facodec_tpu/train/targets.py)."""

from __future__ import annotations

import torch


def normalize_f0(f0: torch.Tensor, voiced_threshold: float = 5.0) -> torch.Tensor:
    """(B, T) raw F0 in Hz -> per-utterance normalised log2-F0 over the
    voiced frames (> voiced_threshold), unvoiced frames -10. The std is the
    unbiased (n - 1) one; an utterance with no voiced frame is all -10, and
    NaN / Inf become -10."""
    voiced = f0 > voiced_threshold
    n = torch.sum(voiced, dim=-1, keepdim=True).to(f0.dtype)
    log_f0 = torch.log2(torch.clamp_min(f0, 1e-10))
    vlog = torch.where(voiced, log_f0, torch.zeros_like(log_f0))
    mean = torch.sum(vlog, dim=-1, keepdim=True) / torch.clamp_min(n, 1.0)
    sq = torch.where(voiced, torch.square(log_f0 - mean), torch.zeros_like(log_f0))
    std = torch.sqrt(torch.sum(sq, dim=-1, keepdim=True) / torch.clamp_min(n - 1.0, 1.0))
    out = torch.where(voiced, (log_f0 - mean) / torch.clamp_min(std, 1e-10),
                      torch.full_like(log_f0, -10.0))
    out = torch.where(n > 0, out, torch.full_like(out, -10.0))
    return torch.where(torch.isfinite(out), out, torch.full_like(out, -10.0))
