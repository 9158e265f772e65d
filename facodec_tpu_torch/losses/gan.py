"""LS-GAN adversarial and feature-matching losses over the discriminator's
feature maps (port of facodec_tpu/losses/gan.py):

  disc: sum_d mean(d(fake)[-1]^2) + mean((1 - d(real)[-1])^2)
  gen:  sum_d mean((1 - d(fake)[-1])^2)
  feat: sum_d sum_{j < last} L1(d(fake)[j], d(real)[j] without gradient)
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def discriminator_loss(d_fake: List[List[torch.Tensor]],
                       d_real: List[List[torch.Tensor]]) -> torch.Tensor:
    loss = 0.0
    for x_fake, x_real in zip(d_fake, d_real):
        loss = loss + torch.mean(torch.square(x_fake[-1].float()))
        loss = loss + torch.mean(torch.square(1.0 - x_real[-1].float()))
    return loss


def generator_adv_losses(d_fake: List[List[torch.Tensor]], d_real: List[List[torch.Tensor]]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(adversarial loss, feature-matching loss)."""
    loss_g = 0.0
    for x_fake in d_fake:
        loss_g = loss_g + torch.mean(torch.square(1.0 - x_fake[-1].float()))
    loss_feature = 0.0
    for f_list, r_list in zip(d_fake, d_real):
        for f, r in zip(f_list[:-1], r_list[:-1]):
            loss_feature = loss_feature + torch.mean(torch.abs(f.float() - r.detach().float()))
    return loss_g, loss_feature
