"""LS-GAN + feature-matching losses (reference ``sr/models.py:352-383``,
``dissc_tpu.losses.gan``).  Every reduction runs in float32: each score and
feature map is cast to float32 before it is reduced, so bfloat16
discriminators (``disc_compute_dtype``) are reduced as the JAX package's
``_f32`` reduces them."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_loss(fmap_r: Sequence[Sequence[torch.Tensor]],
                 fmap_g: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """2 * sum of per-layer L1 between real/generated feature maps."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2


def discriminator_loss(disc_real_outputs: Sequence[torch.Tensor],
                       disc_generated_outputs: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """LS-GAN D loss: sum of (1-D(y))^2 + D(y_hat)^2 per sub-discriminator."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LS-GAN G loss: sum of (1-D(y_hat))^2 per sub-discriminator."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1 - dg.float()) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses
