"""Pitch losses and metrics (``dissc_tpu.losses.pitch_loss``; reference
``loss/pitch_loss.py``).

The regression target is *whitened* f0; the losses de-whiten with the
per-speaker stats before measuring, and everything is a masked sum.
"""
from __future__ import annotations

import torch


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # the JAX package's stable form, term for term
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def pitch_loss(class_preds: torch.Tensor, reg_preds: torch.Tensor, gts: torch.Tensor,
               spk_ids: torch.Tensor, id2mean: torch.Tensor, id2std: torch.Tensor,
               pad_idx: float = -100) -> torch.Tensor:
    """100 * masked BCE(voicing) + 1 * voiced-masked L1(de-whitened f0)
    (reference ``loss/pitch_loss.py:6-27``).  ``gts``: whitened f0, 0 at
    unvoiced frames and ``pad_idx`` at padding; ``spk_ids``: ``[B, 1]``."""
    mask = gts != pad_idx
    voiced = (gts != 0).float()
    loss1 = torch.sum(mask * _bce_with_logits(class_preds, voiced))
    std, mean = id2std[spk_ids], id2mean[spk_ids]
    preds = mean + std * reg_preds
    gts_hz = mean + std * gts
    loss2 = torch.sum(mask * torch.abs(preds - gts_hz) * voiced)
    return 100.0 * loss1 + 1.0 * loss2


def _dewhitened_target(gts, spk_ids, id2mean, id2std):
    return (id2mean[spk_ids] + id2std[spk_ids] * gts) * (gts != 0)


def pitch_mae(freq_preds: torch.Tensor, gts: torch.Tensor, spk_ids: torch.Tensor,
              id2mean: torch.Tensor, id2std: torch.Tensor, pad_idx: float = -100) -> torch.Tensor:
    """Masked L1 between predicted Hz and the de-whitened target (unvoiced = 0)."""
    mask = gts != pad_idx
    return torch.sum(mask * torch.abs(freq_preds - _dewhitened_target(gts, spk_ids, id2mean,
                                                                      id2std)))


def pitch_mse(freq_preds: torch.Tensor, gts: torch.Tensor, spk_ids: torch.Tensor,
              id2mean: torch.Tensor, id2std: torch.Tensor, pad_idx: float = -100) -> torch.Tensor:
    mask = gts != pad_idx
    return torch.sum(mask * (freq_preds - _dewhitened_target(gts, spk_ids, id2mean, id2std)) ** 2)
