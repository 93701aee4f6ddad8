"""Duration losses and metrics (``dissc_tpu.losses.len_loss``; reference
``loss/len_loss.py``).

All are masked *sums* over non-pad run slots; the trainer normalises by the
total non-pad count at logging time (the reference trainer's convention).
"""
from __future__ import annotations

import torch


def _mask(lens: torch.Tensor, pad_idx: float) -> torch.Tensor:
    return lens != pad_idx


def len_mse_loss(preds: torch.Tensor, lens: torch.Tensor, pad_idx: float = -1) -> torch.Tensor:
    return torch.sum(_mask(lens, pad_idx) * (preds - lens) ** 2)


def len_mae_loss(preds: torch.Tensor, lens: torch.Tensor, pad_idx: float = -1) -> torch.Tensor:
    return torch.sum(_mask(lens, pad_idx) * torch.abs(preds - lens))


def len_smooth_l1_loss(preds: torch.Tensor, lens: torch.Tensor, pad_idx: float = -1,
                       beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(preds - lens)
    sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return torch.sum(_mask(lens, pad_idx) * sl1)


def len_sum_loss(preds: torch.Tensor, lens: torch.Tensor, pad_idx: float = -1) -> torch.Tensor:
    """Masked MSE + 0.5 * (4-slot pooled difference * 4)^2.

    The pooled term lets neighbouring errors cancel, so the model is not
    biased toward longer or shorter totals (reference
    ``loss/len_loss.py:16-30``).  A 4-slot window is masked out if *any*
    of its slots is padding (the reference's max-pool of the mask).
    """
    diff = preds - lens
    t4 = (diff.shape[-1] // 4) * 4
    diff4 = diff[..., :t4].reshape(*diff.shape[:-1], -1, 4).mean(-1) * 4
    win_has_pad = (lens[..., :t4] == pad_idx).reshape(*lens.shape[:-1], -1, 4).any(-1)
    diff_loss4 = torch.sum(torch.where(win_has_pad, 0.0, diff4 ** 2))
    return len_mse_loss(preds, lens, pad_idx) + 0.5 * diff_loss4


def _round_preds(preds: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(preds, min=1)).to(torch.int32)


def len_exact_accuracy(preds: torch.Tensor, lens: torch.Tensor,
                       pad_idx: float = -1) -> torch.Tensor:
    """Count of slots where round(clamp(pred, 1)) == len (masked sum)."""
    return torch.sum(_mask(lens, pad_idx) & (_round_preds(preds) == lens))


def len_one_off_accuracy(preds: torch.Tensor, lens: torch.Tensor,
                         pad_idx: float = -1) -> torch.Tensor:
    """Count of slots within +-1 of the true length (masked sum)."""
    return torch.sum(_mask(lens, pad_idx) & (torch.abs(_round_preds(preds) - lens) <= 1))
