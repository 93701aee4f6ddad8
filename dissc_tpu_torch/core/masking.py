"""Padding-mask helpers (``dissc_tpu.core.masking``).

The reference keeps every loss and metric as a *masked sum* over non-pad
elements, normalised only at logging time by the total non-pad count
(reference ``train_len_predictor.py:72-73``, ``train_f0_predictor.py:66-67``).
These helpers keep that accounting explicit, so distributed reductions
stay exact (sum the sums and the counts across ranks, divide once).
"""
from __future__ import annotations

import torch


def pad_mask(labels: torch.Tensor, pad_value) -> torch.Tensor:
    """Bool mask of non-pad label positions."""
    return labels != pad_value


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[B, max_len]`` bool mask from per-row lengths ``[B]``."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(mask, x, 0))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return masked_sum(x, mask) / torch.clamp(mask.sum(dtype=torch.float32), min=eps)
