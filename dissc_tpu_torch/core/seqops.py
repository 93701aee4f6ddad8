"""Sequence ops of the port (``dissc_tpu.core.seqops``).

Only :func:`nearest_upsample` so far; the rest of seqops belongs to the
prosody slice.
"""
from __future__ import annotations

import torch


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-repeat upsampling along time: (..., T, C) -> (..., T*factor, C).

    Reference ``sr/models.py:158-177`` (``CodeGenerator._upsample``).
    """
    if factor == 1:
        return x
    return torch.repeat_interleave(x, factor, dim=-2)
