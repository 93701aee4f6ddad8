"""Prosody model construction (``dissc_tpu.train.prosody_trainer``).

Only :func:`build_pitch_model` so far, which inference needs; the
trainers themselves belong to the prosody-training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from dissc_tpu_torch.core.config import ProsodyConfig
from dissc_tpu_torch.models.prosody import PitchPredictor, PitchPredictorBase


def build_pitch_model(model_type: str, n_tokens: int, n_speakers: int,
                      cfg: Optional[ProsodyConfig] = None,
                      generator: Optional[torch.Generator] = None):
    """``"base"`` -> :class:`PitchPredictorBase`, anything else ->
    :class:`PitchPredictor` (the JAX package's rule)."""
    cfg = cfg or ProsodyConfig()
    cls = PitchPredictorBase if model_type == "base" else PitchPredictor
    return cls(n_tokens=n_tokens, n_speakers=n_speakers, emb_size=cfg.emb_size,
               hidden=cfg.hidden, generator=generator)
