"""Determinism helper (``dissc_tpu.core.seed``).

Seeds the host RNGs the data path draws from (``random``, numpy) and
torch's global generator.  The port's own randomness (weights, token
masks, dropout) goes through explicit ``torch.Generator`` objects seeded
from the configs, so this only guards code that reaches the global ones.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    if seed == -1:
        return
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
