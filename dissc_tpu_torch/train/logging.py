"""Metric logging (``dissc_tpu.train.logging``).

Writes what the JAX package's logger writes when ``tensorboardX`` is
absent: a JSONL metrics file per writer and validation audio samples as
16-bit WAVs beside it.  The port needs neither ``tensorboardX`` nor
``matplotlib``, so it draws no spectrogram figure.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict

import numpy as np

from dissc_tpu_torch.core.wav import write_wav


class MetricLogger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        self._jsonl.write(json.dumps({"step": step, "ts": time.time(),
                                      **{f"{prefix}{k}": float(v) for k, v in values.items()}})
                          + "\n")
        self._jsonl.flush()

    def audio(self, tag: str, wav: np.ndarray, step: int, sample_rate: int = 16000) -> None:
        safe = tag.replace("/", "_")
        write_wav(os.path.join(self.logdir, f"{safe}_{step}.wav"), wav, sample_rate)

    def close(self) -> None:
        self._jsonl.close()


def init_loggers(path: str):
    """Fresh train/val writers; wipes prior logs and the best model
    (reference ``utils.py:22-29`` semantics)."""
    for sub in ("train", "val"):
        if os.path.exists(os.path.join(path, sub)):
            shutil.rmtree(os.path.join(path, sub))
    best = os.path.join(path, "best_model.pth")
    if os.path.exists(best):
        os.remove(best)
    return MetricLogger(os.path.join(path, "train")), MetricLogger(os.path.join(path, "val"))


def log_metrics(logger: MetricLogger, value_dict: Dict[str, float], epoch: int,
                name: str = "train") -> None:
    logger.scalars(value_dict, epoch)
    print(", ".join(f"{name}_{k}: {float(v):.5f}" for k, v in value_dict.items()))
