"""Tracing and profiling hooks (``dissc_tpu.utils.profiling``).

The reference's only instrumentation is wall-clock RTF per utterance
(``sr/inference.py:67-76``) and seconds-per-batch prints
(``sr/train.py:127-136``).  Here the same accounting is a reusable
:class:`RTFMeter`, plus an opt-in ``torch.profiler`` trace
(``DISSC_TPU_TRACE_DIR=/path``) of the host and, when CUDA is available,
the card, written as a Chrome trace that TensorBoard and Perfetto read.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List

import torch

TRACE_DIR_ENV = "DISSC_TPU_TRACE_DIR"


def _sync() -> None:
    """Wait for the card, where CUDA is in use: a CUDA call returns before
    the card has finished its work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class RTFMeter:
    """Accumulate (compute seconds, audio seconds) -> real-time factor.

    The arithmetic of the JAX package's meter; each :meth:`measure` window
    also synchronises the card at both ends when CUDA is initialised, so it
    holds the card's work and nothing enqueued before it.
    """

    def __init__(self, sampling_rate: int = 16000):
        self.sampling_rate = sampling_rate
        self.compute_s: float = 0.0
        self.audio_s: float = 0.0
        self.per_item: List[float] = []

    @contextlib.contextmanager
    def measure(self, n_samples: int) -> Iterator[None]:
        _sync()
        start = time.time()
        yield
        _sync()
        dt = time.time() - start
        dur = n_samples / self.sampling_rate
        self.compute_s += dt
        self.audio_s += dur
        self.per_item.append(dt / max(dur, 1e-9))

    @property
    def rtf(self) -> float:
        return self.compute_s / max(self.audio_s, 1e-9)


@contextlib.contextmanager
def trace_if_enabled(name: str = "trace") -> Iterator[None]:
    """A ``torch.profiler`` trace of the block into
    ``$DISSC_TPU_TRACE_DIR/<name>/`` (one ``*.pt.trace.json`` a window)
    when the variable is set; nothing otherwise."""
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(os.path.join(trace_dir, name))):
        yield
        _sync()
