"""Resampling and silence trimming (``dissc_tpu.audio.resample``, copied:
numpy and scipy on the host).

The reference preprocessor uses ``resampy.resample`` and
``librosa.effects.trim`` (``data/preprocess.py:19-31``); neither library
exists here, so both are implemented natively:

  * :func:`resample_poly_np` — polyphase rational resampling via
    scipy (same filter family resampy's kaiser_best approximates).
  * :func:`trim_silence` — frame-RMS threshold trim matching librosa's
    ``effects.trim(top_db=...)`` semantics (dB relative to peak RMS).
"""
from __future__ import annotations

from math import gcd
from typing import Tuple

import numpy as np


def resample_poly_np(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return x
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g)


def _frame_rms_db(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    n = 1 + max(0, (len(y) - frame_length)) // hop_length
    frames = np.lib.stride_tricks.as_strided(
        np.ascontiguousarray(y),
        shape=(n, frame_length),
        strides=(y.itemsize * hop_length, y.itemsize),
    )
    rms = np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1))
    ref = rms.max() if rms.size else 1.0
    return 20.0 * np.log10(np.maximum(rms, 1e-10) / max(ref, 1e-10))


def trim_silence(
    y: np.ndarray, top_db: float = 20.0, frame_length: int = 2048, hop_length: int = 512
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Trim leading/trailing frames more than ``top_db`` below peak RMS.

    Equivalent to ``librosa.effects.trim`` defaults used by the
    reference (``data/preprocess.py:26``).
    """
    db = _frame_rms_db(y, frame_length, hop_length)
    non_silent = db > -top_db
    if not non_silent.any():
        return y[:0], (0, 0)
    first = int(np.argmax(non_silent))
    last = int(len(non_silent) - np.argmax(non_silent[::-1]))
    start = first * hop_length
    end = min(len(y), last * hop_length + frame_length)
    return y[start:end], (start, end)
