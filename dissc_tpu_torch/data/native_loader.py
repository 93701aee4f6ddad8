"""ctypes binding of the native C++ WAV / crop loader (``native/wavloader.cc``;
``dissc_tpu.data.native_loader``).

The batch crop loader replaces per-file Python reads with one threaded C++
call, the counterpart of the reference's DataLoader worker processes.  The
library is built by :mod:`~dissc_tpu_torch.data.native_build` into
``build/native/`` and every entry point raises if it cannot be built: the
JAX binding's silent switch to its numpy path is not copied.  A file the
C++ header scan does not read as 16-bit PCM (an IEEE-float WAV, say) is
read by :func:`~dissc_tpu_torch.core.wav.read_wav` in ``wav_info`` and
``load_normalized``, as in the JAX binding; ``load_crops`` raises for it.

``call_counts["load_crops"]`` counts the batches the native crop loader
filled, so a caller can show that a run took the native path.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from dissc_tpu_torch.data import native_build

N_THREADS = 8  # decode threads of one load_crops call
call_counts = {"load_crops": 0}


def reset_call_counts() -> None:
    for key in call_counts:
        call_counts[key] = 0


def _lib() -> ctypes.CDLL:
    """The built library with its signatures declared (idempotent)."""
    lib = native_build.load("wavloader", link=("-lpthread",))
    if lib.wav_info.argtypes is None:
        lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_long)]
        lib.wav_info.restype = ctypes.c_int
        lib.wav_load_normalized.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int)]
        lib.wav_load_normalized.restype = ctypes.c_long
        lib.wav_load_crops.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.wav_load_crops.restype = ctypes.c_int
    return lib


def wav_info(path: str) -> Tuple[int, int]:
    """(sample_rate, n_samples) without decoding the payload."""
    sr, n = ctypes.c_int(), ctypes.c_long()
    if _lib().wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(n)) == 0:
        return sr.value, n.value
    from dissc_tpu_torch.core.wav import read_wav

    data, sr_ = read_wav(path, dtype="int16")
    return sr_, len(data)


def load_normalized(path: str) -> Tuple[np.ndarray, int]:
    """Full waveform with the training amplitude convention applied."""
    lib = _lib()
    _, n = wav_info(path)
    out = np.empty(n, np.float32)
    sr = ctypes.c_int()
    got = lib.wav_load_normalized(path.encode(),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
                                  ctypes.byref(sr))
    if got >= 0:
        return out[:got], sr.value
    from dissc_tpu_torch.core.wav import normalize_audio_int16, read_wav

    data, sr_ = read_wav(path, dtype="int16")
    return normalize_audio_int16(data).astype(np.float32), sr_


def load_crops(paths: Sequence[str], starts: Sequence[int], crop_len: int,
               eff_lens: Optional[Sequence[int]] = None) -> np.ndarray:
    """``[len(paths), crop_len]`` float batch of normalised crops, wrapping
    modulo ``eff_lens[i]`` (the code-aligned trim; <= 0 = the whole file).
    Raises ``IOError`` naming the files the C++ side could not decode."""
    lib = _lib()
    n = len(paths)
    out = np.empty((n, crop_len), np.float32)
    eff = list(eff_lens) if eff_lens is not None else [-1] * n
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = (ctypes.c_long * n)(*[int(s) for s in starts])
    c_lens = (ctypes.c_long * n)(*[int(v) for v in eff])
    n_failed = lib.wav_load_crops(c_paths, n, c_starts, c_lens, crop_len,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), N_THREADS)
    if n_failed:
        # the C++ side zero-fills failed rows: name them rather than train on silence
        bad = [p for p in paths if not os.path.exists(p) or wav_info(p)[1] <= 0]
        raise IOError(f"native crop loader: {n_failed}/{n} wav files failed to decode "
                      f"(unreadable or not 16-bit PCM): {bad[:8]}")
    call_counts["load_crops"] += 1
    return out
