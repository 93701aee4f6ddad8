"""ctypes binding of the native FLAC decoder (``native/flacdec.cc``;
``dissc_tpu.data.flac_native``).

The reference reads VCTK ground-truth FLAC through torchaudio/soundfile
(``scripts/convert_eval.py:129``, ``eval_sv.py:33-35``); this module is
the dependency-free replacement.  The library is built by
:mod:`~dissc_tpu_torch.data.native_build` into ``build/native/`` at first
use, and every entry point raises if it cannot be built.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from dissc_tpu_torch.data import native_build


def _lib() -> ctypes.CDLL:
    """The built library with its signatures declared (idempotent)."""
    lib = native_build.load("flacdec")
    if lib.flac_info.argtypes is None:
        lib.flac_info.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
        ]
        lib.flac_info.restype = ctypes.c_int
        lib.flac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ]
        lib.flac_decode.restype = ctypes.c_long
    return lib


def flac_info(path: str) -> Tuple[int, int, int, int]:
    """(sample_rate, channels, bits_per_sample, total_samples)."""
    lib = _lib()
    with open(path, "rb") as f:
        blob = f.read()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    bits = ctypes.c_int()
    n = ctypes.c_long()
    rc = lib.flac_info(blob, len(blob), ctypes.byref(sr), ctypes.byref(ch),
                       ctypes.byref(bits), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"not a valid FLAC stream: {path}")
    return sr.value, ch.value, bits.value, n.value


def read_flac(path: str, dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (samples, sample_rate).

    Multi-channel audio returns [n, channels]; mono returns [n].
    ``dtype``: 'float32' (in [-1, 1]), 'int16', or 'int32' (raw PCM
    values at the stream's bit depth).
    """
    lib = _lib()
    sr, channels, bits, n_samples = flac_info(path)
    with open(path, "rb") as f:
        blob = f.read()
    if n_samples == 0:
        # total-samples unknown in STREAMINFO: upper-bound by stream size
        n_samples = len(blob) * 8 // max(bits, 1) + 65536
    # A corrupt STREAMINFO can declare an absurd total and stall the
    # process on a multi-GB allocation.  Even all-CONSTANT frames need a
    # ~10-byte frame header per <=65535 samples, so ~8192 samples/byte
    # bounds what the stream could physically encode.
    max_plausible = len(blob) * 8192 + 65536
    if n_samples > max_plausible:
        raise ValueError(
            f"corrupt FLAC STREAMINFO: declares {n_samples} samples but the "
            f"stream is only {len(blob)} bytes: {path}")
    out = np.zeros(n_samples * channels, np.int32)
    got = lib.flac_decode(blob, len(blob),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          n_samples)
    if got < 0:
        raise ValueError(f"FLAC decode failed: {path}")
    data = out[: got * channels]
    if channels > 1:
        data = data.reshape(-1, channels)
    if dtype == "int32":
        return data, sr
    if dtype == "int16":
        if bits > 16:
            data = (data >> (bits - 16)).astype(np.int16)
        elif bits < 16:
            data = (data << (16 - bits)).astype(np.int16)
        else:
            data = data.astype(np.int16)
        return data, sr
    return (data.astype(np.float64) / float(1 << (bits - 1))).astype(np.float32), sr
