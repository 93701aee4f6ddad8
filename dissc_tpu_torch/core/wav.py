"""WAV I/O and amplitude utilities (``dissc_tpu.core.wav``, copied; numpy).

The reference reads/writes audio with ``soundfile`` (``sr/dataset.py:72-74``)
and normalises with ``librosa.util.normalize`` (``sr/dataset.py:233``).
This module implements the needed subset without either: 16-bit PCM WAV
read/write via the stdlib ``wave`` module, IEEE-float WAVs through a small
RIFF parser, FLAC through the port's binding of ``native/flacdec.cc``, and
peak normalisation.
"""
from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

MAX_WAV_VALUE = 32768.0  # reference sr/dataset.py:24


class _PcmRiffError(ValueError):
    """RIFF fallback found an ordinary PCM file — the original
    ``wave.Error`` (corruption, truncation) is the real story."""


def _read_riff_float(path: str) -> Tuple[np.ndarray, int, int]:
    """Minimal RIFF parser for IEEE-float WAVs (wFormatTag=3), which the
    stdlib ``wave`` module rejects — ``scipy.io.wavfile.write`` emits
    them for float arrays.  Returns (float64 samples, sr, channels)."""
    import struct

    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12:
            raise ValueError(f"not a RIFF/WAVE file (too short): {path}")
        riff, _, wave_id = struct.unpack("<4sI4s", head)
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"no data chunk in {path}")
            cid, size = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                raw_fmt = f.read(16)
                if len(raw_fmt) < 16:
                    raise ValueError(f"truncated fmt chunk in {path}")
                fmt = struct.unpack("<HHIIHH", raw_fmt)
                f.seek(size - 16 + (size & 1), 1)
            elif cid == b"data":
                raw = f.read(size)
                break
            else:
                f.seek(size + (size & 1), 1)
    if fmt is None:
        raise ValueError(f"no fmt chunk before data chunk in {path}")
    tag, channels, sr, _, _, bits = fmt
    if tag == 1:
        # PCM that the stdlib wave module nevertheless rejected: the file
        # is damaged, not IEEE-float — surface the real corruption error.
        raise _PcmRiffError(f"PCM WAV rejected by the wave module: {path}")
    if tag != 3 or bits not in (32, 64):
        raise ValueError(f"unsupported WAV format tag {tag}/{bits}b in {path}")
    data = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
    return data.astype(np.float64), sr, channels


def read_wav(path: str, dtype: str = "int16") -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (samples, sample_rate).

    Supports 16/32-bit PCM (stdlib ``wave``) and 32/64-bit IEEE float
    WAVs (format tag 3, via the RIFF fallback).  ``dtype`` selects the
    returned representation: ``"int16"`` (as the reference's
    ``sf.read(dtype='int16')``) or ``"float32"`` (samples in [-1, 1], as
    plain ``sf.read``).
    """
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            channels = w.getnchannels()
            raw = w.readframes(n)
    except wave.Error as wav_err:
        try:
            data, sr, channels = _read_riff_float(path)
        except _PcmRiffError:
            # damaged int16/PCM file, not an IEEE-float one: the wave
            # module's error is the accurate diagnosis — re-raise it.
            raise wav_err
        width = 0  # sentinel: already in [-1, 1] float
        scale = 1.0
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.int16)
        scale = MAX_WAV_VALUE
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4")
        scale = 2147483648.0
    elif width != 0:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    if dtype == "int16":
        if width != 2:
            data = np.clip(np.round(data / scale * MAX_WAV_VALUE), -32768, 32767)
        return data.astype(np.int16), sr
    return (data.astype(np.float64) / scale).astype(np.float32), sr


def read_audio(path: str, dtype: str = "int16") -> Tuple[np.ndarray, int]:
    """Format-dispatching read: WAV via :func:`read_wav`, FLAC via the
    native decoder (``native/flacdec.cc``) — covering everything the
    reference reads through soundfile/torchaudio (VCTK gt is FLAC,
    ``scripts/convert_eval.py:129``)."""
    if path.lower().endswith(".flac"):
        from dissc_tpu_torch.data.flac_native import read_flac

        return read_flac(path, dtype=dtype)
    return read_wav(path, dtype=dtype)


def write_wav(path: str, data: np.ndarray, sr: int) -> None:
    """Write mono 16-bit PCM WAV.  Float input is assumed to be in [-1, 1]."""
    data = np.asarray(data).squeeze()
    if data.dtype.kind == "f":
        data = np.clip(data, -1.0, 1.0)
        data = np.round(data * (MAX_WAV_VALUE - 1)).astype(np.int16)
    else:
        data = data.astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def peak_normalize(x: np.ndarray) -> np.ndarray:
    """Scale so that ``max |x| == 1`` (librosa.util.normalize default)."""
    peak = np.max(np.abs(x))
    if peak == 0:
        return x.astype(np.float64)
    return x.astype(np.float64) / peak


def normalize_audio_int16(audio_i16: np.ndarray) -> np.ndarray:
    """int16 samples -> the reference's training amplitude convention.

    ``audio / 32768 -> peak-normalize -> * 0.95`` (``sr/dataset.py:232-233``).
    """
    return peak_normalize(audio_i16 / MAX_WAV_VALUE) * 0.95
