"""Chunked long-form vocoder synthesis (``dissc_tpu.infer.streaming``).

Arbitrarily long unit sequences are synthesised as fixed-size windows
with enough real context on each interior side that the output equals
the monolithic forward up to float tolerance: the generator is fully
convolutional, so a sample depends only on codes within its receptive
field.  The first and last windows sit flush with the signal ends, so
the convs' zero padding matches the monolithic forward's.  Two window
shapes in all (``chunk + context`` and ``chunk + 2*context``), and
device memory independent of the utterance's length.  A bfloat16
generator (``compute_dtype``) matches its monolithic forward up to
bfloat16 rounding: the window's shape can change which way a sum rounds.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.models.hifigan import CodeGenerator


def receptive_field_frames(h: VocoderConfig) -> int:
    """One-sided receptive field of the generator, in code frames: the
    'same' context of the pre-conv, every transposed-conv window, the
    widest MRF branch of each stage and the post-conv, each at its own
    rate, converted to code frames (ceil)."""
    hop = int(np.prod(h.upsample_rates))
    rf_samples = 3 * hop  # conv_pre k7 'same' at the code rate
    rate = hop
    for u, k in zip(h.upsample_rates, h.upsample_kernel_sizes):
        rf_samples += math.ceil((k - 1) / 2 / u) * rate
        rate //= u
        mrf = 0
        for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
            half = (rk - 1) // 2
            c = sum(half * d + half for d in rd) if h.resblock == "1" else sum(half * d for d in rd)
            mrf = max(mrf, c)
        rf_samples += mrf * rate
    rf_samples += 3  # conv_post k7 at the sample rate
    return math.ceil(rf_samples / hop)


# windows kept in flight on the device before the oldest is copied to the
# host, so the copy of one chunk overlaps the computation of the next
IN_FLIGHT = 2


class StreamingVocoder:
    """Chunked synthesis through ``model`` (a ``CodeGenerator`` on its
    device), numerically matching the monolithic forward.  The context is
    the receptive field rounded up to a multiple of 8 frames.
    """

    def __init__(self, model: CodeGenerator, chunk_frames: int = 512):
        self.model = model
        self.h = model.h
        self.device = next(model.parameters()).device
        self.hop = int(np.prod(self.h.upsample_rates))
        self.context = ((receptive_field_frames(self.h) + 7) // 8) * 8
        self.chunk = chunk_frames
        if self.chunk < self.context:
            raise ValueError(f"chunk_frames={chunk_frames} < context {self.context} frames")

    @torch.inference_mode()
    def _dispatch(self, code_w: np.ndarray, f0_w: Optional[np.ndarray],
                  spkr: Optional[np.ndarray]) -> torch.Tensor:
        """Enqueue one window on the device; returns the unfetched output."""
        dev = self.device
        code = torch.as_tensor(code_w[None], device=dev).long()
        f0 = None if f0_w is None else torch.as_tensor(f0_w[None], device=dev)
        sp = None if spkr is None else torch.as_tensor(np.asarray(spkr)[None], device=dev).long()
        return self.model(code, f0, sp)[0]

    def synthesize(self, code: np.ndarray, f0: Optional[np.ndarray] = None,
                   spkr: Optional[np.ndarray] = None) -> np.ndarray:
        """``[T]`` int codes (+ ``[Tf, 1]`` f0 at an integer multiple of the
        code rate, + ``[1]`` speaker id) -> ``[T*hop*r]`` float waveform.

        One monolithic call when the sequence fits in one boundary window.
        """
        code = np.asarray(code, np.int64)
        T = len(code)
        r = 1
        if f0 is not None:
            f0 = np.asarray(f0, np.float32).reshape(-1, 1)
            # pad with zeros / trim to the nearest multiple of the code
            # length, the same tolerance as the bucketed path
            r = max(1, int(round(len(f0) / max(T, 1))))
            if len(f0) != T * r:
                buf = np.zeros((T * r, 1), np.float32)
                n = min(len(f0), T * r)
                buf[:n] = f0[:n]
                f0 = buf
        eff = r * self.hop
        ch, cx = self.chunk, self.context
        if T < ch + 2 * cx:
            return self._dispatch(code, f0, spkr).cpu().numpy()[: T * eff]

        out = np.empty(T * eff, np.float32)
        # window plan: (code_lo, code_hi, out_lo, out_hi, y_lo, y_hi) with
        # out[out_lo:out_hi] = y[y_lo:y_hi] (sample units)
        plan: List[Tuple[int, int, int, int, int, int]] = [
            (0, ch + cx, 0, ch * eff, 0, ch * eff)]
        s = ch
        while s + ch + cx <= T:
            plan.append((s - cx, s + ch + cx, s * eff, (s + ch) * eff,
                         cx * eff, (cx + ch) * eff))
            s += ch
        if s < T:
            # tail: an interior-shaped window flush with the signal end; the
            # remaining T - s < ch + cx frames keep >= cx frames of left context
            wlen = (ch + 2 * cx) * eff
            plan.append((T - (ch + 2 * cx), T, s * eff, T * eff, wlen - (T - s) * eff, wlen))

        pending = []

        def flush_one():
            (o_lo, o_hi, y_lo, y_hi), y_dev = pending.pop(0)
            out[o_lo:o_hi] = y_dev.cpu().numpy()[y_lo:y_hi]

        for (lo, hi, o_lo, o_hi, y_lo, y_hi) in plan:
            y_dev = self._dispatch(code[lo:hi], None if f0 is None else f0[lo * r: hi * r], spkr)
            pending.append(((o_lo, o_hi, y_lo, y_hi), y_dev))
            if len(pending) > IN_FLIGHT:
                flush_one()
        while pending:
            flush_one()
        return out
