"""Batched vocoder synthesis (``dissc_tpu.infer.vocoder.VocoderEngine``).

Behaviour of the JAX engine, on the card:

* weight norm is folded once at construction unless the state is folded
  already (the reference's ``remove_weight_norm``, ``sr/inference.py:160``);
* utterances are padded to frame buckets ``(64 ... 2048)`` by
  edge-replicating the last code and zero-filling f0; outputs are cut to
  the true length.  With the generator's receptive field the padding
  perturbs only the final ~60 ms; ``exact_lengths=True`` synthesises each
  utterance at its own length;
* f0 is normalised to an integer multiple ``r`` of the code length
  (``r > 1`` is finer-rate conditioning: ``r*320`` samples per code
  frame) and batches are grouped by ``(bucket, r)``;
* utterances past the last bucket stream through
  :class:`~dissc_tpu_torch.infer.streaming.StreamingVocoder`.

``from_checkpoint`` reads ``config.json`` and the latest ``g_*`` pickle
written by either package's trainer (JAX tree layout).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dissc_tpu_torch.compat.from_jax import generator_state_dict
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.device import DeviceLike, resolve_device
from dissc_tpu_torch.infer.streaming import StreamingVocoder
from dissc_tpu_torch.models.hifigan import CodeGenerator
from dissc_tpu_torch.models.layers import fold_weight_norm
from dissc_tpu_torch.train.checkpoints import load_checkpoint, scan_checkpoint

DEFAULT_FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds ``n`` frames (longer items stream)."""
    return next(b for b in buckets if n <= b)


class VocoderEngine:
    """Bucketed batched HiFi-GAN synthesis.

    ``gen_state`` is a port ``CodeGenerator`` state dict (weight-normed or
    already folded, as ``h.folded_weights`` says).  ``device=None`` runs
    on the CUDA card and raises without one.
    """

    def __init__(self, h: VocoderConfig, gen_state: Dict[str, torch.Tensor],
                 frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
                 stream_chunk: int = 512, exact_lengths: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if not h.folded_weights:
            gen_state = fold_weight_norm(gen_state)
            h = dataclasses.replace(h, folded_weights=True)
        self.h = h
        self.model = CodeGenerator(h)
        self.model.load_state_dict(gen_state)
        self.model.to(self.device).eval()
        self.frame_buckets = tuple(frame_buckets)
        self.stream_chunk = stream_chunk
        self.exact_lengths = exact_lengths
        self._streamer: Optional[StreamingVocoder] = None

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, **kw) -> "VocoderEngine":
        """A directory (``config.json`` + latest ``g_*``) or one ``g_*`` file
        beside its ``config.json``."""
        if os.path.isdir(checkpoint_path):
            config_file = os.path.join(checkpoint_path, "config.json")
            cp_g = scan_checkpoint(checkpoint_path, "g_")
            if cp_g is None:
                raise FileNotFoundError(f"no g_???????? checkpoint in {checkpoint_path}")
        else:
            config_file = os.path.join(os.path.dirname(checkpoint_path), "config.json")
            cp_g = checkpoint_path
        h = VocoderConfig.from_json(config_file)
        state = load_checkpoint(cp_g)
        return cls(h, generator_state_dict(state["generator"], h), **kw)

    def _streamer_for_long(self) -> StreamingVocoder:
        if self._streamer is None:
            self._streamer = StreamingVocoder(self.model, chunk_frames=self.stream_chunk)
        return self._streamer

    @torch.inference_mode()
    def synthesize_batch(self, code: np.ndarray, f0: Optional[np.ndarray],
                         spkr: Optional[np.ndarray]) -> Tuple[np.ndarray, float]:
        """``[B, T]`` codes (+ f0 / spkr) -> (``[B, T*hop]`` waveform, rtf)."""
        start = time.time()
        dev = self.device
        y = self.model(torch.as_tensor(code, device=dev).long(),
                       None if f0 is None else torch.as_tensor(f0, device=dev),
                       None if spkr is None else torch.as_tensor(spkr, device=dev).long())
        y = y.cpu().numpy()
        rtf = (time.time() - start) / (y.size / self.h.sampling_rate)
        return y, rtf

    def synthesize_utterances(self, items: List[Dict[str, np.ndarray]], batch_size: int = 8
                              ) -> Tuple[List[np.ndarray], float]:
        """Bucket-pad and batch-synthesise variable-length utterances.

        ``items``: dicts with ``code`` [T], optional ``f0`` [Tf, 1] and
        ``spkr`` [1].  Returns waveforms cut to each true length and the
        mean RTF.
        """
        rates = [1] * len(items)
        norm_items: List[Dict[str, np.ndarray]] = []
        for i, it in enumerate(items):
            it = dict(it)
            if self.h.f0 and it.get("f0") is not None:
                ff = np.asarray(it["f0"], np.float32).reshape(-1)
                T = len(it["code"])
                r = max(1, int(round(len(ff) / max(T, 1))))
                if len(ff) != T * r:
                    buf = np.zeros(T * r, np.float32)
                    n = min(len(ff), T * r)
                    buf[:n] = ff[:n]
                    ff = buf
                it["f0"] = ff.reshape(-1, 1)
                rates[i] = r
            norm_items.append(it)
        items = norm_items

        out: List[Optional[np.ndarray]] = [None] * len(items)
        groups: Dict[Tuple[int, int], List[int]] = {}
        rtfs = []
        long_idx = []
        for i, it in enumerate(items):
            if len(it["code"]) > self.frame_buckets[-1]:
                long_idx.append(i)
            else:
                cap = (len(it["code"]) if self.exact_lengths
                       else _bucket(len(it["code"]), self.frame_buckets))
                groups.setdefault((cap, rates[i]), []).append(i)
        for i in long_idx:
            it = items[i]
            start = time.time()
            wav = self._streamer_for_long().synthesize(
                it["code"], it.get("f0") if self.h.f0 else None,
                it.get("spkr") if self.h.multispkr else None)
            out[i] = wav[: len(it["code"]) * rates[i] * self.h.code_hop_size]
            rtfs.append((time.time() - start) / (out[i].size / self.h.sampling_rate))
        for (cap, r), idxs in groups.items():
            for s in range(0, len(idxs), batch_size):
                chunk = idxs[s: s + batch_size]
                B = len(chunk)
                code = np.zeros((B, cap), np.int64)
                f0 = np.zeros((B, cap * r, 1), np.float32)
                spkr = np.zeros((B, 1), np.int64)
                for j, i in enumerate(chunk):
                    c = items[i]["code"]
                    code[j, : len(c)] = c
                    code[j, len(c):] = c[-1]  # edge-replicate padding
                    if items[i].get("f0") is not None:
                        ff = items[i]["f0"].reshape(-1)
                        f0[j, : len(ff), 0] = ff
                    if items[i].get("spkr") is not None:
                        spkr[j, 0] = items[i]["spkr"][0]
                y, rtf = self.synthesize_batch(
                    code, f0 if self.h.f0 else None, spkr if self.h.multispkr else None)
                rtfs.append(rtf)
                for j, i in enumerate(chunk):
                    out[i] = y[j, : len(items[i]["code"]) * r * self.h.code_hop_size]
        return out, float(np.mean(rtfs)) if rtfs else 0.0


def renorm_f0(f0: np.ndarray, spkr_id: int, spkr_name, f0_stats: Dict) -> np.ndarray:
    """Shift the source contour's voiced stats to the target speaker's
    (``dissc_tpu.infer.vocoder._renorm_f0``, reference ``sr/inference.py:220-235``)."""
    f0 = f0.copy()
    ii = f0 != 0
    if not ii.any():
        return f0
    mean_, std_ = f0[ii].mean(), f0[ii].std()
    stats = None
    for key in (spkr_id, spkr_name):
        if key in f0_stats:
            stats = f0_stats[key]
            break
    if stats is None:
        new_mean, new_std = f0_stats.get("f0_mean", mean_), f0_stats.get("f0_std", std_)
    else:
        new_mean = stats.get("f0_mean", stats.get("mean"))
        new_std = stats.get("f0_std", stats.get("std"))
    f0[ii] = (f0[ii] - mean_) / max(std_, 1e-8) * new_std + new_mean
    return f0
