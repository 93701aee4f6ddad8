"""Batched vocoder synthesis (``dissc_tpu.infer.vocoder.VocoderEngine``).

Behaviour of the JAX engine, on the card:

* weight norm is folded once at construction unless the state is folded
  already (the reference's ``remove_weight_norm``, ``sr/inference.py:160``),
  in float32; with ``compute_dtype`` bfloat16 (``config.json``) the folded
  weights stay float32 and each conv casts them, as the JAX engine's;
* utterances are padded to frame buckets ``(64 ... 2048)`` by
  edge-replicating the last code and zero-filling f0; outputs are cut to
  the true length.  With the generator's receptive field the padding
  perturbs only the final ~60 ms; ``exact_lengths=True`` synthesises each
  utterance at its own length;
* f0 is normalised to an integer multiple ``r`` of the code length
  (``r > 1`` is finer-rate conditioning: ``r*320`` samples per code
  frame) and batches are grouped by ``(bucket, r)``;
* utterances past the last bucket stream through
  :class:`~dissc_tpu_torch.infer.streaming.StreamingVocoder`;
* with ``devices=[...]`` (the JAX engine's ``mesh``) each batch is split
  into contiguous row blocks, one a device (padded to a multiple of the
  device count by repeating the last row, which is cut again), every
  block is launched before any is read back, and rows come back in input
  order; the streamed utterances are dealt round the devices, each
  streamed whole on one, the devices' streams running side by side.
  The generator is per-sample, so every waveform equals the one-device
  engine's.

``from_checkpoint`` reads ``config.json`` and the latest ``g_*`` pickle
written by either package's trainer (JAX tree layout).

:func:`run_inference` is the file-level driver of ``cli.sr_inference``
(reference ``sr/inference.py``): resynthesis, per-target voice conversion
and ground-truth copies written as WAVs.  Where the reference fans out
one worker process per GPU, one engine batches the utterances and splits
each batch over the cards it is given.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dissc_tpu_torch.compat.from_jax import generator_state_dict
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.core.wav import peak_normalize, write_wav
from dissc_tpu_torch.data.code_dataset import CodeDataset, parse_manifest
from dissc_tpu_torch.data.stats import load_f0_stats, read_pair_csv
from dissc_tpu_torch.device import DeviceLike, resolve_device
from dissc_tpu_torch.infer.streaming import StreamingVocoder
from dissc_tpu_torch.models.hifigan import CodeGenerator, refuse_f0_vq
from dissc_tpu_torch.models.layers import fold_weight_norm
from dissc_tpu_torch.parallel.mesh import gather_rows, on_devices, split_for_devices
from dissc_tpu_torch.train.checkpoints import load_checkpoint, scan_checkpoint

DEFAULT_FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds ``n`` frames (longer items stream)."""
    return next(b for b in buckets if n <= b)


class VocoderEngine:
    """Bucketed batched HiFi-GAN synthesis.

    ``gen_state`` is a port ``CodeGenerator`` state dict (weight-normed or
    already folded, as ``h.folded_weights`` says).  ``device=None`` runs
    on the CUDA card and raises without one.  ``devices``: split every
    batch over these (one replica of the generator a distinct device;
    ``device`` is then ignored).
    """

    def __init__(self, h: VocoderConfig, gen_state: Dict[str, torch.Tensor],
                 frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
                 stream_chunk: int = 512, exact_lengths: bool = False,
                 device: DeviceLike = None, devices: Optional[Sequence[DeviceLike]] = None):
        refuse_f0_vq(h, "VocoderEngine")
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if not h.folded_weights:
            gen_state = fold_weight_norm(gen_state)
            h = dataclasses.replace(h, folded_weights=True)
        self.h = h
        self.model = CodeGenerator(h)
        self.model.load_state_dict(gen_state)
        self.model.to(self.device).eval()
        replicas = {str(self.device): self.model}
        for d in self.devices[1:]:
            if str(d) not in replicas:
                replicas[str(d)] = copy.deepcopy(self.model).to(d).eval()
        self.replicas = [replicas[str(d)] for d in self.devices]  # one a device
        self.frame_buckets = tuple(frame_buckets)
        self.stream_chunk = stream_chunk
        self.exact_lengths = exact_lengths
        self._streamers: Dict[int, StreamingVocoder] = {}

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

    def _streamer_for_long(self, part: int = 0) -> StreamingVocoder:
        """The streamer of device ``part``'s replica."""
        if part not in self._streamers:
            self._streamers[part] = StreamingVocoder(self.replicas[part],
                                                     chunk_frames=self.stream_chunk)
        return self._streamers[part]

    def _launch(self, part: int, code: np.ndarray, f0: Optional[np.ndarray],
                spkr: Optional[np.ndarray]) -> torch.Tensor:
        """Enqueue rows on device ``part``; returns the unfetched waveform."""
        dev = self.devices[part]
        return self.replicas[part](
            torch.as_tensor(code, device=dev).long(),
            None if f0 is None else torch.as_tensor(f0, device=dev),
            None if spkr is None else torch.as_tensor(spkr, device=dev).long())

    @torch.inference_mode()
    def synthesize_batch(self, code: np.ndarray, f0: Optional[np.ndarray],
                         spkr: Optional[np.ndarray]) -> Tuple[np.ndarray, float]:
        """``[B, T]`` codes (+ f0 / spkr) -> (``[B, T*hop]`` waveform, rtf);
        split over the engine's devices when it has several."""
        start = time.time()
        if len(self.devices) == 1:
            y = self._launch(0, code, f0, spkr).cpu().numpy()
        else:
            parts, rows = split_for_devices((code, f0, spkr), len(self.devices))
            pending = [self._launch(i, *part) for i, part in enumerate(parts)]
            y = gather_rows([p.cpu().numpy() for p in pending], rows)
        rtf = (time.time() - start) / (y.size / self.h.sampling_rate)
        return y, rtf

    def _stream(self, part: int, idxs: List[int], items: List[Dict[str, np.ndarray]],
                rates: List[int]) -> List[Tuple[np.ndarray, float]]:
        """Stream items ``idxs`` whole on device ``part``: (waveform, rtf) each."""
        out = []
        for i in idxs:
            it = items[i]
            start = time.time()
            wav = self._streamer_for_long(part).synthesize(
                it["code"], it.get("f0") if self.h.f0 else None,
                it.get("spkr") if self.h.multispkr else None)
            wav = wav[: len(it["code"]) * rates[i] * self.h.code_hop_size]
            out.append((wav, (time.time() - start) / (wav.size / self.h.sampling_rate)))
        return out

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
        # long utterances dealt round the devices, each device streaming its own
        n_dev = len(self.devices)
        dealt = [(p, long_idx[p::n_dev]) for p in range(n_dev) if long_idx[p::n_dev]]
        streamed = on_devices(lambda p, idxs: self._stream(p, idxs, items, rates), dealt)
        for (_, idxs), results in zip(dealt, streamed):
            for i, (wav, rtf) in zip(idxs, results):
                out[i] = wav
                rtfs.append(rtf)
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


def parse_code_file(code_file: str):
    """Raw-code manifest: ``name|u0 u1 u2 ...`` per line (the reference's
    ``--code_file`` mode, ``sr/inference.py:122-129``) -> (items, names)."""
    items, names = [], []
    with open(code_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, codes = line.split("|")
            items.append({"code": np.asarray([int(v) for v in codes.split(" ")], np.int64)})
            names.append(name)
    return items, names


def _write(output_dir: str, name: str, wav: np.ndarray, sr: int) -> None:
    write_wav(os.path.join(output_dir, name), peak_normalize(wav), sr)


def run_inference(
    checkpoint_file: str,
    input_code_file: str,
    output_dir: str,
    data_path: Optional[str] = None,
    vc: bool = False,
    target_speakers: Optional[List[str]] = None,
    f0_stats_path: Optional[str] = None,
    unseen_speaker: bool = False,
    id_to_spkr_path: Optional[str] = None,
    pad: Optional[int] = None,
    n: int = -1,
    batch_size: int = 8,
    code_file: Optional[str] = None,
    unseen_f0_path: Optional[str] = None,
    sample_df_path: Optional[str] = None,
    parts: bool = False,
    device: DeviceLike = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> float:
    """File-level driver (``dissc_tpu.infer.vocoder.run_inference``).  Writes
    ``<name>_gen.wav`` (resynthesis with the source speaker),
    ``<name>_<k>_gen.wav`` (voice conversion to speaker id ``k``) and
    ``<name>_gt.wav`` (the ground truth), each peak-normalised, and returns
    the mean RTF.  ``sample_df_path`` is the speaker-verification pair CSV:
    only its (sample, target) pairs are converted, with no resynthesis and
    no ground truth.  ``device=None`` runs on the CUDA card and raises
    without one; ``devices`` splits each batch over several."""
    engine = VocoderEngine.from_checkpoint(checkpoint_file, device=device, devices=devices)
    h = engine.h
    os.makedirs(output_dir, exist_ok=True)

    if code_file is not None:
        # raw-code mode: units only, no ground truth, f0 or speakers
        items, names = parse_code_file(code_file)
        wavs, rtf = engine.synthesize_utterances(items[: n if n != -1 else None], batch_size)
        for name, wav in zip(names, wavs):
            _write(output_dir, f"{Path(name).stem}_gen.wav", wav, h.sampling_rate)
        return rtf

    base_path = data_path if data_path is not None else h.test_base_path
    file_list = parse_manifest(input_code_file, base_path)
    if unseen_speaker:
        id_to_spkr = load_checkpoint(id_to_spkr_path)
    else:
        id_to_spkr = None
        default_ids = os.path.join(os.path.dirname(h.input_training_file), "id_to_spkr.pkl")
        if os.path.exists(default_ids):
            id_to_spkr = load_checkpoint(default_ids)

    stats_for_norm = load_f0_stats(h.f0_stats) if h.f0_normalize and h.f0_stats else None
    if unseen_f0_path:
        # the unseen speaker's own stats (reference ``sr/inference.py:148-149``)
        stats_for_norm = load_f0_stats(unseen_f0_path)
    dataset = CodeDataset(
        file_list, -1, h.code_hop_size, h.sampling_rate, multispkr=h.multispkr, f0=h.f0,
        f0_stats=stats_for_norm, f0_normalize=h.f0_normalize, f0_median=h.f0_median, pad=pad,
        id_to_spkr=id_to_spkr, eval_mode=True, unseen_speakers=unseen_speaker,
        f0_device=engine.device)
    f0_stats = load_f0_stats(f0_stats_path) if f0_stats_path else None
    pairs = read_pair_csv(sample_df_path) if sample_df_path else None

    n_items = len(dataset) if n == -1 else min(n, len(dataset))
    items, names = [], []
    for i in range(n_items):
        feats = dataset[i]
        items.append(feats)
        if parts:
            # the last 3 path parts (reference ``sr/inference.py:180-182``)
            names.append("_".join(Path(feats["filename"]).parts[-3:])[:-4])
        else:
            names.append(Path(feats["filename"]).stem)

    rtfs = []
    # resynthesis with the source speaker: not for unseen speakers and not
    # in pair mode (reference ``sr/inference.py:203``)
    if not unseen_speaker and pairs is None:
        wavs, rtf = engine.synthesize_utterances(items, batch_size)
        rtfs.append(rtf)
        for name, wav in zip(names, wavs):
            _write(output_dir, f"{name}_gen.wav", wav, h.sampling_rate)

    if vc and h.multispkr:
        targets = target_speakers or list(dataset.id_to_spkr)[:5]
        for t in targets:
            k = dataset.spkr_to_id[t] if isinstance(t, str) else int(t)
            t_name = t if isinstance(t, str) else dataset.id_to_spkr[k]
            vc_items, vc_names = [], []
            for it, name in zip(items, names):
                if pairs is not None and t_name not in pairs.get(name.split("_mic2")[0], ()):
                    continue
                new_it = dict(it, spkr=np.array([k], np.int32))
                if f0_stats is not None and h.f0 and not h.f0_normalize:
                    new_it["f0"] = renorm_f0(it["f0"], k, t, f0_stats)
                vc_items.append(new_it)
                vc_names.append(name)
            if not vc_items:
                continue
            wavs, rtf = engine.synthesize_utterances(vc_items, batch_size)
            rtfs.append(rtf)
            for name, wav in zip(vc_names, wavs):
                _write(output_dir, f"{name}_{k}_gen.wav", wav, h.sampling_rate)

    if pairs is None:
        for name, it in zip(names, items):
            _write(output_dir, f"{name}_gt.wav", it["audio"], h.sampling_rate)
    return float(np.mean(rtfs)) if rtfs else 0.0
