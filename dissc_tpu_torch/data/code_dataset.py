"""Vocoder training/eval dataset and the F0 quantizer's dataset
(``dissc_tpu.data.code_dataset``; host numpy).

Reference ``sr/dataset.py:107-325`` (CodeDataset): per item it
  * loads a 16 kHz wav (int16 -> /32768 -> peak-normalize -> *0.95),
  * aligns code/audio lengths on the 320-sample code hop,
  * tile-repeats short clips up to ``segment_size``,
  * samples one LCM-aligned random interval across (audio, code, f0),
  * optionally whitens f0 by speaker stats,
and serves fixed-shape batches.  The mel-loss target is *not* computed
here: the training step computes it on the device, keeping the host loop
pure I/O.

Two differences from the JAX package, both about failures:

* the native crop path (``batches(use_native=True)``) raises if the C++
  loader cannot be built, where the JAX package quietly takes its numpy
  path;
* the YAAPT fallback for a crop without manifest pitch runs the port's
  :func:`~dissc_tpu_torch.audio.yaapt.yaapt_f0` on ``f0_device`` and
  catches nothing.  The one input the JAX tracker cannot take is a
  sampling rate whose Nyquist frequency is at or under its band-pass's
  1500 Hz edge (scipy's ``firwin`` raises ``ValueError``); the dataset
  decides that from its rate once and gives such crops zero f0.  The JAX
  package catches every exception and trains on zero f0; here every error
  of the tracker, a CUDA or build error included, propagates.

And one about the fallback's rate in training mode: the JAX package
returns YAAPT's 5 ms track (4 values a code frame at 16 kHz), which the
LUT generator answers with a waveform 4 times the segment, so its train
and validation steps fail on mismatched mel shapes.  The port pools the
track to the code rate as the unit encoder does, giving the f0 a manifest
would carry.  In eval mode (whole utterances, for ``run_inference``) it
returns the 5 ms track as the JAX package does: ``VocoderEngine`` groups
such items by their f0 rate and synthesises ``r * hop`` samples a code
frame, the reference generator's finer-rate conditioning.

Speaker parsing matches ``parse_speaker`` (``sr/dataset.py:132-147``);
``id_to_spkr`` ordering matches the sorted-unique convention
(``sr/dataset.py:192-197``).
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dissc_tpu_torch.core.wav import normalize_audio_int16, read_wav
from dissc_tpu_torch.audio import yaapt
from dissc_tpu_torch.device import DeviceLike


def parse_speaker(path, method) -> str:
    if isinstance(path, str):
        path = Path(path)
    if method == "parent_name":
        return path.parent.name
    if method == "parent_parent_name":
        return path.parent.parent.name
    if method == "_":
        return path.name.split("_")[0]
    if method == "single":
        return "A"
    if callable(method):
        return method(path)
    raise NotImplementedError(method)


def parse_manifest(manifest: str, base_path: str):
    """Manifest -> (audio_files, codes, pitch).  JSONL lines carry
    units/f0; bare lines are wav paths (reference ``sr/dataset.py:107-122``)."""
    audio_files, codes, pitch = [], [], []
    with open(manifest) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line[0] == "{":
                sample = json.loads(line)
                codes.append(np.asarray(sample["units"], np.int64))
                audio_files.append(Path(base_path + "/" + sample["audio"].split("/")[-1]))
                if "f0" in sample:
                    pitch.append(np.asarray(sample["f0"], np.float32))
            else:
                audio_files.append(Path(line))
    return audio_files, codes, pitch


def get_dataset_filelist(h):
    train = parse_manifest(h.input_training_file, h.train_base_path)
    val = parse_manifest(h.input_validation_file, h.val_base_path)
    return train, val


class CodeDataset:
    def __init__(
        self,
        files: Tuple[List, List, List],
        segment_size: int,
        code_hop_size: int,
        sampling_rate: int,
        multispkr: Optional[str] = "_",
        f0: bool = True,
        f0_stats: Optional[Dict] = None,
        f0_normalize: bool = False,
        f0_median: bool = False,
        pad: Optional[int] = None,
        id_to_spkr: Optional[List[str]] = None,
        eval_mode: bool = False,
        unseen_speakers: bool = False,
        seed: int = 1234,
        f0_device: DeviceLike = None,
    ):
        """``pad``: zero-pad each waveform up to the next multiple of ``pad``
        samples (by a whole ``pad`` when it is one already, as the reference
        does).  ``eval_mode``: whole utterances, codes and pitch uncut, f0
        of the fallback at YAAPT's 5 ms rate.  ``unseen_speakers``: every
        item gets speaker 0.  ``f0_device``: where the YAAPT fallback runs
        (``None``: the CUDA card, raising without one)."""
        self.audio_files, self.codes, self.pitch = files
        self.segment_size = segment_size
        self.code_hop_size = code_hop_size
        self.sampling_rate = sampling_rate
        self.multispkr = multispkr
        self.f0 = f0
        self.f0_stats = f0_stats
        self.f0_normalize = f0_normalize
        self.f0_median = f0_median
        self.pad = pad
        self.eval_mode = eval_mode
        self.unseen_speakers = unseen_speakers
        self._rng = random.Random(seed)
        self.f0_device = f0_device
        # YAAPT's band-pass needs a Nyquist frequency above its upper edge;
        # scipy's firwin refuses the design otherwise
        self._yaapt_takes_rate = sampling_rate / 2 > yaapt.BAND_HZ[1]

        if self.multispkr:
            if id_to_spkr:
                self.id_to_spkr = list(id_to_spkr)
            else:
                spkrs = sorted({parse_speaker(f, self.multispkr) for f in self.audio_files})
                self.id_to_spkr = spkrs
            self.spkr_to_id = {k: v for v, k in enumerate(self.id_to_spkr)}

    def __len__(self) -> int:
        return len(self.audio_files)

    def _load_audio(self, filename) -> np.ndarray:
        audio, sr = read_wav(str(filename), dtype="int16")
        if sr != self.sampling_rate:
            from dissc_tpu_torch.audio.resample import resample_poly_np

            audio = resample_poly_np(audio.astype(np.float64), sr, self.sampling_rate)
        if self.pad:
            audio = np.pad(audio, (0, self.pad - audio.shape[-1] % self.pad), "constant")
        return normalize_audio_int16(audio)

    def _sample_interval(self, seqs: Sequence[np.ndarray], seq_len: Optional[int] = None):
        """Pick one aligned random crop across signals at different hop
        rates (reference ``sr/dataset.py:199-219``)."""
        N = max(v.shape[-1] for v in seqs)
        if seq_len is None:
            seq_len = self.segment_size if self.segment_size > 0 else N
        hops = [N // v.shape[-1] for v in seqs]
        lcm = np.lcm.reduce(hops)
        interval_end = N // lcm - seq_len // lcm
        start_step = self._rng.randint(0, interval_end)
        new_seqs = []
        for i, v in enumerate(seqs):
            start = start_step * (lcm // hops[i])
            end = (start_step + seq_len // lcm) * (lcm // hops[i])
            new_seqs.append(v[..., start:end])
        return new_seqs

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        filename = self.audio_files[index]
        audio = self._load_audio(filename)
        code = self.codes[index]
        if not self.eval_mode:
            code_length = min(audio.shape[0] // self.code_hop_size, code.shape[0])
            code = code[:code_length]
            audio = audio[: code_length * self.code_hop_size]
            pitch = self.pitch[index][:code_length] if self.pitch else np.zeros(0, np.float32)
            assert audio.shape[0] // self.code_hop_size == code.shape[0], "Code audio mismatch"
        else:
            pitch = self.pitch[index] if self.pitch else np.zeros(0, np.float32)

        # tile-repeat short clips to the training segment
        while audio.shape[0] < self.segment_size:
            audio = np.hstack([audio, audio])
            code = np.hstack([code, code])
            pitch = np.hstack([pitch, pitch])

        if self.eval_mode:
            feats_audio = audio.astype(np.float32)
        elif pitch.shape[0]:
            audio_c, code, pitch = self._sample_interval(
                [audio[None, :], code, pitch]
            )
            feats_audio = audio_c[0].astype(np.float32)
        else:
            # no manifest pitch: crop (audio, code) only; the YAAPT fallback
            # below computes f0 on the crop (reference sr/dataset.py:280-289)
            audio_c, code = self._sample_interval([audio[None, :], code])
            feats_audio = audio_c[0].astype(np.float32)

        feats: Dict[str, np.ndarray] = {"code": code.astype(np.int32)}
        if self.f0:
            if pitch.shape[0] != 0:
                f0 = pitch.reshape(-1, 1).astype(np.float32)
            else:
                f0 = self._yaapt(feats_audio)
            feats["f0"] = f0

        if self.multispkr:
            spkr = 0 if self.unseen_speakers else self.spkr_to_id[
                parse_speaker(filename, self.multispkr)]
            feats["spkr"] = np.array([spkr], np.int32)

        if self.f0_normalize and self.f0:
            spkr_name = parse_speaker(filename, self.multispkr)
            if self.f0_stats is None or spkr_name not in self.f0_stats:
                mean = self.f0_stats["f0_mean"] if self.f0_stats else 0.0
                std = self.f0_stats["f0_std"] if self.f0_stats else 1.0
            else:
                mean = self.f0_stats[spkr_name]["mean"]
                std = self.f0_stats[spkr_name]["std"]
            f0 = feats["f0"]
            ii = f0 != 0
            if self.f0_median:
                med = np.median(f0[ii]) if ii.any() else 0.0
                f0[~ii] = med
                f0[~ii] = (f0[~ii] - mean) / std
            f0[ii] = (f0[ii] - mean) / std
            feats["f0"] = f0

        feats["audio"] = feats_audio
        feats["filename"] = str(filename)
        return feats

    def _yaapt(self, audio: np.ndarray) -> np.ndarray:
        """``[F, 1]`` f0 of one crop at the code rate: YAAPT's 5 ms track
        pooled per code frame as the unit encoder pools it
        (:func:`~dissc_tpu_torch.audio.yaapt.f0_per_unit`), so the crop's f0
        is what a manifest would carry; in eval mode the 5 ms track itself.
        Zeros at a sampling rate the tracker cannot take (in eval mode one
        per 80 samples, as the JAX fallback); every error of the tracker
        propagates."""
        frames = audio.shape[0] // self.code_hop_size
        if not self._yaapt_takes_rate:
            n = audio.shape[0] // 80 if self.eval_mode else frames
            return np.zeros((n, 1), np.float32)
        f0_5ms = yaapt.yaapt_f0(audio, self.sampling_rate, device=self.f0_device)
        if self.eval_mode:
            return f0_5ms.reshape(-1, 1).astype(np.float32)
        per = self.code_hop_size * 200 // self.sampling_rate  # 5 ms frames a code frame
        return yaapt.f0_per_unit(f0_5ms, frames, per).reshape(-1, 1)

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                use_native: bool = True, process_index: int = 0, process_count: int = 1,
                drop_last: bool = True) -> Iterator[Dict]:
        """Fixed-shape stacked batches (training mode only).

        ``use_native``: route the audio crops through the C++ threaded
        loader (``native/wavloader.cc``; raises if it cannot be built) —
        crop *sampling* stays here so the draw sequence is identical on
        both paths; only decode/normalise/copy moves to native threads.
        With ``pad`` set the batches take the Python path, as in the JAX
        package (the native loader does not pad).

        ``process_index``/``process_count``: data-parallel sharding, as in
        the JAX package (the reference's ``DistributedSampler``,
        ``sr/train.py:102``).  Every rank shuffles the same epoch order,
        pads it by wrap-around to a multiple of ``process_count`` and takes
        its strided slice; ``batch_size`` is the rank's batch.  With a
        rank batch of ``B / W``, step k on all ranks together covers
        ``order[kB:(k+1)B]``.  Each rank draws its own crops.
        """
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if process_count > 1:
            total = -(-len(order) // process_count) * process_count
            order = np.resize(order, total)[process_index::process_count]
        if not drop_last and len(order) % batch_size:
            # wrap-around pad the final partial batch to the fixed batch
            # shape; callers that need exact per-item semantics trim the
            # duplicated tail (validation keeps the first len(dataset) errors)
            order = np.resize(order, -(-len(order) // batch_size) * batch_size)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[start : start + batch_size]
            if not use_native or self.pad is not None:
                items = [self[i] for i in idxs]
                batch = {
                    "code": np.stack([it["code"] for it in items]),
                    "spkr": np.stack([it["spkr"] for it in items]),
                    "audio": np.stack([it["audio"] for it in items]),
                }
                if self.f0:
                    batch["f0"] = np.stack([it["f0"] for it in items])
                yield batch
                continue
            yield self._native_batch(idxs)

    def _native_batch(self, idxs) -> Dict[str, np.ndarray]:
        from dissc_tpu_torch.data.native_loader import load_crops, wav_info

        seg = self.segment_size
        seg_frames = seg // self.code_hop_size
        paths, starts, eff_lens = [], [], []
        codes, f0s, spkrs = [], [], []
        fallback_audio = {}
        yaapt_rows = []  # rows needing F0 computed from the crop (no manifest pitch)
        for j, i in enumerate(idxs):
            path = str(self.audio_files[i])
            sr, n = wav_info(path)
            if sr != self.sampling_rate:
                # fall back to the python path for resampled files
                it = self[i]
                paths.append(None)
                starts.append(0)
                eff_lens.append(-1)
                codes.append(it["code"])
                f0s.append(it.get("f0"))
                spkrs.append(it["spkr"])
                fallback_audio[j] = it["audio"]
                continue
            code = self.codes[i]
            pitch = self.pitch[i] if self.pitch else np.zeros(0, np.float32)
            code_length = min(n // self.code_hop_size, code.shape[0])
            code = code[:code_length]
            pitch = pitch[:code_length]
            eff = code_length * self.code_hop_size
            # tile-repeat short clips (modulo on the native side)
            tiled = eff
            while tiled < seg:
                code = np.hstack([code, code])
                pitch = np.hstack([pitch, pitch])
                tiled *= 2
            # aligned random crop (same draw as _sample_interval: lcm = hop)
            n_steps = tiled // self.code_hop_size - seg_frames
            start_step = self._rng.randint(0, n_steps)
            paths.append(path)
            starts.append(start_step * self.code_hop_size)
            eff_lens.append(eff)
            codes.append(code[start_step : start_step + seg_frames].astype(np.int32))
            if self.f0 and pitch.shape[0] == 0:
                # no manifest pitch: compute YAAPT on the crop once loaded,
                # mirroring __getitem__'s fallback (reference sr/dataset.py:280-289)
                yaapt_rows.append(j)
                f0s.append(None)
            else:
                f0s.append(pitch[start_step : start_step + seg_frames]
                           .reshape(-1, 1).astype(np.float32))
            spkr_name = parse_speaker(self.audio_files[i], self.multispkr)
            spkrs.append(np.array(
                [0 if self.unseen_speakers else self.spkr_to_id[spkr_name]], np.int32))

        native_rows = [j for j, p in enumerate(paths) if p is not None]
        audio = np.zeros((len(idxs), seg), np.float32)
        for j, a in fallback_audio.items():
            audio[j] = a[:seg]
        if native_rows:
            crops = load_crops([paths[j] for j in native_rows],
                               [starts[j] for j in native_rows], seg,
                               [eff_lens[j] for j in native_rows])
            for k, j in enumerate(native_rows):
                audio[j] = crops[k]
        for j in yaapt_rows:
            f0s[j] = self._yaapt(audio[j])
        if not self.f0:
            f0s = [None] * len(idxs)
        elif self.f0_normalize:
            for j in range(len(idxs)):
                f0s[j] = self._normalize_f0(f0s[j], self.audio_files[idxs[j]])
        batch = {
            "code": np.stack(codes),
            "spkr": np.stack(spkrs),
            "audio": audio,
        }
        if self.f0:
            batch["f0"] = np.stack(f0s)
        return batch

    def _normalize_f0(self, f0: np.ndarray, filename) -> np.ndarray:
        spkr_name = parse_speaker(filename, self.multispkr)
        if self.f0_stats is None or spkr_name not in self.f0_stats:
            mean = self.f0_stats["f0_mean"] if self.f0_stats else 0.0
            std = self.f0_stats["f0_std"] if self.f0_stats else 1.0
        else:
            mean = self.f0_stats[spkr_name]["mean"]
            std = self.f0_stats[spkr_name]["std"]
        f0 = f0.copy()
        ii = f0 != 0
        if self.f0_median and ii.any():
            med = np.median(f0[ii])
            f0[~ii] = med
            f0[~ii] = (f0[~ii] - mean) / std
        f0[ii] = (f0[ii] - mean) / std
        return f0


class F0Dataset:
    """F0 contours of random crops, for F0-VQVAE quantizer training
    (``dissc_tpu.data.code_dataset.F0Dataset``; reference
    ``sr/dataset.py:328-449``): the same ``random.Random(seed)`` crops, short
    files tiled to ``segment_size``, YAAPT's 5 ms f0 per crop (on
    ``f0_device``), and optional whitening by stats keyed by speaker *id*
    with ``f0_mean`` / ``f0_std`` (unvoiced frames first filled with the
    voiced median when ``f0_median``).

    As in :class:`CodeDataset`, the tracker's failures are not caught: the
    dataset decides from its sampling rate whether YAAPT's band-pass can
    be built (zeros, one per 80 samples, where it cannot), and every other
    error propagates; the JAX package catches every exception and returns
    zeros."""

    def __init__(self, files, segment_size, sampling_rate, multispkr="_",
                 f0_stats=None, f0_normalize=False, f0_median=False,
                 f0_interp=False, pad=None, seed=1234, f0_device: DeviceLike = None):
        self.audio_files = files[0] if isinstance(files, tuple) else files
        self.segment_size = segment_size
        self.sampling_rate = sampling_rate
        self.multispkr = multispkr
        self.f0_stats = f0_stats
        self.f0_normalize = f0_normalize
        self.f0_median = f0_median
        self.f0_interp = f0_interp
        self.pad = pad
        self.f0_device = f0_device
        self._rng = random.Random(seed)
        self._yaapt_takes_rate = sampling_rate / 2 > yaapt.BAND_HZ[1]
        if self.multispkr:
            spkrs = sorted({parse_speaker(f, self.multispkr) for f in self.audio_files})
            self.id_to_spkr = spkrs
            self.spkr_to_id = {k: v for v, k in enumerate(spkrs)}

    def __len__(self) -> int:
        return len(self.audio_files)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        filename = self.audio_files[index]
        audio, sr = read_wav(str(filename), dtype="int16")
        if self.pad:
            audio = np.pad(audio, (0, self.pad - audio.shape[-1] % self.pad), "constant")
        if sr != self.sampling_rate:
            raise ValueError(f"{sr} SR doesn't match target {self.sampling_rate} SR")
        audio = normalize_audio_int16(audio)

        while audio.shape[0] < self.segment_size:
            audio = np.hstack([audio, audio])
        start = self._rng.randint(0, max(audio.shape[0] - self.segment_size, 0))
        audio = audio[start: start + self.segment_size].astype(np.float32)

        if self._yaapt_takes_rate:
            f0 = yaapt.yaapt_f0(audio, self.sampling_rate, interp=self.f0_interp,
                                device=self.f0_device)
        else:
            f0 = np.zeros(audio.shape[0] // 80, np.float32)
        feats: Dict[str, np.ndarray] = {"f0": f0.reshape(-1, 1).astype(np.float32)}

        if self.multispkr:
            spkr_id = self.spkr_to_id[parse_speaker(filename, self.multispkr)]
            feats["spkr"] = np.array([spkr_id], np.int32)

        if self.f0_normalize:
            sid = int(feats["spkr"][0]) if self.multispkr else 0
            if self.f0_stats is None or sid not in self.f0_stats:
                mean = self.f0_stats["f0_mean"] if self.f0_stats else 0.0
                std = self.f0_stats["f0_std"] if self.f0_stats else 1.0
            else:
                mean = self.f0_stats[sid]["f0_mean"]
                std = self.f0_stats[sid]["f0_std"]
            f0 = feats["f0"]
            ii = f0 != 0
            if self.f0_median and ii.any():
                f0[~ii] = np.median(f0[ii])
                f0[~ii] = (f0[~ii] - mean) / std
            f0[ii] = (f0[ii] - mean) / std

        feats["audio"] = audio
        feats["filename"] = str(filename)
        return feats
