"""Prosody conversion ("infer") engine (``dissc_tpu.infer.prosody``).

The conversion — dedup -> rhythm predict -> carryover rounding ->
re-timing -> pitch predict — runs batched over capacity-padded ``[B, C]``
tensors on the entry point's device (``core.seqops``), grouped into
length buckets ``(128, 256, 512, 850, 1280)`` with an output capacity of
``expand_factor`` (2.0) times the bucket.  The JAX package vmaps the
rhythm stage per sample; BatchNorm runs in eval mode and every block is
length-masked, so running it on the whole batch gives the same result.
The carryover scan runs on a host copy (see ``len_carryover_correction``).
With ``devices=[...]`` (the JAX converter's ``mesh``) each batch is split
into contiguous row blocks, one a device, padded to a multiple of the
device count by repeating the last row; each block converts on its own
thread (its carryover scan still on the host, per row) and rows come back
in order.  Every row is converted alone, so the split changes no number.

Outputs follow the JSONL contract (``{"units", "f0", "audio"}``).
"""
from __future__ import annotations

import copy
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dissc_tpu_torch.compat.from_jax import len_predictor_state_dict, pitch_predictor_state_dict
from dissc_tpu_torch.core.masking import length_mask
from dissc_tpu_torch.core.seqops import (
    dedup_padded,
    dedup_seq,
    len_carryover_correction,
    morph_seq_len,
    repeat_interleave_padded,
)
from dissc_tpu_torch.data.jsonl import append_unit_record, iter_unit_records
from dissc_tpu_torch.data.stats import (
    load_f0_stats,
    load_id_to_spkr,
    prep_stats_arrays,
    read_pair_csv,
)
from dissc_tpu_torch.device import DeviceLike, resolve_device
from dissc_tpu_torch.models.prosody import LenPredictor, calc_freq
from dissc_tpu_torch.parallel.mesh import gather_rows, on_devices, split_for_devices
from dissc_tpu_torch.train.checkpoints import load_checkpoint
from dissc_tpu_torch.train.prosody_trainer import build_pitch_model

DEFAULT_BUCKETS = (128, 256, 512, 850, 1280)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@torch.inference_mode()
def _convert_batch(len_model: Optional[LenPredictor], len_norm_stats: Tuple[float, float],
                   pitch_model, id2mean: torch.Tensor, id2std: torch.Tensor,
                   seqs: torch.Tensor, lengths: torch.Tensor, spk_ids: torch.Tensor, *,
                   in_cap: int, out_cap: int, norm_pitch: bool, n_tokens: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[B, in_cap]`` padded unit rows, ``[B]`` lengths, ``[B, 1]`` speakers
    -> (``[B, out_cap]`` units, ``[B]`` true output lengths, ``[B, out_cap]``
    f0, zero past each length), on the inputs' device."""
    B = seqs.shape[0]
    dev = seqs.device
    if len_model is not None:
        vals, _, n_runs = dedup_padded(seqs, lengths, in_cap, n_tokens)
        run_mask = length_mask(n_runs, in_cap)
        lens_pred = len_model(vals, spk_ids, len_norm_stats, length_mask=run_mask)
        lens_int = len_carryover_correction(lens_pred, run_mask)
        out_seqs, out_lens = repeat_interleave_padded(vals, lens_int, out_cap, n_tokens)
    else:
        n = min(in_cap, out_cap)
        out_seqs = torch.full((B, out_cap), n_tokens, dtype=seqs.dtype, device=dev)
        out_seqs[:, :n] = torch.where(length_mask(lengths, n), seqs[:, :n], n_tokens)
        out_lens = lengths

    if pitch_model is not None:
        out_mask = length_mask(out_lens, out_cap)
        masked_seqs = torch.where(out_mask, out_seqs, n_tokens)
        cls_p, reg_p = pitch_model(masked_seqs, spk_ids, length_mask=out_mask)
        f0 = calc_freq(cls_p, reg_p, spk_ids, id2mean, id2std, norm=norm_pitch)
        f0 = torch.where(out_mask, f0, 0.0)
    else:
        f0 = torch.zeros(out_seqs.shape, dtype=torch.float32, device=dev)
    return out_seqs, out_lens, f0


class ProsodyConverter:
    """Loads prosody checkpoints and converts unit records in bucketed
    batches (reference ``infer.py:66-84``: the rhythm model with its
    ``len_norm_stats``, the pitch model by type).  ``device=None`` runs on
    the CUDA card and raises without one; ``devices`` splits each batch
    over several (``device`` is then ignored)."""

    def __init__(self, n_tokens: int = 100, expand_factor: float = 2.0,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, device: DeviceLike = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.n_tokens = n_tokens
        self.expand_factor = expand_factor
        self.buckets = buckets
        self.truncation_count = 0  # conversions clipped by expand_factor
        self.len_model: Optional[LenPredictor] = None
        self.len_norm_stats = (0.0, 1.0)
        self.pitch_model = None
        self.id2pitch_mean: Optional[np.ndarray] = None
        self.id2pitch_std: Optional[np.ndarray] = None
        self._replicas: Dict[str, Tuple] = {}  # device -> (len model, pitch model)

    @classmethod
    def load(cls, n_speakers: int, len_model_dir: Optional[str] = None,
             f0_model_dir: Optional[str] = None, f0_model_type: str = "new",
             id2pitch_mean: Optional[np.ndarray] = None,
             id2pitch_std: Optional[np.ndarray] = None, n_tokens: int = 100,
             device: DeviceLike = None,
             devices: Optional[Sequence[DeviceLike]] = None) -> "ProsodyConverter":
        """Reads the JAX package's checkpoint dirs: ``best_model.pth`` (a
        pickle of ``{params, batch_stats}``) and, for the rhythm model,
        ``len_norm_stats.pth`` (mean, std)."""
        self = cls(n_tokens=n_tokens, device=device, devices=devices)
        if len_model_dir:
            variables = load_checkpoint(os.path.join(len_model_dir, "best_model.pth"))
            model = LenPredictor(n_tokens=n_tokens, n_speakers=n_speakers)
            model.load_state_dict(len_predictor_state_dict(variables))
            mean, std = load_checkpoint(os.path.join(len_model_dir, "len_norm_stats.pth"))
            self.set_models(len_model=model, len_norm_stats=(float(mean), float(std)))
        if f0_model_dir:
            variables = load_checkpoint(os.path.join(f0_model_dir, "best_model.pth"))
            model = build_pitch_model(f0_model_type, n_tokens, n_speakers)
            model.load_state_dict(pitch_predictor_state_dict(variables, f0_model_type))
            self.set_models(pitch_model=model)
        self.id2pitch_mean = id2pitch_mean
        self.id2pitch_std = id2pitch_std
        return self

    def set_models(self, len_model: Optional[LenPredictor] = None,
                   len_norm_stats: Tuple[float, float] = (0.0, 1.0), pitch_model=None) -> None:
        """Install models (moved to the device, eval mode); ``None`` keeps
        what is there."""
        if len_model is not None:
            self.len_model = len_model.to(self.device).eval()
            # float32 values, as the JAX package holds them
            self.len_norm_stats = tuple(float(np.float32(v)) for v in len_norm_stats)
        if pitch_model is not None:
            self.pitch_model = pitch_model.to(self.device).eval()
        self._replicas = {}

    def _models_on(self, dev: torch.device) -> Tuple:
        """(len model, pitch model) on ``dev``: the installed ones on the
        first device, copies elsewhere (made once)."""
        if dev == self.device:
            return self.len_model, self.pitch_model
        if str(dev) not in self._replicas:
            copy_to = lambda m: None if m is None else copy.deepcopy(m).to(dev).eval()  # noqa: E731
            self._replicas[str(dev)] = (copy_to(self.len_model), copy_to(self.pitch_model))
        return self._replicas[str(dev)]

    def _convert_on(self, dev: torch.device, seqs: np.ndarray, lengths: np.ndarray,
                    spk: np.ndarray, id2mean: np.ndarray, id2std: np.ndarray, **kw
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One block of rows through :func:`_convert_batch` on ``dev``, read back."""
        len_model, pitch_model = self._models_on(dev)
        out = _convert_batch(len_model, self.len_norm_stats, pitch_model,
                             torch.as_tensor(id2mean, device=dev),
                             torch.as_tensor(id2std, device=dev),
                             *(torch.as_tensor(a, device=dev) for a in (seqs, lengths, spk)),
                             **kw)
        return tuple(a.cpu().numpy() for a in out)

    def convert_records(self, records: List[Dict], spk_id_dict: Dict[str, int],
                        target_speaker: Optional[str] = None, norm_pitch: bool = False,
                        batch_size: int = 32) -> List[Dict]:
        """Convert unit records to (optionally) a target speaker's prosody.

        ``target_speaker=None`` reconstructs with each record's own speaker
        (the filename prefix before ``_``); otherwise the speaker id is
        overridden (the VC path, reference ``infer.py:121-122``).  Returns
        new records in order."""
        out: List[Dict] = [None] * len(records)
        groups: Dict[int, List[int]] = {}
        for i, rec in enumerate(records):
            n_units = sum(1 for u in rec["units"] if u != self.n_tokens)
            groups.setdefault(_bucket(n_units, self.buckets), []).append(i)

        # without stats every speaker reads mean 0, std 1 (the JAX package's
        # one-entry tables, read with clamped indices)
        n_spk = len(spk_id_dict)
        id2mean = (self.id2pitch_mean if self.id2pitch_mean is not None
                   else np.zeros(n_spk, np.float32))
        id2std = (self.id2pitch_std if self.id2pitch_std is not None
                  else np.ones(n_spk, np.float32))

        for in_cap, idxs in groups.items():
            out_cap = int(in_cap * self.expand_factor)
            for start in range(0, len(idxs), batch_size):
                chunk = idxs[start: start + batch_size]
                B = len(chunk)
                seqs = np.full((B, in_cap), self.n_tokens, np.int64)
                lengths = np.zeros((B,), np.int64)
                spk = np.zeros((B, 1), np.int64)
                for j, i in enumerate(chunk):
                    units = [u for u in records[i]["units"] if u != self.n_tokens][:in_cap]
                    seqs[j, : len(units)] = units
                    lengths[j] = len(units)
                    name = records[i]["audio"].split("_")[0]
                    spk[j, 0] = spk_id_dict[target_speaker if target_speaker is not None
                                            else name]
                kw = dict(in_cap=in_cap, out_cap=out_cap, norm_pitch=norm_pitch,
                          n_tokens=self.n_tokens)
                parts, rows = split_for_devices((seqs, lengths, spk), len(self.devices))
                done = on_devices(
                    lambda dev, part: self._convert_on(dev, *part, id2mean, id2std, **kw),
                    list(zip(self.devices, parts)))
                out_seqs, out_lens, f0 = (gather_rows([d[k] for d in done], rows)
                                          for k in range(3))
                for j, i in enumerate(chunk):
                    # totals past out_cap are cut: counted and warned, never silent
                    if int(out_lens[j]) > out_cap:
                        self.truncation_count += 1
                        warnings.warn(
                            f"prosody conversion truncated "
                            f"{records[i].get('audio', i)}: predicted "
                            f"{int(out_lens[j])} frames > cap {out_cap} "
                            f"(expand_factor={self.expand_factor}); raise "
                            f"expand_factor to keep the full output",
                            stacklevel=2,
                        )
                    L = min(int(out_lens[j]), out_cap)
                    units = out_seqs[j, :L].tolist()
                    if self.pitch_model is not None:
                        f0_list = f0[j, :L].astype(float).tolist()
                    else:
                        f0_list = self._heuristic_pitch(records[i], units, norm_pitch,
                                                        spk_id_dict)
                    out[i] = {"units": units, "f0": f0_list, "audio": records[i]["audio"]}
        return out

    def _heuristic_pitch(self, record, out_units, norm_pitch, spk_id_dict) -> List[float]:
        """No-pitch-model path: nearest-interpolate the source contour onto
        the new run lengths (reference ``utils.py:47-52`` via ``infer.py:40-41``)."""
        in_units = np.asarray([u for u in record["units"] if u != self.n_tokens])
        pitch = np.asarray(record["f0"], np.float64)[: len(in_units)]
        if norm_pitch:
            if self.id2pitch_mean is None or self.id2pitch_std is None:
                raise ValueError(
                    "norm_pitch=True on the no-pitch-model path needs per-"
                    "speaker f0 statistics; load with f0_stats (reference "
                    "--f0_stats, infer.py:188) or pass norm_pitch=False")
            name = record["audio"].split("_")[0]
            sid = spk_id_dict[name]
            ii = pitch != 0
            pitch[ii] = (pitch[ii] - self.id2pitch_mean[sid]) / self.id2pitch_std[sid]
        _, t_lens = dedup_seq(out_units)
        return morph_seq_len(in_units, pitch, np.asarray(t_lens)).tolist()


def infer_file(input_path: str, out_path: str, len_model_dir: Optional[str],
               f0_model_dir: Optional[str], f0_model_type: str = "new",
               f0_stats_path: str = "", id_to_spkr_path: Optional[str] = None,
               n: Optional[int] = None, vc: bool = False,
               target_speakers: Optional[List[str]] = None, norm_pitch: bool = False,
               n_tokens: int = 100, wild: bool = False, sample_df: Optional[str] = None,
               device: DeviceLike = None,
               devices: Optional[Sequence[DeviceLike]] = None) -> None:
    """File-level entry point matching the reference CLI (``infer.py:47-155``):
    writes a reconstruction JSONL and/or per-target-speaker
    ``<t>_<input>.txt`` files.  ``sample_df`` is the speaker-verification
    pair CSV restricting (sample -> target) conversions and disabling
    reconstruction (``infer.py:112-122``)."""
    id_to_spkr_path = id_to_spkr_path or os.path.join(os.path.dirname(input_path),
                                                      "id_to_spkr.pkl")
    spk_id_dict = load_id_to_spkr(id_to_spkr_path)
    id2mean, id2std = prep_stats_arrays(spk_id_dict, load_f0_stats(f0_stats_path))
    conv = ProsodyConverter.load(
        n_speakers=len(spk_id_dict), len_model_dir=len_model_dir, f0_model_dir=f0_model_dir,
        f0_model_type=f0_model_type, id2pitch_mean=id2mean, id2pitch_std=id2std,
        n_tokens=n_tokens, device=device, devices=devices)

    records = list(iter_unit_records(input_path))
    if n is not None:
        records = records[:n]
    os.makedirs(out_path, exist_ok=True)
    base = os.path.basename(input_path)
    pairs = read_pair_csv(sample_df) if sample_df else None

    def targets_of(rec):
        stem = os.path.splitext(rec["audio"])[0].split("_mic2")[0]
        return pairs.get(stem, set())

    def fresh(path):
        if os.path.exists(path):
            os.remove(path)

    if not wild and pairs is None:
        recon_path = os.path.join(out_path, base)
        fresh(recon_path)
        for rec in conv.convert_records(records, spk_id_dict, None, norm_pitch):
            append_unit_record(recon_path, rec)

    if vc or wild:
        if pairs is not None:
            targets = sorted({t for rec in records for t in targets_of(rec)})
        else:
            targets = target_speakers or list(spk_id_dict.keys())[:1]
        for t in targets:
            recs_t = records if pairs is None else [r for r in records if t in targets_of(r)]
            if not recs_t:
                continue
            t_path = os.path.join(out_path, f"{t}_{base}")
            fresh(t_path)
            for rec in conv.convert_records(recs_t, spk_id_dict, t, norm_pitch):
                append_unit_record(t_path, rec)
