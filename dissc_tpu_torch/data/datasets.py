"""Prosody datasets (rhythm + pitch) as padded numpy arrays
(``dissc_tpu.data.datasets``, copied).

Replacements for reference ``dataset/len_dataset.py`` and
``dataset/pitch_dataset.py``: the whole JSONL is packed once into dense
padded arrays, and batches are served at a *fixed* shape (the final
partial batch is padded with fully-masked rows), so each step of an
epoch sees the same shapes, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dissc_tpu_torch.core.seqops import dedup_seq
from dissc_tpu_torch.data.jsonl import iter_unit_records, speaker_of


def _pad_to(arrs: List[np.ndarray], pad_value, dtype) -> np.ndarray:
    max_len = max(a.shape[0] for a in arrs)
    out = np.full((len(arrs), max_len), pad_value, dtype=dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


@dataclasses.dataclass
class LenDataset:
    """Deduped unit runs + run lengths per utterance.

    Equivalent of reference ``dataset/len_dataset.py:7-32``: units are
    padded with ``n_tokens`` (=100) and lengths with ``pad_value`` (=-1).
    """

    vals: np.ndarray  # [N, L] int32, pad = n_tokens
    lens: np.ndarray  # [N, L] float32, pad = pad_value
    spk_ids: np.ndarray  # [N, 1] int32
    names: List[str]
    n_tokens: int
    pad_value: float

    @classmethod
    def from_file(cls, path: str, spk_id_dict: Dict[str, int], n_tokens: int = 100,
                  pad_value: float = -1) -> "LenDataset":
        all_vals, all_counts, spk_ids, names = [], [], [], []
        for rec in iter_unit_records(path):
            vals, counts = dedup_seq(rec["units"])
            all_vals.append(np.asarray(vals, np.int32))
            all_counts.append(np.asarray(counts, np.float32))
            spk_ids.append(spk_id_dict[speaker_of(rec)])
            names.append(rec["audio"])
        return cls(
            vals=_pad_to(all_vals, n_tokens, np.int32),
            lens=_pad_to(all_counts, pad_value, np.float32),
            spk_ids=np.asarray(spk_ids, np.int32).reshape(-1, 1),
            names=names,
            n_tokens=n_tokens,
            pad_value=pad_value,
        )

    def __len__(self) -> int:
        return self.vals.shape[0]

    def nonpad_lengths(self) -> np.ndarray:
        """Per-utterance count of valid (non-pad) runs."""
        return (self.vals != self.n_tokens).sum(axis=1)

    def train_norm_stats(self) -> Tuple[float, float]:
        """Mean/std of valid run lengths (reference ``train_len_predictor.py:28-29``)."""
        valid = self.lens[self.lens != self.pad_value]
        return float(valid.mean()), float(valid.std())


@dataclasses.dataclass
class PitchDataset:
    """Full unit sequences + per-frame f0 per utterance.

    Equivalent of reference ``dataset/pitch_dataset.py:8-42``: units
    padded with ``n_tokens``, f0 padded with ``padding_value`` (=-100),
    optional per-speaker whitening of voiced frames.
    """

    vals: np.ndarray  # [N, T] int32, pad = n_tokens
    fs: np.ndarray  # [N, T] float32, pad = padding_value
    spk_ids: np.ndarray  # [N, 1] int32
    names: List[str]
    n_tokens: int
    pad_value: float

    @classmethod
    def from_file(cls, path: str, spk_id_dict: Dict[str, int], f0_param_dict: Optional[Dict],
                  n_tokens: int = 100, padding_value: float = -100,
                  normalise_pitch: bool = True) -> "PitchDataset":
        seqs, fs, spk_ids, names = [], [], [], []
        for rec in iter_unit_records(path):
            spk = speaker_of(rec)
            seqs.append(np.asarray(rec["units"], np.int32))
            f0 = np.asarray(rec["f0"], np.float32)
            if normalise_pitch:
                ii = f0 != 0
                f0 = f0.copy()
                f0[ii] -= f0_param_dict[spk]["mean"]
                f0[ii] /= f0_param_dict[spk]["std"]
            fs.append(f0)
            spk_ids.append(spk_id_dict[spk])
            names.append(rec["audio"])
        return cls(
            vals=_pad_to(seqs, n_tokens, np.int32),
            fs=_pad_to(fs, padding_value, np.float32),
            spk_ids=np.asarray(spk_ids, np.int32).reshape(-1, 1),
            names=names,
            n_tokens=n_tokens,
            pad_value=padding_value,
        )

    def __len__(self) -> int:
        return self.vals.shape[0]


def batch_iterator(
    arrays: Tuple[np.ndarray, ...],
    batch_size: int,
    shuffle: bool,
    rng: Optional[np.random.Generator] = None,
    pad_row_values: Optional[Tuple] = None,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield fixed-shape batches; the last partial batch is padded.

    ``pad_row_values[i]`` fills the padded rows of ``arrays[i]`` (choose
    the dataset's pad value so padded rows are fully masked in losses).
    """
    n = arrays[0].shape[0]
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        batch = [a[idx] for a in arrays]
        if len(idx) < batch_size and pad_row_values is not None:
            for i, a in enumerate(batch):
                pad_rows = np.full((batch_size - len(idx), *a.shape[1:]), pad_row_values[i], a.dtype)
                batch[i] = np.concatenate([a, pad_rows], axis=0)
        yield tuple(batch)
