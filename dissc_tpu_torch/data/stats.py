"""Speaker dictionaries, f0 statistics, and dataset splits
(``dissc_tpu.data.stats``, copied; numpy and pickle).

File formats are pickle-compatible with the reference so artifacts
interoperate:
  * ``id_to_spkr.pkl`` — plain Python list, index = speaker id
    (written by reference ``sr/train.py:107-108``).
  * ``f0_stats.pkl`` — ``{speaker: {"mean": float, "std": float}}`` over
    voiced frames of the train split (``data/data_utils.py:33-46``).

Either package reads the pickles the other writes.  Unpickle only files
this project wrote.
"""
from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from dissc_tpu_torch.data.jsonl import iter_unit_records, speaker_of


def get_spkrs_dict(path: str) -> Dict[str, int]:
    """{speaker: id} from a JSONL file; ids ordered by unique speaker name.

    Matches reference ``dataset/utils.py:6-12`` (np.unique ordering).
    """
    speakers = [speaker_of(rec) for rec in iter_unit_records(path)]
    return {n: i for i, n in enumerate(np.unique(speakers))}


def save_id_to_spkr(path: str, id_to_spkr: list) -> None:
    with open(path, "wb") as f:
        pickle.dump(id_to_spkr, f)


def load_id_to_spkr(path: str) -> Dict[str, int]:
    """Load ``id_to_spkr.pkl`` and invert to {name: id} (reference ``infer.py:53-54``)."""
    with open(path, "rb") as f:
        id_list = pickle.load(f)
    return {v: k for (k, v) in dict(enumerate(id_list)).items()}


def load_f0_stats(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_f0_stats(path: str, stats: Dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(stats, f)


def prep_stats_arrays(
    spk_id_dict: Dict[str, int], f0_param_dict: Dict
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-speaker f0 mean/std into id-indexed arrays.

    Matches reference ``dataset/utils.py:18-26`` (returns numpy instead of
    torch tensors).
    """
    id2mean = np.empty(len(spk_id_dict), dtype=np.float32)
    id2std = np.empty(len(spk_id_dict), dtype=np.float32)
    for n, v in spk_id_dict.items():
        id2mean[v] = f0_param_dict[n]["mean"]
        id2std[v] = f0_param_dict[n]["std"]
    return id2mean, id2std


def data_split(data_path: str, split_method: str = "random", train_size: float = 0.7):
    """Split a JSONL into train.txt/val.txt next to it.

    ``random``: each line -> train with prob ``train_size`` (reference
    ``data/data_utils.py:9-18``).  ``paired_val``: utterance number <= 24
    -> val (``data/data_utils.py:19-29``, the VCTK paired-validation rule).
    """
    base_path = Path(data_path).parent.absolute()
    train_p, val_p = base_path / "train.txt", base_path / "val.txt"
    with open(data_path, "r") as f, open(train_p, "w") as f_tr, open(val_p, "w") as f_val:
        for line in f.readlines():
            if split_method == "random":
                to_train = np.random.rand() <= train_size
            elif split_method == "paired_val":
                audio = json.loads(line)["audio"]
                audio_num = int(audio.split("_")[1].split(".")[0])
                to_train = audio_num > 24
            else:
                raise ValueError(f"Unsupported train-val split method {split_method}")
            (f_tr if to_train else f_val).write(line)
    return train_p, val_p


def calculate_pitch_stats(data_path: str, out_path: str) -> None:
    """Per-speaker mean/std of voiced (f0 != 0) frames -> pickle.

    Matches reference ``data/data_utils.py:33-46``.
    """
    speaker_fs = defaultdict(list)
    for rec in iter_unit_records(data_path):
        speaker_fs[speaker_of(rec)] += rec["f0"]

    speaker_stats = {}
    for k, fs in speaker_fs.items():
        voiced = np.array(fs)[np.array(fs) != 0]
        speaker_stats[k] = {"mean": voiced.mean(), "std": voiced.std()}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    save_f0_stats(out_path, speaker_stats)
