"""Speaker dictionaries and f0 statistics (``dissc_tpu.data.stats``, the
readers that inference needs; copied).

File formats are pickle-compatible with the reference:
  * ``id_to_spkr.pkl`` — plain Python list, index = speaker id
    (written by reference ``sr/train.py:107-108``).
  * ``f0_stats.pkl`` — ``{speaker: {"mean": float, "std": float}}`` over
    voiced frames of the train split (``data/data_utils.py:33-46``).

Unpickle only files this project wrote.
"""
from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np


def load_id_to_spkr(path: str) -> Dict[str, int]:
    """Load ``id_to_spkr.pkl`` and invert to {name: id} (reference ``infer.py:53-54``)."""
    with open(path, "rb") as f:
        id_list = pickle.load(f)
    return {v: k for (k, v) in dict(enumerate(id_list)).items()}


def load_f0_stats(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def prep_stats_arrays(spk_id_dict: Dict[str, int], f0_param_dict: Dict
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-speaker f0 mean/std into id-indexed float32 arrays
    (reference ``dataset/utils.py:18-26``)."""
    id2mean = np.empty(len(spk_id_dict), dtype=np.float32)
    id2std = np.empty(len(spk_id_dict), dtype=np.float32)
    for n, v in spk_id_dict.items():
        id2mean[v] = f0_param_dict[n]["mean"]
        id2std[v] = f0_param_dict[n]["std"]
    return id2mean, id2std
