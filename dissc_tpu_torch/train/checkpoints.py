"""Vocoder checkpoints: the JAX package's numpy-pickle scheme
(``dissc_tpu.train.checkpoints``).

``g_<08d>`` holds the generator, ``do_<08d>`` the discriminators, both
optimizer states, step and epoch; the latest is found by name sort
(reference ``sr/train.py:206-214``, ``sr/utils.py:62-67``).  Trees are
nested dicts of numpy arrays, so files written by the JAX package load
here and the other way round.  Unpickle only files this project wrote.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Any, Optional

import torch


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(filepath: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    tmp = filepath + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(tree), f)
    os.replace(tmp, filepath)  # atomic: a crash never leaves a torn checkpoint


def load_checkpoint(filepath: str) -> Any:
    with open(filepath, "rb") as f:
        return pickle.load(f)


def scan_checkpoint(cp_dir: str, prefix: str) -> Optional[str]:
    """Latest checkpoint with ``prefix`` + 8-digit step, by name sort."""
    cp_list = glob.glob(os.path.join(cp_dir, prefix + "????????"))
    if not cp_list:
        return None
    return sorted(cp_list)[-1]


def step_checkpoint_name(prefix: str, step: int) -> str:
    return f"{prefix}{step:08d}"
