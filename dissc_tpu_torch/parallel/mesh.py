"""How a batch is divided over ranks and cards (``dissc_tpu.parallel.mesh``).

Training: :func:`world_for_batch` is ``mesh_for_batch``'s rule (the
largest device count up to the cards present that divides the global
batch), and :func:`shard_rows` gives a rank its contiguous block of the
global batch's rows, as GSPMD lays out a ``P("data")`` batch.

Serving: :func:`split_for_devices` pads a batch to a multiple of the
device count by repeating its last row and splits it into contiguous
parts; :func:`gather_rows` joins the parts' outputs and cuts the padded
rows again (the JAX engines' pad-to-mesh, ``infer/vocoder.py:132-147``).
:func:`on_devices` runs one call per part, each on its own thread, so
host work in one part (a sync, a host scan) overlaps the others.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


def world_for_batch(batch_size: int, n_devices: int) -> int:
    """The largest count ``<= n_devices`` (at least 1) that divides ``batch_size``."""
    return max(d for d in range(1, max(n_devices, 1) + 1) if batch_size % d == 0)


def local_batch_slice(global_batch: int, world: int) -> int:
    """Rows a rank takes of ``global_batch`` (the reference divides the
    global batch by the world size, ``sr/train.py:322``)."""
    if world < 1 or global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not divide over {world} ranks")
    return global_batch // world


def shard_rows(batch: Any, rank: int, world: int) -> Any:
    """Rank ``rank``'s contiguous block of rows of every array or tensor in
    ``batch`` (a dict, tuple or list of them, or one), whose leading
    dimension is the global batch."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_rows(v, rank, world) for v in batch)
    if batch is None:
        return None
    n = local_batch_slice(batch.shape[0], world)
    return batch[rank * n:(rank + 1) * n]


def split_for_devices(arrays: Sequence[Optional[np.ndarray]], n_parts: int
                      ) -> Tuple[List[Tuple[Optional[np.ndarray], ...]], int]:
    """Arrays sharing a leading batch dimension -> (``n_parts`` tuples of
    equal contiguous row blocks, the true row count).  The batch is first
    padded to a multiple of ``n_parts`` by repeating its last row; ``None``
    entries stay ``None`` in every part."""
    rows = next(a.shape[0] for a in arrays if a is not None)
    pad = (-rows) % n_parts

    def padded(a):
        if a is None or not pad:
            return a
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

    full = [padded(a) for a in arrays]
    per = (rows + pad) // n_parts
    parts = [tuple(None if a is None else a[i * per:(i + 1) * per] for a in full)
             for i in range(n_parts)]
    return parts, rows


def gather_rows(outputs: Sequence[np.ndarray], rows: int) -> np.ndarray:
    """The parts' outputs in order, padded rows cut."""
    return np.concatenate(list(outputs))[:rows]


def on_devices(fn: Callable[..., Any], args: Sequence[tuple]) -> List[Any]:
    """``[fn(*a) for a in args]``, each call on its own thread when there
    are several; results in order, the first exception raised."""
    if len(args) <= 1:
        return [fn(*a) for a in args]
    with ThreadPoolExecutor(max_workers=len(args)) as pool:
        return list(pool.map(lambda a: fn(*a), args))
