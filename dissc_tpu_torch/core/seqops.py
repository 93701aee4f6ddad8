"""Sequence ops of the port (``dissc_tpu.core.seqops``).

The reference pipeline rests on three dynamic-shape operations
(reference ``dataset/utils.py:14-16``, ``infer.py:32,158-172``,
``utils.py:39-52``): run-length dedup of a unit sequence, re-timing by
``repeat_interleave``, and carryover rounding of fractional durations.

* **host** ops (numpy, copied from the JAX package): :func:`dedup_seq`,
  :func:`interp`, :func:`morph_seq_len`, :func:`repeat_interleave_host`;
* **device** ops on ``[B, C]`` tensors with fixed capacities and explicit
  lengths: :func:`dedup_padded`, :func:`repeat_interleave_padded`,
  :func:`len_carryover_correction` (batched forms of the JAX package's
  per-sample ops, which it vmaps), and :func:`nearest_upsample`.
"""
from __future__ import annotations

from itertools import groupby
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side (numpy) reference-exact ops
# ---------------------------------------------------------------------------


def dedup_seq(seq: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Run-length encode ``seq`` -> (unique values, run lengths).

    Matches reference ``dataset/utils.py:14-16``.
    """
    vals, counts = zip(*[(k, sum(1 for _ in g)) for k, g in groupby(seq)])
    return vals, counts


def interp(vals: Sequence[float], target_len: int) -> np.ndarray:
    """Nearest-neighbour resample of ``vals`` to ``target_len`` points.

    Matches reference ``utils.py:39-45`` (scipy interp1d, kind='nearest',
    fill_value=0, over a unit grid).
    """
    from scipy.interpolate import interp1d

    cur_len = len(vals)
    if cur_len == 1:
        # Type-dependent on purpose, exactly as the reference: a list is
        # *repeated* target_len times (the morph_seq_len path), while an
        # ndarray is *scalar-multiplied* into a length-1 array that then
        # broadcasts (the eval aligned_ffe path).
        return np.array(target_len * vals)
    if target_len == cur_len:
        return np.array(vals)
    f = interp1d(
        np.linspace(0.0, 1.0, cur_len), vals, bounds_error=False, kind="nearest", fill_value=0
    )
    return f(np.linspace(0.0, 1.0, target_len))


def morph_seq_len(units: np.ndarray, pitch: np.ndarray, t_lens: np.ndarray) -> np.ndarray:
    """Re-time a pitch contour to new per-run lengths: each run's pitch
    values nearest-resampled to its new length (reference ``utils.py:47-52``)."""
    out = []
    for i, (_, g) in enumerate(groupby(zip(units, pitch), key=lambda x: x[0])):
        out.append(interp([f for _, f in g], int(t_lens[i])))
    return np.concatenate(out)


def repeat_interleave_host(vals: Sequence[int], lens: Sequence[int]) -> np.ndarray:
    """Expand run-length encoding back to a flat sequence (numpy)."""
    return np.repeat(np.asarray(vals), np.asarray(lens))


# ---------------------------------------------------------------------------
# Device-side ops on [B, C] tensors
# ---------------------------------------------------------------------------


def dedup_padded(seq: torch.Tensor, length: torch.Tensor, capacity: int, pad_val: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-length encode padded rows into fixed-capacity buffers.

    ``seq`` ``[B, T]`` ints, of which the first ``length[b]`` are valid.
    Returns ``(vals [B, capacity], counts [B, capacity], n_runs [B])``:
    ``counts`` is 0 and ``vals`` is ``pad_val`` beyond ``n_runs``.  A run
    boundary is forced at t=0; pads go to an overflow bin that is cut off.
    """
    B, T = seq.shape
    valid = torch.arange(T, device=seq.device)[None, :] < length[:, None]
    prev = torch.cat([seq[:, :1] - 1, seq[:, :-1]], dim=1)
    is_new = (seq != prev) & valid
    run_id = torch.cumsum(is_new.long(), dim=1) - 1
    run_id = torch.where(valid, run_id, capacity)
    counts = torch.zeros((B, capacity + 1), dtype=torch.int32, device=seq.device)
    counts.scatter_add_(1, run_id, torch.ones_like(run_id, dtype=torch.int32))
    vals = torch.full((B, capacity + 1), pad_val, dtype=seq.dtype, device=seq.device)
    vals.scatter_(1, torch.where(is_new, run_id, capacity),
                  torch.where(is_new, seq, torch.full_like(seq, pad_val)))
    return vals[:, :capacity], counts[:, :capacity], is_new.sum(dim=1)


def repeat_interleave_padded(vals: torch.Tensor, lens: torch.Tensor, capacity: int,
                             pad_val: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``repeat_interleave`` of ``[B, C]`` runs into ``[B, capacity]``.

    Output position ``j`` takes the run whose cumulative-length interval
    holds ``j`` (a ``searchsorted`` gather).  Returns ``(out, total [B])``;
    ``total`` is the true length, even past ``capacity``.
    """
    B = vals.shape[0]
    ends = torch.cumsum(lens, dim=1)
    total = ends[:, -1] if lens.shape[1] > 0 else lens.new_zeros(B)
    j = torch.arange(capacity, device=vals.device)
    seg = torch.searchsorted(ends.contiguous(), j.to(ends.dtype).expand(B, capacity).contiguous(),
                             right=True)
    seg = seg.clamp(0, max(vals.shape[1] - 1, 0))
    out = torch.gather(vals, 1, seg).masked_fill(j[None, :] >= total[:, None], pad_val)
    return out, total


def carryover_host(lens: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """:func:`len_carryover_correction` on host arrays ``[B, C]``: float32
    in, int32 out."""
    lens = np.asarray(lens, np.float32)
    base = np.round(np.maximum(lens, np.float32(1.0)))  # round half to even
    resid = lens - base
    if mask is not None:
        resid = np.where(mask, resid, np.float32(0.0))
    total = np.zeros(lens.shape[0], np.float32)
    corrs = np.zeros(lens.shape, np.int32)
    for c in range(lens.shape[1]):
        total = total + resid[:, c]
        corr = np.where(total >= 1.0, 1, np.where(total <= -1.0, -1, 0)).astype(np.int32)
        total = total - corr.astype(np.float32)
        corrs[:, c] = corr
    out = base.astype(np.int32) + corrs
    if mask is not None:
        out = np.where(mask, out, 0).astype(np.int32)
    return out


def len_carryover_correction(lens: torch.Tensor, mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Round predicted ``[B, C]`` float durations to ints without length bias.

    Each duration becomes ``round(clamp(len, 1))`` (round half to even) and
    its residual rides a running total that emits a +/-1 correction
    whenever it crosses +/-1 (reference ``infer.py:158-172``; the JAX
    package's float32 ``lax.scan``).  Masked entries carry no residual and
    return 0.

    The scan is sequential over C (up to 1280).  It runs on a host copy of
    the ``[B, C]`` durations, in numpy float32, vectorised over the batch:
    a loop of tiny launches on the card would launch several kernels for
    each of the C steps, where numpy takes a few microseconds a step.  The
    additions are float32 and in the scan's order, so the durations equal
    the JAX package's exactly.  Returns int32 on ``lens``'s device.
    """
    m = None if mask is None else mask.cpu().numpy()
    out = carryover_host(lens.detach().float().cpu().numpy(), m)
    return torch.from_numpy(out).to(lens.device)


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-repeat upsampling along time: (..., T, C) -> (..., T*factor, C).

    Reference ``sr/models.py:158-177`` (``CodeGenerator._upsample``).
    """
    if factor == 1:
        return x
    return torch.repeat_interleave(x, factor, dim=-2)
