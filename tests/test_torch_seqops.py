"""Port's seqops vs the JAX package's on the same inputs.

The sweeps of ``tests/test_seqops_properties.py``, run through the JAX
device ops (per row, vmapped) and through the port's batched ops on
``[B, C]`` tensors.  Runs, counts, lengths and durations must be equal
exactly, half-way residuals (x.5, round half to even) included.  The host
ops are copies and must return what the JAX package's return.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.core import seqops as jseq
from dissc_tpu_torch.core import seqops as tseq

T, PAD = 64, 100


def _random_padded_rows(rng, B):
    seqs = np.full((B, T), PAD, np.int64)
    lengths = rng.integers(1, T + 1, B)
    for b in range(B):
        i = 0
        while i < lengths[b]:
            run = int(rng.integers(1, 5))
            seqs[b, i:min(i + run, lengths[b])] = int(rng.integers(0, PAD))
            i += run
    return seqs, lengths


# the JAX ops are per row; vmapped here so each compiles once
_jax_dedup = jax.jit(jax.vmap(functools.partial(jseq.dedup_padded, capacity=T, pad_val=PAD)))
_jax_repeat = jax.jit(jax.vmap(jseq.repeat_interleave_padded, in_axes=(0, 0, None, None)),
                      static_argnums=(2, 3))
_jax_carry = jax.jit(jax.vmap(jseq.len_carryover_correction))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_and_repeat_interleave_match_jax(seed):
    rng = np.random.default_rng(seed)
    seqs, lengths = _random_padded_rows(rng, 16)
    vals, counts, n_runs = tseq.dedup_padded(torch.from_numpy(seqs), torch.from_numpy(lengths),
                                             T, PAD)
    jv, jc, jn = _jax_dedup(jnp.asarray(seqs, jnp.int32), jnp.asarray(lengths, jnp.int32))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(n_runs.numpy(), np.asarray(jn))
    for cap in (T, 8):  # 8: below the totals, so truncated, the true total reported
        out, total = tseq.repeat_interleave_padded(vals, counts, cap, PAD)
        jo, jt = _jax_repeat(jv, jc, cap, PAD)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(total.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(total.numpy(), lengths)
    for b in range(len(seqs)):
        hv, hl = tseq.dedup_seq(seqs[b, :lengths[b]].tolist())
        assert (hv, hl) == jseq.dedup_seq(seqs[b, :lengths[b]].tolist())
        np.testing.assert_array_equal(tseq.repeat_interleave_host(hv, hl), seqs[b, :lengths[b]])


@pytest.mark.parametrize("seed", [0, 1])
def test_carryover_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    B, C = 12, 40
    lens = rng.uniform(0.2, 6.0, (B, C)).astype(np.float32)
    # half-way values: base rounding (half to even) and residuals of +-0.5
    lens[:4] = rng.choice(np.array([0.5, 1.5, 2.5, 3.5, 4.5, 1.0, 2.0], np.float32), (4, C))
    mask = np.arange(C)[None, :] < rng.integers(1, C + 1, (B, 1))
    out = tseq.len_carryover_correction(torch.from_numpy(lens), torch.from_numpy(mask)).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(_jax_carry(jnp.asarray(lens), jnp.asarray(mask))))
    assert (out[~mask] == 0).all()
    unmasked = tseq.len_carryover_correction(torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(
        unmasked, np.asarray(_jax_carry(jnp.asarray(lens), jnp.ones((B, C), bool))))


def test_dedup_constant_and_alternating_extremes():
    rows = np.stack([np.full(T, 5), np.arange(T) % 2])
    full = torch.full((2,), T)
    vals, counts, n = tseq.dedup_padded(torch.from_numpy(rows), full, T, PAD)
    assert n.tolist() == [1, T]
    assert int(counts[0, 0]) == T and int(vals[0, 0]) == 5
    assert (counts[1] == 1).all()


@pytest.mark.parametrize("vals,target", [([3.0], 4), (np.array([3.0]), 4),
                                         ([1.0, 2.0, 3.0], 7), ([1.0, 2.0], 2)])
def test_host_interp_and_morph_match_jax(vals, target):
    np.testing.assert_array_equal(tseq.interp(vals, target), jseq.interp(vals, target))
    units = np.array([4, 4, 7, 7, 7, 9])
    pitch = np.array([100.0, 110.0, 0.0, 120.0, 125.0, 90.0])
    t_lens = np.array([3, 1, 2])
    np.testing.assert_array_equal(tseq.morph_seq_len(units, pitch, t_lens),
                                  jseq.morph_seq_len(units, pitch, t_lens))
