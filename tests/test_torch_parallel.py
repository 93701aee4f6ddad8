"""Port's data parallelism (``dissc_tpu_torch.parallel``) vs the JAX package:
the mesh rules, the GAN step and the data's rank shards.

``parallel/dryrun.py`` runs the GAN phase as a command, W = 2 ranks joined
by gloo over CPU processes (``OMP_NUM_THREADS=1``), each its contiguous
block of a seeded global batch of 8.  Rank 0's result is held against the
JAX package's one-device step (its own ``tests/test_parallel.py`` holds
that step equal at 8 devices): one SGD step (lr 1e-3) at the JAX dry run's
``tiny_gan_config`` from the port's seeded weights carried by
``compat.to_jax``, every parameter and spectral ``u`` within 2e-5 and the
losses (means over the ranks) within rtol 1e-4.

``CodeDataset.batches(process_index, process_count)`` gives each rank the
JAX package's batches bit for bit, native and Python paths, on an odd item
count.  The prosody and VQ steps are in ``test_torch_parallel_steps.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dissc_tpu.data import code_dataset as jcd
from dissc_tpu.parallel.dryrun import tiny_gan_config as jax_tiny_gan_config
from dissc_tpu.train.vocoder_trainer import GANState, make_gan_train_step
from dissc_tpu_torch.compat import to_jax
from dissc_tpu_torch.data import code_dataset as tcd
from dissc_tpu_torch.parallel import mesh
from dissc_tpu_torch.parallel.dryrun import tiny_gan_config
from test_torch_data import _same_batches, write_code_corpus

REPO = Path(__file__).resolve().parents[1]
BATCH = 8  # the global batch of every phase: 4 rows a rank at W = 2
LR = 1e-3


def dryrun(out, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "dissc_tpu_torch.parallel.dryrun", *args,
                           "--batch", str(BATCH), "--step-batch", str(BATCH), "--out", str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return dryrun(tmp_path_factory.mktemp("dryrun") / "w2.npz", "--phase", "gan", "--world",
                  "2", "--backend", "gloo", "--save-init")


def tree(arrays, prefix):
    """The ``prefix/...`` entries as a port state dict of tensors."""
    n = len(prefix) + 1
    return {k[n:]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith(prefix + "/")}


def assert_trees_close(got, ref, atol, what):
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert set(got) == {p for p, _ in flat}, what
    for path, value in flat:
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(value), rtol=0, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_mesh_rules():
    assert mesh.world_for_batch(64, 8) == 8 and mesh.world_for_batch(6, 4) == 3
    assert mesh.world_for_batch(7, 4) == 1 and mesh.world_for_batch(16, 0) == 1
    x = np.arange(12).reshape(6, 2)
    assert [mesh.shard_rows({"x": x}, r, 3)["x"][:, 0].tolist() for r in range(3)] == [
        [0, 2], [4, 6], [8, 10]]
    with pytest.raises(ValueError, match="does not divide"):
        mesh.local_batch_slice(6, 4)
    parts, rows = mesh.split_for_devices((x[:5], None), 3)
    assert rows == 5 and [p[0][:, 0].tolist() for p in parts] == [[0, 2], [4, 6], [8, 8]]
    assert all(p[1] is None for p in parts)
    np.testing.assert_array_equal(mesh.gather_rows([p[0] for p in parts], rows), x[:5])
    assert mesh.on_devices(lambda a, b: a * b, [(1, 2), (3, 4), (5, 6)]) == [2, 12, 30]


def test_gan_step_at_two_ranks_matches_the_jax_one_device_step(w2):
    h, jh = tiny_gan_config(BATCH), jax_tiny_gan_config(BATCH)
    gen_p = to_jax.generator_tree(tree(w2, "gan/init/gen"), h)
    mpd_p = to_jax.mpd_tree(tree(w2, "gan/init/mpd"))
    msd_p, spectral = to_jax.msd_trees(tree(w2, "gan/init/msd"))
    gen_tx, disc_tx = optax.sgd(LR), optax.sgd(LR)
    state = GANState(gen_p, mpd_p, msd_p, spectral, gen_tx.init(gen_p),
                     disc_tx.init({"mpd": mpd_p, "msd": msd_p}), jnp.zeros((), jnp.int32))
    train_step, _ = make_gan_train_step(jh, gen_tx, disc_tx)
    batch = {k: jnp.asarray(w2[f"gan/batch0/{k}"]) for k in ("code", "f0", "spkr", "audio")}
    batch = {**batch, "code": batch["code"].astype(jnp.int32),
             "spkr": batch["spkr"].astype(jnp.int32)}
    state, metrics = train_step(state, batch)

    names = [str(n) for n in w2["gan/loss_names"]]
    for name, value in zip(names, w2["gan/losses"][0]):
        np.testing.assert_allclose(value, float(metrics[name]), rtol=1e-4, err_msg=name)
    final = jax.device_get(state)
    assert_trees_close(to_jax.generator_tree(tree(w2, "gan/final/gen"), h), final.gen_params,
                       2e-5, "generator")
    assert_trees_close(to_jax.mpd_tree(tree(w2, "gan/final/mpd")), final.mpd_params, 2e-5,
                       "mpd")
    msd_final, spectral_final = to_jax.msd_trees(tree(w2, "gan/final/msd"))
    assert_trees_close(msd_final, final.msd_params, 2e-5, "msd")
    assert_trees_close(spectral_final, final.msd_spectral, 2e-5, "msd spectral u")
    moved = to_jax.generator_tree(tree(w2, "gan/final/gen"), h)
    assert any(np.abs(np.asarray(a) - np.asarray(b)).max() > 1e-6 for a, b in
               zip(jax.tree_util.tree_leaves(moved), jax.tree_util.tree_leaves(gen_p)))


@pytest.mark.parametrize("native", [True, False])
def test_code_dataset_rank_batches_match_jax(tmp_path, native):
    train, _ = write_code_corpus(tmp_path, n_files=7, n_val=2, seed=3)
    files = jcd.parse_manifest(train, str(tmp_path))
    seen = []
    for rank in range(2):
        kw = dict(segment_size=2560, code_hop_size=320, sampling_rate=16000, seed=7)
        jds, tds = jcd.CodeDataset(files, **kw), tcd.CodeDataset(files, f0_device="cpu", **kw)
        got = list(tds.batches(2, shuffle=True, seed=11, use_native=native,
                               process_index=rank, process_count=2))
        ref = list(jds.batches(2, shuffle=True, seed=11, use_native=native,
                               process_index=rank, process_count=2))
        assert len(got) == 2  # ceil(7 / 2) = 4 items, 2 batches of 2
        _same_batches(ref, got)
        seen.append(np.concatenate([b["code"] for b in got]))
    assert sum(len(s) for s in seen) == 8  # the epoch, one item repeated by the pad
