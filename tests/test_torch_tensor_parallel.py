"""Port's ``model`` axis (``dissc_tpu_torch.parallel.tensor``) vs the JAX package.

The sharding rule is the JAX dry run's ``gen_param_spec`` predicate
(``dissc_tpu/parallel/dryrun.py:127-138``); on the port's parameters, read
in the flax layout, it must pick the same generator leaves as on the JAX
tree (``jax.eval_shape(init_gan_state)``) at the dry run's
``tiny_gan_config`` and at ``VocoderConfig()``.

One ``parallel/dryrun.py --phase gan --shard tp replicated --model 2
--world 2 --backend gloo`` command (2 ranks over CPU processes,
``OMP_NUM_THREADS=2``) serves the module, run in the background while the
JAX reference is computed: the data 1 x model 2 step, then the replicated
one.  The gathered generator, MPD, MSD, spectral ``u`` and losses after one
SGD step (lr 1e-3, global batch 8) are held to the JAX package's one-device
``make_gan_train_step`` from the same weights (``compat.to_jax``):
parameters within 2e-5, losses within rtol 1e-4, the bounds of
``test_torch_parallel.py``.  The 2 x 2 grid (W = 4) runs only in
``chip_smoke.py`` (phase 12), to keep this file's time down.

That JAX step is compiled once, with ``msd_fused_gstep`` and ``disc_s2d``
set: the fused MSD G step is forward-identical and AD-equivalent to the
module's, and the space-to-depth convs have the plain form's numbers, so
the port's plain steps are held to it, and so is one ``GANTrainer`` step
with ``msd_fused_gstep`` (run here while XLA compiles; the fused stack's
own checks are in ``test_torch_msd_fused.py``).
"""
import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.parallel.dryrun import tiny_gan_config as jax_tiny_gan_config
from dissc_tpu.train.vocoder_trainer import GANState, init_gan_state, make_gan_train_step
from dissc_tpu_torch.compat import to_jax
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.models.hifigan import CodeGenerator
from dissc_tpu_torch.parallel import dryrun, mesh, tensor
from dissc_tpu_torch.train.vocoder_trainer import GANTrainer, make_models
from test_torch_parallel import assert_trees_close, tree

REPO = Path(__file__).resolve().parents[1]
BATCH, LR = 8, 1e-3
SHARDED = ["conv_pre.weight_v", "conv_pre.weight_g", "ups.0.weight_v", "ups.0.weight_g"]


def jax_step(h, jh, while_compiling):
    """The JAX one-device step from the port's seeded init on the dry run's
    first batch, ``while_compiling()`` run as XLA compiles it: (state after
    the step, metrics, the init state dicts, ``while_compiling``'s result)."""
    gen, mpd, msd = make_models(h, seed=h.seed)
    init = {name: m.state_dict() for name, m in (("gen", gen), ("mpd", mpd), ("msd", msd))}
    gen_p = to_jax.generator_tree(init["gen"], h)
    mpd_p = to_jax.mpd_tree(init["mpd"])
    msd_p, spectral = to_jax.msd_trees(init["msd"])
    tx = optax.sgd(LR)
    state = GANState(gen_p, mpd_p, msd_p, spectral, tx.init(gen_p),
                     tx.init({"mpd": mpd_p, "msd": msd_p}), jnp.zeros((), jnp.int32))
    train_step, _ = make_gan_train_step(jh, tx, tx)
    batch = {k: jnp.asarray(v) for k, v in dryrun.gan_batches(h, 1)[0].items()}
    batch = {**batch, "code": batch["code"].astype(jnp.int32),
             "spkr": batch["spkr"].astype(jnp.int32)}
    with ThreadPoolExecutor(1) as pool:
        compiled = pool.submit(train_step.lower(state, batch).compile)
        other = while_compiling()
        state, metrics = compiled.result()(state, batch)
    return jax.device_get(state), {k: float(v) for k, v in metrics.items()}, init, other


def fused_port_step(h):
    """One SGD step of ``GANTrainer`` with ``msd_fused_gstep``, in this process."""
    h = dataclasses.replace(h, msd_fused_gstep=True)
    trainer = GANTrainer(h, device="cpu", seed=h.seed)
    trainer.opt_g = torch.optim.SGD(trainer.gen.parameters(), lr=LR)
    trainer.opt_d = torch.optim.SGD(list(trainer.mpd.parameters())
                                    + list(trainer.msd.parameters()), lr=LR)
    batch = {k: torch.from_numpy(v) for k, v in dryrun.gan_batches(h, 1)[0].items()}
    metrics = trainer.train_step(batch)
    return trainer, {k: float(v) for k, v in metrics.items()}


def start(out, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "dissc_tpu_torch.parallel.dryrun", "--phase", "gan",
           "--batch", str(BATCH), "--out", str(out), *args]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def jax_gen_picks(h, n_model):
    """The JAX ``gen_param_spec`` predicate over ``init_gan_state``'s
    generator leaves: ``{(path, shape)}``."""
    state = jax.eval_shape(lambda k: init_gan_state(h, k, seg_frames=8)[0], jax.random.key(0))
    return {(jax.tree_util.keystr(path), tuple(x.shape))
            for path, x in jax.tree_util.tree_leaves_with_path(state.gen_params)
            if x.ndim >= 2 and x.shape[-1] >= h.upsample_initial_channel
            and x.shape[-1] % n_model == 0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dry run's tp-then-replicated command and its ``--backend none``
    reference run in the background while the JAX step and the JAX rule's
    picks are computed here."""
    root = tmp_path_factory.mktemp("tp")
    procs = [start(root / "tp.npz", "--shard", "tp", "replicated", "--model", "2", "--world",
                   "2", "--backend", "gloo", "--save-init"),
             start(root / "none.npz", "--world", "1", "--backend", "none")]
    try:
        h = dryrun.tiny_gan_config(BATCH)
        jh = dataclasses.replace(jax_tiny_gan_config(BATCH), msd_fused_gstep=True,
                                 disc_s2d=True)
        state, metrics, init, (picks, fused) = jax_step(h, jh, lambda: (
            {"tiny": jax_gen_picks(jax_tiny_gan_config(BATCH), 2),
             "full": jax_gen_picks(JaxConfig(), 2)}, fused_port_step(h)))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with np.load(root / "tp.npz") as f, np.load(root / "none.npz") as g:
        return dict(tp=dict(f), none=dict(g), jax=state, metrics=metrics, init=init,
                    log=logs[0], h=h, picks=picks, fused=fused)


def jax_path(name):
    """A port generator parameter's path in the JAX tree."""
    module, leaf = name.rsplit(".", 1)
    leaf = {"weight_v": "v", "weight_g": "g", "weight": "kernel"}.get(leaf, leaf)
    return f"['generator']['{module.replace('.', '_')}']['{leaf}']"


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_sharding_rule_picks_the_jax_gen_param_spec_leaves(runs, width):
    h = dryrun.tiny_gan_config(BATCH) if width == "tiny" else VocoderConfig()
    shapes = {n: tuple(p.shape) for n, p in CodeGenerator(h).named_parameters()}
    names = tensor.sharded_names(shapes.items(), h.upsample_initial_channel, 2)
    assert names == SHARDED
    assert {(jax_path(n), to_jax.generator_flax_shape(shapes[n])) for n in names} == (
        runs["picks"][width])


def test_grid_layout_and_batch_rule():
    """Rank r sits at divmod(r, n_model), as ``reshape(n_data, n_model)``;
    the data extent is ``mesh_for_batch``'s over cards // n_model."""
    assert [mesh.grid_position(r, 2) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.grid_groups(4, 2) == ([[0, 2], [1, 3]], [[0, 1], [2, 3]])
    assert mesh.grid_groups(2, 2) == ([[0], [1]], [[0, 1]])
    assert mesh.world_for_batch(32, 8, n_model=2) == 8
    assert mesh.world_for_batch(6, 8, n_model=2) == 6 and mesh.world_for_batch(7, 8, 2) == 2
    assert mesh.world_for_batch(64, 8) == 8  # n_model 1: the data-parallel rule
    with pytest.raises(ValueError, match="does not divide"):
        mesh.grid_groups(3, 2)


def test_shard_generator_on_one_rank_is_exact():
    h = dryrun.tiny_gan_config(BATCH)
    gen = CodeGenerator(h, generator=torch.Generator().manual_seed(3))
    full = {k: v.clone() for k, v in gen.state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in dryrun.gan_batches(h, 1)[0].items()}
    args = (batch["code"], batch["f0"], batch["spkr"])
    ref = gen(*args)
    assert tensor.shard_generator(gen, None) == SHARDED
    assert isinstance(gen.conv_pre, tensor.ColumnParallelConv1d)
    assert isinstance(gen.ups[0], tensor.RowParallelConvTranspose1d)
    torch.testing.assert_close(gen(*args), ref, rtol=0, atol=1e-7)
    gathered = tensor.gather_generator_state(gen)
    assert gathered.keys() == full.keys()
    assert all(torch.equal(gathered[k], v) for k, v in full.items())
    assert len(tensor.replicated_parameters(gen)) == len(full) - len(SHARDED)


def test_tp_step_matches_the_jax_one_device_step(runs):
    tp, h, final = runs["tp"], runs["h"], runs["jax"]
    for name in ("gen", "mpd", "msd"):  # the gathered init is the seeded full model
        init = tree(tp, f"gan/tp/init/{name}")
        assert all(torch.equal(init[k], v) for k, v in runs["init"][name].items()), name
    names = [str(n) for n in tp["gan/tp/loss_names"]]
    for name, value in zip(names, tp["gan/tp/losses"][0]):
        np.testing.assert_allclose(value, runs["metrics"][name], rtol=1e-4, err_msg=name)
    assert_trees_close(to_jax.generator_tree(tree(tp, "gan/tp/final/gen"), h),
                       final.gen_params, 2e-5, "generator")
    assert_trees_close(to_jax.mpd_tree(tree(tp, "gan/tp/final/mpd")), final.mpd_params,
                       2e-5, "mpd")
    msd_final, spectral_final = to_jax.msd_trees(tree(tp, "gan/tp/final/msd"))
    assert_trees_close(msd_final, final.msd_params, 2e-5, "msd")
    assert_trees_close(spectral_final, final.msd_spectral, 2e-5, "msd spectral u")


def test_gan_step_with_the_fused_msd_matches_jax(runs):
    trainer, metrics = runs["fused"]
    h, final = runs["h"], runs["jax"]
    for name, value in metrics.items():
        np.testing.assert_allclose(value, runs["metrics"][name], rtol=1e-4, err_msg=name)
    assert_trees_close(to_jax.generator_tree(trainer.gen.state_dict(), h), final.gen_params,
                       2e-5, "generator")
    assert_trees_close(to_jax.mpd_tree(trainer.mpd.state_dict()), final.mpd_params, 2e-5, "mpd")
    msd_final, spectral_final = to_jax.msd_trees(trainer.msd.state_dict())
    assert_trees_close(msd_final, final.msd_params, 2e-5, "msd")
    assert_trees_close(spectral_final, final.msd_spectral, 2e-5, "msd spectral u")


def test_model_ranks_hold_equal_replicated_parameters(runs):
    tp = runs["tp"]
    assert tp["gan/tp/replicated_gap"].tolist() == [0.0, 0.0]
    assert tp["gan/tp/sharded"].tolist() == SHARDED
    assert "tensor-sharding 4 wide generator kernels over 'model'" in runs["log"]
    assert tp["gan/tp/k1_launches"].tolist() == [0, 0]  # the kernel runs only on the card


def test_replicated_equals_backend_none(runs):
    tp, none = runs["tp"], runs["none"]
    keys = [k for k in none if k.startswith("gan/final/") or k == "gan/losses"]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(tp["gan/replicated/" + k[4:]], none[k], err_msg=k)
    assert tp["gan/replicated/allreduce_ms"].tolist() == [[0.0], [0.0]]
