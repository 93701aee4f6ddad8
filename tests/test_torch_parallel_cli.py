"""The training CLIs across ranks on the CPU (gloo).

* ``cli.train_len`` under ``torchrun --standalone --nproc_per_node 2``: the
  ranks join through torchrun's environment; rank 0 alone writes the
  checkpoint and the logs (one epoch line, one ``epoch ... done``), and the
  model equals the one-process run's within Adam's bound (each of 2 steps
  moves a weight by at most lr, either way on each side).
* ``cli.sr_train --distributed-world-size 2 --device cpu``: the CLI
  launches its ranks itself (a file rendezvous); rank 0 alone prints the
  steps and writes ``g_``/``do_``.  The ``g_`` written at W = 2 serves from
  the one-device ``VocoderEngine``, and the JAX package reads it into its
  generator's parameter tree.  A world that does not divide the batch is a
  usage error.
* ``parallel/dryrun.py --phase serving multiproc``: the engines split
  over two CPU devices equal one device within 2e-5, and ranks started
  through the environment, as torchrun starts them, agree on a step's loss.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.models.hifigan import CodeGenerator as JaxGenerator
from dissc_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
from dissc_tpu_torch.cli import sr_train, train_len
from dissc_tpu_torch.compat.from_jax import len_predictor_state_dict
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.train.checkpoints import load_checkpoint
from test_torch_data import write_code_corpus
from test_torch_prosody_train import write_unit_corpus
from test_torch_vocoder_train import write_config

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
LR = 3e-4  # train_len's default


def test_train_len_under_torchrun_writes_on_rank_0_only(tmp_path):
    data = tmp_path / "data"
    os.makedirs(data)
    write_unit_corpus(data, n_train=8, n_val=4)
    flags = ["--data_path", str(data), "--device", "cpu", "--n_epochs", "1",
             "--batch_size", "4", "--seed", "3"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "dissc_tpu_torch.cli.train_len", *flags, "--out_path", str(tmp_path / "w2")],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("epoch 0 done") == 1
    len_dir = tmp_path / "w2" / "len"
    assert sorted(os.listdir(len_dir)) == ["best_model.pth", "len_norm_stats.pth", "train", "val"]
    assert len((len_dir / "train" / "metrics.jsonl").read_text().splitlines()) == 1

    one = train_len.main(flags + ["--out_path", str(tmp_path / "w1")])
    two, ref = (len_predictor_state_dict(load_checkpoint(os.path.join(d, "best_model.pth")))
                for d in (len_dir, one))
    for k in ref:  # 2 Adam steps, each under lr: a noise-level gradient may flip sign
        np.testing.assert_allclose(two[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=2 * 2 * LR * (1 + 1e-3), err_msg=k)
    assert load_checkpoint(len_dir / "len_norm_stats.pth") == load_checkpoint(
        os.path.join(one, "len_norm_stats.pth"))


def test_sr_train_launches_its_ranks_and_rank_0_writes(tmp_path, capfd, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    root = tmp_path / "corpus"
    os.makedirs(root)
    config = write_config(root, write_code_corpus(root, n_files=4, seconds=(0.05, 0.2),
                                                  n_val=2))
    ckpt = tmp_path / "ckpt"
    assert sr_train.main(["--config", config, "--checkpoint_path", str(ckpt), "--device", "cpu",
                          "--distributed-world-size", "2", "--stdout_interval", "1",
                          "--training_steps", "2"]) is None
    out = capfd.readouterr().out
    assert "sr_train: 2 rank(s) on cpu, 1 of the batch of 2 each" in out
    assert out.count("step 1:") == 1 and out.count("step 2:") == 1  # rank 0 prints
    assert sorted(f for f in os.listdir(ckpt) if f[:2] in ("g_", "do")) == [
        "do_00000002", "g_00000002"]
    assert load_checkpoint(ckpt / "do_00000002")["steps"] == 2
    with open(ckpt / "config.json") as f:
        h = VocoderConfig(**{k: v for k, v in json.load(f).items()
                             if k in VocoderConfig.__dataclass_fields__})
    assert h.batch_size == 2  # the global batch, as configured

    item = {"code": np.arange(12) % 100, "spkr": np.array([1]),
            "f0": np.zeros((12, 1), np.float32)}
    wav, _ = VocoderEngine.from_checkpoint(str(ckpt), device="cpu").synthesize_utterances([item])
    assert wav[0].shape == (12 * 320,) and np.isfinite(wav[0]).all()
    # the JAX package reads the same g_ into its generator's tree
    tree = jax_load_checkpoint(str(ckpt / "g_00000002"))["generator"]
    jh = JaxConfig.from_json(str(ckpt / "config.json"))
    shapes = jax.eval_shape(JaxGenerator(jh).init, jax.random.key(0), jnp.zeros((1, 4), jnp.int32),
                            jnp.zeros((1, 4, 1)), jnp.zeros((1, 1), jnp.int32))["params"]
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(shapes)
    assert all(np.shape(a) == b.shape for a, b in zip(jax.tree_util.tree_leaves(tree),
                                                       jax.tree_util.tree_leaves(shapes)))


def test_dryrun_serving_and_ranks_started_through_the_environment(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "dissc_tpu_torch.parallel.dryrun", "--phase",
                           "serving", "multiproc", "--world", "2", "--out",
                           str(tmp_path / "out.npz")],
                          cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "multiproc: 2 ranks agree" in proc.stdout
    with np.load(tmp_path / "out.npz") as f:
        out = dict(f)
    assert np.isfinite(out["multiproc/loss"])
    waves = sorted(k for k in out if k.startswith("serving/wave_one/"))
    assert len(waves) == 8
    for k in waves:  # split over two CPU devices, one streamed
        np.testing.assert_allclose(out[k.replace("one", "split")], out[k], rtol=0, atol=2e-5)
    for k in (k for k in out if k.startswith("serving/prosody_one/")):
        np.testing.assert_allclose(out[k.replace("one", "split")], out[k], rtol=0, atol=2e-5)


def test_sr_train_refuses_a_world_that_does_not_divide_the_batch(tmp_path, capsys):
    root = tmp_path / "corpus"
    os.makedirs(root)
    config = write_config(root, write_code_corpus(root, n_files=2, seconds=(0.05, 0.1), n_val=1))
    with pytest.raises(SystemExit) as exit_info:  # 3 ranks cannot share a batch of 2
        sr_train.main(["--config", config, "--checkpoint_path", str(tmp_path / "c"),
                       "--device", "cpu", "--distributed-world-size", "3"])
    assert exit_info.value.code == 2
    assert "--distributed-world-size 3 must divide batch_size 2" in capsys.readouterr().err
    assert not (tmp_path / "c").exists()
