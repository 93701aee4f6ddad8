"""Port's vocoder training loop (``train_vocoder`` through ``cli.sr_train``) and
its checkpoints, against the JAX package.

Small config as in ``test_torch_gan_step.py`` (generator width 32,
1280-sample segments at batch 2), with one MPD period and the one
spectral-norm MSD scale for the loop, on a toy corpus of 4 wavs (3
speakers, some shorter than a segment), so an epoch is 2 optimizer steps.

* The learning rate of every optimizer step equals
  ``optax.exponential_decay(lr, steps_per_epoch, lr_decay, staircase=True)``
  at that step's count, across three epoch boundaries and after a resume
  (rtol 1e-6: optax computes it in float32).
* ``to_jax`` inverts ``from_jax`` exactly for the generator, MPD, MSD with
  its spectral ``u``, ``LenPredictor`` and both pitch models: the same tree
  and the same arrays.
* The ``g_`` the loop writes serves through the JAX ``VocoderEngine`` and
  the port's with waveforms within 1e-4.
* A resumed run starts from exactly the saved step, epoch, parameters,
  buffers and optimizer states.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.infer.vocoder import VocoderEngine as JaxEngine
from dissc_tpu.train.prosody_trainer import build_pitch_model as jax_build_pitch
from dissc_tpu.models.prosody import LenPredictor as JaxLen
from dissc_tpu_torch.cli import sr_train
from dissc_tpu_torch.compat import from_jax, to_jax
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.train import vocoder_trainer
from dissc_tpu_torch.train.checkpoints import load_checkpoint
from test_torch_data import write_code_corpus
from test_torch_gan_step import CFG, _disc_trees
from test_torch_hifigan import random_generator_params
from test_torch_prosody import random_variables

torch.set_num_threads(2)
LR_DECAY = 0.9  # large enough that each epoch's rate differs visibly
LOOP_CFG = dict(CFG, mpd_periods=(2,), msd_scales=1)


def write_config(root, corpus, path=None, **over):
    """``config.json`` (at ``path``, default in ``root``) for the corpus in ``root``."""
    train, val = corpus
    cfg = dict(LOOP_CFG, lr_decay=LR_DECAY, input_training_file=train, input_validation_file=val,
               train_base_path=str(root), val_base_path=str(root), **over)
    path = path or root / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def run_cli(config, ckpt, steps, **flags):
    argv = ["--config", config, "--checkpoint_path", str(ckpt), "--training_steps", str(steps),
            "--device", "cpu", "--stdout_interval", "1"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return sr_train.main(argv)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocoder")
    corpus = write_code_corpus(root, n_files=4, seconds=(0.05, 0.2), n_val=2)
    return root, write_config(root, corpus)


def test_lr_at_is_optax_exponential_decay():
    h = VocoderConfig(learning_rate=8e-4, lr_decay=0.999)
    sched = optax.exponential_decay(h.learning_rate, transition_steps=7, decay_rate=h.lr_decay,
                                    staircase=True)
    for step in range(0, 40):
        assert vocoder_trainer.lr_at(h, step, 7) == pytest.approx(float(sched(step)), rel=1e-6)
    assert vocoder_trainer.lr_at(h, 10**6, None) == h.learning_rate


def test_every_step_takes_the_schedule_across_epochs_and_resume(toy, tmp_path, monkeypatch):
    _, config = toy
    h = VocoderConfig.from_json(config)
    sched = optax.exponential_decay(h.learning_rate, transition_steps=2, decay_rate=LR_DECAY,
                                    staircase=True)
    seen = []
    step_fn = vocoder_trainer.GANTrainer.train_step

    def recording(self, batch):
        seen.append((self.step, self.opt_g.param_groups[0]["lr"],
                     self.opt_d.param_groups[0]["lr"]))
        return step_fn(self, batch)

    monkeypatch.setattr(vocoder_trainer.GANTrainer, "train_step", recording)
    first, _ = run_cli(config, tmp_path, 3, checkpoint_interval=100, validation_interval=100)
    assert [s for s, _, _ in seen] == list(range(3))
    second, stats = run_cli(config, tmp_path, 7, checkpoint_interval=100,
                            validation_interval=100)
    assert stats["start_step"] == 3 and second.step == 7
    assert [s for s, _, _ in seen] == list(range(7))  # epoch boundaries at 2, 4 and 6
    for step, lr_g, lr_d in seen:
        assert lr_g == lr_d == pytest.approx(float(sched(step)), rel=1e-6), step
    assert first.opt_g.param_groups[0]["lr"] == pytest.approx(float(sched(3)), rel=1e-6)
    assert second.opt_g.param_groups[0]["lr"] == pytest.approx(float(sched(7)), rel=1e-6)


def _same_tree(a, b, path=""):
    assert isinstance(b, dict) == isinstance(a, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_to_jax_inverts_from_jax_for_the_vocoder(resblock):
    jh, th = JaxConfig(**CFG, resblock=resblock), VocoderConfig(**CFG, resblock=resblock)
    gen = jax.device_get(random_generator_params(jh, seed=3))
    _same_tree(to_jax.generator_tree(from_jax.generator_state_dict(gen, th), th), gen)
    mpd, msd, spectral = _disc_trees(jh, seed=4)
    _same_tree(to_jax.mpd_tree(from_jax.mpd_state_dict(mpd)), mpd)
    params, spec = to_jax.msd_trees(from_jax.msd_state_dict(msd, spectral))
    _same_tree(params, msd)
    _same_tree(spec, spectral)


@pytest.mark.parametrize("model", ["len", "base", "new"])
def test_to_jax_inverts_from_jax_for_the_prosody_models(model):
    seq, spk = jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 1), jnp.int32)
    if model == "len":
        variables = random_variables(JaxLen(n_tokens=100, n_speakers=5), seq, spk, (4.0, 2.0))
        back = to_jax.len_predictor_variables(from_jax.len_predictor_state_dict(variables))
    else:
        variables = random_variables(jax_build_pitch(model, 100, 5), seq, spk, seed=1)
        back = to_jax.pitch_predictor_variables(
            from_jax.pitch_predictor_state_dict(variables, model))
    _same_tree(back, jax.device_get(variables))


def test_loop_checkpoint_serves_in_both_packages_and_resume_is_exact(toy, tmp_path):
    root, config = toy
    h = VocoderConfig.from_json(config)
    trained, _ = run_cli(config, tmp_path, 3, checkpoint_interval=2, validation_interval=2)
    names = sorted(os.listdir(tmp_path))
    for name in ("config.json", "id_to_spkr.pkl", "g_00000002", "do_00000002", "g_00000003",
                 "do_00000003"):
        assert name in names
    assert load_checkpoint(str(tmp_path / "id_to_spkr.pkl")) == ["p225", "p226", "p227"]
    logs = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert any("validation/mel_spec_error" in r for r in logs)
    assert (tmp_path / "logs" / "generated_y_hat_0_2.wav").exists()
    do = load_checkpoint(str(tmp_path / "do_00000003"))
    assert do["steps"] == 3 and do["epoch"] == 1  # rewritten at the top of epoch 1

    # the written g_ serves in both packages
    rng = np.random.default_rng(4)
    code = rng.integers(0, 100, (2, 9)).astype(np.int64)
    f0 = rng.uniform(-1, 1, (2, 9, 1)).astype(np.float32)
    spkr = np.array([[0], [2]], np.int64)
    ref, _ = JaxEngine.from_checkpoint(str(tmp_path)).synthesize_batch(
        code.astype(np.int32), f0, spkr.astype(np.int32))
    got, _ = VocoderEngine.from_checkpoint(str(tmp_path), device="cpu").synthesize_batch(
        code, f0, spkr)
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() < 1e-4
    with torch.inference_mode():
        direct = trained.gen(torch.from_numpy(code), torch.from_numpy(f0),
                             torch.from_numpy(spkr))
    assert np.abs(direct.numpy() - np.asarray(got)).max() < 1e-4

    # a finished run resumes to exactly the saved state and returns at once
    resumed, stats = run_cli(config, tmp_path, 3)
    assert resumed.step == trained.step == 3 and stats["step_s"] == []
    for a, b in ((trained.gen, resumed.gen), (trained.mpd, resumed.mpd),
                 (trained.msd, resumed.msd)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for oa, ob in ((trained.opt_g, resumed.opt_g), (trained.opt_d, resumed.opt_d)):
        sa, sb = oa.state_dict(), ob.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        assert set(sa["state"]) == set(sb["state"]) and sa["state"]
        for i in sa["state"]:
            for k, v in sa["state"][i].items():
                assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_prefetch_worker_error_reaches_the_loop(tmp_path):
    """A batch the worker cannot load raises in the loop, with its own type;
    the epoch does not end quietly."""
    def batches():
        yield {"x": np.zeros(2, np.float32)}
        raise IOError("native crop loader: 1/2 wav files failed to decode")

    seen = []
    with pytest.raises(IOError, match="failed to decode"):
        with vocoder_trainer.Prefetcher(batches()) as prefetch:
            for batch in prefetch:
                seen.append(batch)
    assert len(seen) == 1

    root = tmp_path / "corpus"
    os.makedirs(root)
    config = write_config(root, write_code_corpus(root, n_files=4, seconds=(0.05, 0.1), n_val=1))
    os.remove(next(root.glob("p226_*.wav")))  # a manifest line whose wav is gone
    with pytest.raises(OSError, match="p226_"):
        run_cli(config, tmp_path / "ckpt", 4)


def test_train_split_smaller_than_a_batch_raises(toy, tmp_path):
    root, _ = toy
    config = write_config(root, (str(root / "train.jsonl"), str(root / "val.jsonl")),
                          path=tmp_path / "config.json", batch_size=8)
    with pytest.raises(ValueError, match="no full batch"):
        run_cli(config, tmp_path / "ckpt", 2)
