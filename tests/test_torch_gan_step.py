"""Port's GAN train step vs JAX ``make_gan_train_step``, steps 1 and 2.

Small config: generator width 32, MPD periods (2, 3), two MSD scales (the
spectral-normed scale 0 and one pooled scale), 1280-sample segments at
batch 2.  Both sides start from the same numpy-drawn weights and spectral
``u`` (carried by ``compat.from_jax``) and see the same batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.train.vocoder_trainer import GANState, make_gan_train_step, make_models
from dissc_tpu_torch.compat.from_jax import (generator_state_dict, msd_state_dict,
                                             mpd_state_dict)
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.train.vocoder_trainer import GANTrainer
from test_torch_hifigan import SMALL, random_generator_params

torch.set_num_threads(2)
CFG = dict(SMALL, segment_size=1280, batch_size=2, mpd_periods=(2, 3), msd_scales=2)
SEG = 4  # code frames per segment
LR = 8e-4


def _disc_trees(h, seed):
    gen, mpd, msd = make_models(h)
    y = jnp.zeros((1, SEG * 320))
    m = jax.eval_shape(mpd.init, jax.random.key(0), y, y)
    s = jax.eval_shape(msd.init, jax.random.key(0), y, y)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        scale = {"g": 0.5, "bias": 0.05, "u": 1.0}.get(path[-1].key, 0.05)
        return (rng.standard_normal(a.shape) * scale).astype(np.float32)

    fill = lambda tree: jax.tree_util.tree_map_with_path(draw, tree)
    return fill(m["params"]), fill(s["params"]), fill(s["spectral"])


def _batches():
    rng = np.random.default_rng(7)
    return [{"code": rng.integers(0, 100, (2, SEG)).astype(np.int32),
             "f0": rng.normal(0, 1, (2, SEG, 1)).astype(np.float32),
             "spkr": np.array([[1], [5]], np.int32),
             "audio": rng.uniform(-0.5, 0.5, (2, SEG * 320)).astype(np.float32)}
            for _ in range(2)]


@pytest.fixture(scope="module")
def runs():
    jh, th = JaxConfig(**CFG), VocoderConfig(**CFG)
    gen_p = random_generator_params(jh, seed=4)
    mpd_p, msd_p, spec = _disc_trees(jh, seed=5)
    tx = lambda: optax.adamw(jh.learning_rate, b1=jh.adam_b1, b2=jh.adam_b2, weight_decay=0.01)
    gen_tx, disc_tx = tx(), tx()
    state = GANState(gen_p, mpd_p, msd_p, spec, gen_tx.init(gen_p),
                     disc_tx.init({"mpd": mpd_p, "msd": msd_p}), jnp.zeros((), jnp.int32))
    train_step, val_step = make_gan_train_step(jh, gen_tx, disc_tx)

    trainer = GANTrainer(th, device="cpu")
    # load_state_dict copies in place, so the optimizers keep the parameters
    trainer.gen.load_state_dict(generator_state_dict(gen_p, th))
    trainer.mpd.load_state_dict(mpd_state_dict(mpd_p))
    trainer.msd.load_state_dict(msd_state_dict(msd_p, spec))
    jax_metrics, port_metrics, gen_after_1 = [], [], None
    for i, batch in enumerate(_batches()):
        state, m = train_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_metrics.append({k: float(v) for k, v in m.items()})
        pm = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
        port_metrics.append({k: float(v) for k, v in pm.items()})
        if i == 0:
            gen_after_1 = (generator_state_dict(jax.device_get(state.gen_params), th),
                           {k: v.detach().clone() for k, v in trainer.gen.state_dict().items()})
    batch = _batches()[0]
    jax_err, _ = val_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    port_err, y_hat = trainer.val_step({k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(jax=jax_metrics, port=port_metrics, gen_after_1=gen_after_1,
                val=(np.asarray(jax_err), port_err.numpy(), y_hat), trainer=trainer)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("name", ["loss_disc", "loss_gen_total", "loss_mel", "loss_fm",
                                  "loss_adv"])
def test_losses_match_jax_step(runs, step, name):
    """Step-1 D loss sees identical weights (f32 order only: rtol 1e-5).
    The G losses and step 2 follow AdamW updates whose first step is about
    lr * sign(grad): a gradient entry at float-noise level can flip sign
    between frameworks and move that weight by up to 2 lr, so rtol 1e-3."""
    j, p = runs["jax"][step][name], runs["port"][step][name]
    assert np.isfinite(p)
    rtol = 1e-5 if (step, name) == (0, "loss_disc") else 1e-3
    np.testing.assert_allclose(p, j, rtol=rtol, atol=1e-6)


def test_generator_params_after_step_1(runs):
    """Nearly all entries agree to float noise; none moves more than 2 lr
    apart (a sign flip of a noise-level gradient in Adam's first step)."""
    jax_sd, port_sd = runs["gen_after_1"]
    diffs = np.concatenate([(port_sd[k] - jax_sd[k]).abs().flatten().numpy()
                            for k in jax_sd])
    assert np.median(diffs) < 1e-6
    assert np.mean(diffs < 1e-5) > 0.99
    assert diffs.max() <= 2 * LR + 1e-5


def test_val_step_per_item_errors(runs):
    jax_err, port_err, y_hat = runs["val"]
    assert port_err.shape == (2,) and y_hat.shape == (2, SEG * 320)
    np.testing.assert_allclose(port_err, jax_err, rtol=1e-3)


def test_trainer_state_moves_and_spectral_u_advances(runs):
    trainer = runs["trainer"]
    assert trainer.step == 2
    u = trainer.msd.discriminators[0].convs[0].weight_u
    assert torch.isfinite(u).all() and abs(float(u.norm()) - 1.0) < 1e-5
    assert all(p.requires_grad for p in trainer.mpd.parameters())  # unfrozen after G step
