"""Port's data-parallel prosody and VQ steps vs the JAX package's one-device steps.

``parallel/dryrun.py --phase prosody vq`` runs twice as a command: W = 2
ranks joined by gloo over CPU processes (``OMP_NUM_THREADS=1``), and one
process with no group (``--backend none``), each on a seeded global batch of
8 (4 rows a rank):

* ``prosody``: ``LenPredictor``, ``PitchPredictor`` and
  ``PitchPredictorBase`` at masking 0 through the trainers' steps (synced
  BatchNorm, DDP, the summed loss scaled by W), one SGD step (lr 1e-3 over
  the batch's non-pad tokens: the losses are sums) from numpy-drawn
  weights: parameters and ``batch_stats`` within 2e-5 of JAX
  ``make_len_steps``/``make_pitch_steps`` on one device, metrics summed over
  the ranks within rtol 1e-5; with masks and PE dropout on (drawn at the
  global batch's shape), W = 2 equals the port with no group within 2e-5;
* ``vq``: one EMA update of a ``BottleneckBlock`` whose dead last code
  restarts: codes equal, EMA sums, counts, kept rows and metrics within
  1e-5 of JAX ``Bottleneck`` on one device; the restarted row is the
  one-process port's (the same generator) within 1e-6 and a data row plus
  noise.  One ``Quantizer`` train step with a restart under DDP equals the
  one-process port within 2e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dissc_tpu.core.config import ProsodyConfig as JaxProsodyConfig
from dissc_tpu.models import prosody as jmodels
from dissc_tpu.models import vq as jvq
from dissc_tpu.train import prosody_trainer as jtrain
from dissc_tpu_torch.compat import to_jax
from dissc_tpu_torch.core.config import ProsodyConfig
from test_torch_parallel import assert_trees_close, dryrun, tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    w2 = dryrun(tmp / "w2.npz", "--phase", "prosody", "vq", "--world", "2", "--backend", "gloo")
    w1 = dryrun(tmp / "w1.npz", "--phase", "prosody", "vq", "--world", "1", "--backend", "none")
    return w2, w1


def _jax_prosody(name, w2):
    """(JAX state after one SGD step from the port's initial weights, metrics)."""
    vals, lens, gts, spk = (jnp.asarray(w2[f"prosody/batch/{k}"]).astype(
        jnp.int32 if k in ("vals", "spk") else jnp.float32) for k in ("vals", "lens", "gts",
                                                                       "spk"))
    cfg = ProsodyConfig(emb_size=8, hidden=16)
    init = tree(w2, f"prosody/plain/{name}/init")
    if name == "len":
        jm = jmodels.LenPredictor(n_tokens=100, n_speakers=5, emb_size=8, hidden=16,
                                  masking_rate=0.0)
        variables = to_jax.len_predictor_variables(init)
        step, _ = jtrain.make_len_steps(jm, (4.0, 2.0), -1.0)
        args = (vals, lens, spk)
    else:
        jm = jtrain.build_pitch_model(name, 100, 5, JaxProsodyConfig(
            emb_size=cfg.emb_size, hidden=cfg.hidden, pitch_masking_rate=0.0))
        variables = to_jax.pitch_predictor_variables(init)
        step, _ = jtrain.make_pitch_steps(jm, w2["prosody/id2mean"], w2["prosody/id2std"],
                                          -100.0)
        args = (vals, gts, spk)
    lr = float(w2[f"prosody/plain/{name}/lr"])  # 1e-3 over the batch's tokens
    state = jtrain.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                     tx=optax.sgd(lr), batch_stats=variables["batch_stats"])
    return step(state, *args, jax.random.key(0))


@pytest.mark.parametrize("name", ["len", "new", "base"])
def test_prosody_step_at_two_ranks_matches_the_jax_one_device_step(runs, name, monkeypatch):
    w2, _ = runs
    # the JAX model's PE dropout is fixed at 0.4: 0 here, as in the port's plain run
    monkeypatch.setattr(jmodels, "LinearRampPE",
                        functools.partial(jmodels.LinearRampPE, dropout=0.0))
    state, metrics = _jax_prosody(name, w2)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(w2[f"prosody/plain/{name}/metrics/{k}"]), float(v),
                                   rtol=1e-5, err_msg=k)
    to = to_jax.len_predictor_variables if name == "len" else to_jax.pitch_predictor_variables
    got = to(tree(w2, f"prosody/plain/{name}/final"))
    ref = {"params": jax.device_get(state.params),
           "batch_stats": jax.device_get(state.batch_stats)}
    assert_trees_close(got, ref, 2e-5, name)


@pytest.mark.parametrize("name", ["len", "new", "base"])
def test_prosody_masked_step_is_the_same_at_one_and_two_ranks(runs, name):
    w2, w1 = runs
    prefix = f"prosody/masked/{name}"
    before, two, one = (tree(r, f"{prefix}/{s}") for r, s in ((w2, "init"), (w2, "final"),
                                                              (w1, "final")))
    assert max(float((two[k] - before[k]).abs().max()) for k in two) > 1e-4  # it trained
    for k in one:
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(), rtol=0, atol=2e-5,
                                   err_msg=k)
    for k in ("Loss", "MAE") if name == "len" else ("loss", "MAE"):
        np.testing.assert_allclose(w2[f"{prefix}/metrics/{k}"], w1[f"{prefix}/metrics/{k}"],
                                   rtol=1e-5, err_msg=k)


def test_vq_update_at_two_ranks_matches_the_jax_one_device_update(runs):
    w2, w1 = runs
    x = w2["vq/block/x"]  # [B, D, T] as the port lays it out
    state = {k: jnp.asarray(w2[f"vq/block/init/{k}"]) for k in ("k", "k_sum", "k_elem",
                                                                "initted")}
    block = jvq.Bottleneck(l_bins=4, emb_width=6, mu=0.9, levels=1)
    (codes, _, _, metrics), new = block.apply(
        {"vq_state": {"level_0": state}}, [jnp.asarray(x.transpose(0, 2, 1))],
        rngs={"vq": jax.random.key(5)}, mutable=["vq_state"])
    ref = jax.device_get(new["vq_state"]["level_0"])
    np.testing.assert_array_equal(w2["vq/block/codes"], np.asarray(codes[0]))
    for k in ("k_sum", "k_elem"):
        np.testing.assert_allclose(w2[f"vq/block/final/{k}"], ref[k], atol=1e-5, err_msg=k)
    assert float(ref["k_elem"][-1]) < 1.0 <= float(ref["k_elem"][:-1].min())  # last restarts
    np.testing.assert_allclose(w2["vq/block/final/k"][:-1], ref["k"][:-1], atol=1e-5)
    for k in ("usage", "used_curr", "entropy", "fit", "pn"):
        np.testing.assert_allclose(float(w2[f"vq/block/metrics/{k}"]), float(metrics[0][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the restart's draw is the port's own generator's: as the one-process run
    restarted = w2["vq/block/final/k"][-1]
    np.testing.assert_allclose(restarted, w1["vq/block/final/k"][-1], atol=1e-6)
    rows = x.transpose(0, 2, 1).reshape(-1, 6)
    assert np.abs(rows - restarted).max(axis=1).min() < 6 * 0.01 / np.sqrt(6)


def test_quantizer_step_with_a_restart_is_the_same_at_one_and_two_ranks(runs):
    w2, w1 = runs
    two, one = tree(w2, "vq/quantizer/final"), tree(w1, "vq/quantizer/final")
    before = tree(w2, "vq/quantizer/init")
    k_elem = "vq.level_blocks.0.k_elem"
    assert float(two[k_elem][-1]) < 1.0 <= float(before[k_elem][-1])  # the dead code restarted
    assert float(w2["vq/quantizer/usage"]) < before[k_elem].numel()
    for k in one:
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(), rtol=0, atol=2e-5,
                                   err_msg=k)
