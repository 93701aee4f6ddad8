"""Port's F0 quantizer training path and k-means vs the JAX package's.

``F0Dataset`` items (crop, f0, speaker, whitening with the median fill)
bit for bit against ``dissc_tpu.data.code_dataset.F0Dataset`` on temp
WAVs, the JAX tracker replaced by the port's so that both whiten the same
contour (the two trackers agree on voicing exactly and on f0 to 1e-4,
``test_torch_yaapt.py``); one quantizer ``train_step`` against the JAX
step from the same state (no restart), parameters within 1e-5 after
AdamW; ``train_f0_quantizer`` for a few steps on the CPU, its ``g_`` read
by the JAX ``load_checkpoint`` and reconstructing as the port does; and
``train_kmeans`` centroids within 1e-5, inertia within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dissc_tpu.audio import yaapt as jyaapt
from dissc_tpu.data import code_dataset as jcd
from dissc_tpu.models import kmeans as jkmeans
from dissc_tpu.models import vq as jvq
from dissc_tpu.train import quantizer_trainer as jqt
from dissc_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
from dissc_tpu_torch.audio import yaapt as tyaapt
from dissc_tpu_torch.compat.from_jax import quantizer_state_dict
from dissc_tpu_torch.compat.to_jax import quantizer_trees
from dissc_tpu_torch.data import code_dataset as tcd
from dissc_tpu_torch.models import kmeans as tkmeans
from dissc_tpu_torch.models.vq import Quantizer
from dissc_tpu_torch.train import quantizer_trainer as tqt
from test_torch_data import write_pcm16
from test_torch_vq import QP, draw_like, given_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Six 16 kHz int16 WAVs of three speakers, some shorter than a crop
    (they tile), voiced with stretches of silence."""
    root = tmp_path_factory.mktemp("f0_wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i, seconds in enumerate((0.25, 0.7, 0.4, 1.1, 0.3, 0.9)):
        t = np.arange(int(seconds * 16000)) / 16000
        env = (np.sin(2 * np.pi * 3 * t) > -0.2).astype(np.float64)
        x = env * np.sin(2 * np.pi * rng.uniform(100, 220) * t) * 0.5
        write_pcm16(root / f"p{225 + i % 3}_{i:03d}.wav", (x + 0.01 * rng.standard_normal(t.size))
                    * 16000)
        paths.append(str(root / f"p{225 + i % 3}_{i:03d}.wav"))
    return paths


@pytest.mark.parametrize("kw", [dict(), dict(pad=320),
                                dict(f0_normalize=True, f0_median=True,
                                     f0_stats={0: {"f0_mean": 150.0, "f0_std": 30.0},
                                               "f0_mean": 140.0, "f0_std": 25.0}),
                                dict(f0_normalize=True, f0_interp=True)])
def test_f0_dataset_items_match_jax(wavs, kw, monkeypatch):
    monkeypatch.setattr(jyaapt, "yaapt_f0",
                        lambda audio, sr, interp=False: tyaapt.yaapt_f0(audio, sr, interp,
                                                                        device="cpu"))
    ref = jcd.F0Dataset(wavs, 4800, 16000, seed=3, **kw)
    got = tcd.F0Dataset(wavs, 4800, 16000, seed=3, f0_device="cpu", **kw)
    assert got.id_to_spkr == ref.id_to_spkr == ["p225", "p226", "p227"] and len(got) == 6
    for i in [0, 1, 2, 3, 4, 5, 3, 0]:  # twice over two: the crop stream goes on
        a, b = got[i], ref[i]
        assert set(a) == set(b) == {"f0", "spkr", "audio", "filename"}
        for k in ("f0", "spkr", "audio"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} of item {i}")
        assert a["filename"] == b["filename"] and a["f0"].shape == (60, 1)
    voiced = got[1]["f0"]
    assert (voiced != 0).any() if not kw.get("f0_normalize") else np.isfinite(voiced).all()


def _state(seed=20):
    f0 = np.random.default_rng(seed).standard_normal((4, 48, 1)).astype(np.float32) * 0.5
    shapes = jax.eval_shape(jvq.Quantizer(**QP).init,
                            {"params": jax.random.key(0), "vq": jax.random.key(1)},
                            jnp.asarray(f0))
    params = draw_like(shapes["params"], seed + 1)
    enc = jvq.Quantizer(**QP).apply({"params": params}, jnp.asarray(f0),
                                    method=lambda m, x: m.encoder(x))
    return f0, params, {"vq": given_state(shapes["vq_state"]["vq"], np.asarray(enc[0]), seed + 2)}


def test_one_train_step_matches_jax():
    f0, params, vq_state = _state()
    tx = optax.adamw(2e-4, b1=0.8, b2=0.99)
    train_step, _ = jqt.make_quantizer_steps(jvq.Quantizer(**QP), tx, 0.02)
    ref, ref_metrics = train_step(
        jqt.QuantizerState(params, vq_state, tx.init(params), jnp.zeros((), jnp.int32)),
        jnp.asarray(f0), jax.random.key(3))
    model = Quantizer(**QP)
    model.load_state_dict(quantizer_state_dict(params, vq_state, QP))
    state = tqt.QuantizerState(model, tqt.make_optimizer(model, 2e-4), 0)
    step, _ = tqt.make_quantizer_steps(0.02)
    state, metrics = step(state, torch.from_numpy(f0).transpose(1, 2))
    assert state.step == 1
    for k in ("loss", "recon", "commit", "entropy", "usage", "used_curr"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=1e-5, err_msg=k)
    got_params, got_state = quantizer_trees(model.state_dict(), QP)
    got = dict(jax.tree_util.tree_leaves_with_path(got_params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref.params):
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=1e-5, err_msg=str(path))
    for k in ("k", "k_sum", "k_elem"):
        np.testing.assert_allclose(got_state["vq"]["level_0"][k],
                                   np.asarray(ref.vq_state["vq"]["level_0"][k]), atol=1e-5)


def test_train_f0_quantizer_writes_a_g_the_jax_package_reads(wavs, tmp_path):
    ds = tcd.F0Dataset(wavs, 5120, 16000, seed=4, f0_device="cpu")  # 64 frames: 16 | 64
    state = tqt.train_f0_quantizer(ds, str(tmp_path / "vq"), batch_size=2, training_steps=5,
                                   checkpoint_interval=2, quantizer_params=QP, device="cpu")
    assert state.step == 5 and bool(state.model.vq.level_blocks[0].initted)
    names = sorted(p.name for p in (tmp_path / "vq").iterdir())
    assert names == ["g_00000002", "g_00000004", "g_00000005", "logs"]
    ckpt = jax_load_checkpoint(str(tmp_path / "vq" / "g_00000005"))
    f0 = np.stack([ds[i]["f0"] for i in range(2)]) / 200.0
    ref, _, _ = jvq.Quantizer(**QP).apply({"params": ckpt["generator"],
                                           "vq_state": ckpt["vq_state"]}, jnp.asarray(f0),
                                          update_k=False, rngs={"vq": jax.random.key(0)})
    with torch.no_grad():
        out, _, _ = state.model(torch.from_numpy(f0).transpose(1, 2), update_k=False)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref), atol=1e-4)


def test_train_kmeans_matches_jax():
    rng = np.random.default_rng(30)
    centers = rng.normal(0, 4, (12, 16))
    batches = [(centers[rng.integers(0, 12, 200)] + rng.normal(0, 1, (200, 16))).astype(np.float32)
               for _ in range(5)]
    ref_c, ref_inertia = jkmeans.train_kmeans(batches, k=10, n_epochs=3, seed=1)
    got_c, got_inertia = tkmeans.train_kmeans(batches, k=10, n_epochs=3, seed=1, device="cpu")
    np.testing.assert_allclose(got_c, ref_c, atol=1e-5)
    assert abs(got_inertia - ref_inertia) <= 1e-5 * abs(ref_inertia)
    with pytest.raises(ValueError, match="no feature batches"):
        tkmeans.train_kmeans([], device="cpu")
