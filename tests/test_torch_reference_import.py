"""Port's importer of the reference's own torch checkpoints
(``compat/torch_import.py``) vs ``dissc_tpu.compat.torch_import``.

Reference-shaped synthetic state dicts: the generator and prosody models
as the JAX package's ``torch_export`` writes the reference layout (with
BatchNorm's ``num_batches_tracked``, and the "new" pitch model's stored
ramp ``pe.pe``), the discriminators in ``sr/models.py``'s naming with
numpy draws (weight-norm ``weight_g``/``weight_v``; the MSD's first scale
spectral-normed, with torch's ``weight_orig``, ``weight_u`` and power
iteration ``weight_v``), as ``tests/test_compat_vq.py`` builds them.  For
each of ``CodeGenerator``, MPD, MSD, ``LenPredictor`` and
``PitchPredictor`` (base, new), the port's import runs against the JAX
``import_*`` followed by ``apply``, within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.compat import torch_export as jexport
from dissc_tpu.compat import torch_import as jimport
from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.models import discriminators as jdisc
from dissc_tpu.models.hifigan import CodeGenerator as JaxCodeGenerator
from dissc_tpu.models.prosody import LenPredictor as JaxLen
from dissc_tpu.train.prosody_trainer import build_pitch_model as jax_build_pitch
from dissc_tpu_torch.compat import torch_import as timport
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.models.discriminators import MultiPeriodDiscriminator, MultiScaleDiscriminator
from test_torch_hifigan import SMALL, random_generator_params
from test_torch_prosody import STATS, random_variables

torch.set_num_threads(2)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=what)


def test_code_generator_checkpoint_imports_as_jax_does(tmp_path):
    jh, th = JaxConfig(**SMALL), VocoderConfig(**SMALL)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          jexport.export_code_generator(random_generator_params(jh, seed=3), jh).items()}
    torch.save({"generator": sd}, tmp_path / "g_00400000")
    model = timport.import_vocoder_checkpoint(str(tmp_path / "g_00400000"), th)
    params = jimport.import_vocoder_checkpoint(str(tmp_path / "g_00400000"), jh)["generator"]
    rng = np.random.default_rng(4)
    code, f0 = rng.integers(0, 100, (2, 6)).astype(np.int32), rng.normal(0, 1, (2, 6, 1))
    spkr = np.array([[3], [150]], np.int32)
    ref = jax.jit(JaxCodeGenerator(jh).apply)({"params": params}, jnp.asarray(code),
                                              jnp.asarray(f0, jnp.float32), jnp.asarray(spkr))
    with torch.no_grad():
        out = model(torch.from_numpy(code).long(), torch.from_numpy(f0).float(),
                    torch.from_numpy(spkr).long())
    _close(out.numpy(), ref, "waveform")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        timport.import_code_generator(dict(sd, **{"f0_vq.level_blocks.0.k": torch.zeros(2)}), th)


def _disc_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """The reference's keys and shapes with numpy draws, and torch
    spectral norm's power-iteration ``weight_v`` beside each ``weight_u``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, ref in module.state_dict().items():
        shape = tuple(ref.shape)
        scale = {"weight_g": 0.5, "bias": 0.05, "weight_u": 1.0}.get(key.rsplit(".", 1)[1], 0.05)
        sd[key] = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
        if key.endswith(".weight_orig"):
            v = rng.standard_normal(int(np.prod(shape[1:]))).astype(np.float32)
            sd[key[:-len("orig")] + "v"] = torch.from_numpy(v / np.linalg.norm(v))
    return sd


@pytest.mark.parametrize("kind", ["mpd", "msd"])
def test_discriminator_checkpoints_import_as_jax_does(kind, tmp_path):
    rng = np.random.default_rng(5)
    y, y_hat = (rng.uniform(-0.5, 0.5, (2, 1280)).astype(np.float32) for _ in range(2))
    if kind == "mpd":
        sd = _disc_state_dict(MultiPeriodDiscriminator(), 6)
        model = timport.import_mpd({"mpd": sd})
        variables = {"params": jimport.import_mpd(sd)}
        jm = jdisc.MultiPeriodDiscriminator()
    else:
        sd = _disc_state_dict(MultiScaleDiscriminator(), 7)
        assert "discriminators.0.convs.3.weight_v" in sd and "discriminators.1.convs.3.weight_g" in sd
        model = timport.import_msd(sd)
        variables = jimport.import_msd(sd)
        jm = jdisc.MultiScaleDiscriminator()
    ref = jax.jit(jm.apply)(variables, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(y), torch.from_numpy(y_hat))
    for i in (0, 1):  # real and generated scores of every discriminator
        for a, b in zip(out[i], ref[i]):
            _close(a.numpy(), b, f"{kind} scores {i}")


def _with_bn_counts(sd):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    for k in list(out):
        if k.endswith(".running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(1000)
    return out


def _seq(seed=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 100, (2, 40)).astype(np.int32), np.array([[1], [3]], np.int32)


def test_len_predictor_checkpoint_imports_as_jax_does():
    seq, spk = _seq()
    jm = JaxLen(n_tokens=100, n_speakers=5)
    sd = _with_bn_counts(jexport.export_len_predictor(
        random_variables(jm, jnp.asarray(seq), jnp.asarray(spk), STATS, seed=9)))
    model = timport.import_len_predictor(sd).eval()
    ref = jax.jit(jm.apply)(jimport.import_len_predictor(sd), jnp.asarray(seq), jnp.asarray(spk),
                            STATS)
    with torch.no_grad():
        out = model(torch.from_numpy(seq).long(), torch.from_numpy(spk).long(),
                    tuple(float(s) for s in STATS))
    _close(out.numpy(), ref, "durations")
    assert int(model.bn1.num_batches_tracked) == 1000


@pytest.mark.parametrize("model_type", ["base", "new"])
def test_pitch_predictor_checkpoint_imports_as_jax_does(model_type):
    seq, spk = _seq(10)
    jm = jax_build_pitch(model_type, 100, 5)
    sd = _with_bn_counts(jexport.export_pitch_predictor(
        random_variables(jm, jnp.asarray(seq), jnp.asarray(spk), seed=11), model_type))
    assert ("pe.pe" in sd) == (model_type == "new")
    model = timport.import_pitch_predictor(sd, model_type).eval()
    ref = jax.jit(jm.apply)(jimport.import_pitch_predictor(sd, model_type), jnp.asarray(seq),
                            jnp.asarray(spk))
    with torch.no_grad():
        out = model(torch.from_numpy(seq).long(), torch.from_numpy(spk).long())
    _close(out[0].numpy(), ref[0], "voicing logits")
    _close(out[1].numpy(), ref[1], "f0")
    if model_type == "new":
        with pytest.raises(ValueError, match="ramp"):
            timport.import_pitch_predictor(dict(sd, **{"pe.pe": sd["pe.pe"] * 2}), model_type)
