"""The port's bfloat16 HuBERT vs the JAX encoder's, same weights.

``HubertConfig(compute_dtype="bfloat16")`` is flax's mixed precision: the
convs, dense layers and positional conv in bfloat16, float32 parameters,
the norms promoting their output to float32, softmax in float32.  The
reference is the JAX encoder applied op by op (not under ``jax.jit``):
XLA's CPU fusions keep some bfloat16 intermediates in float32, so the
jitted encoder lies 7.3e-3 (relative L2) from the un-jitted one, nearly
its whole distance from float32 (8.3e-3), and it is the un-jitted form
that rounds each operation as flax's ``dtype`` says.  Criterion: the
port's bfloat16 features within half of JAX's bfloat16-vs-float32
distance from JAX's bfloat16 features (measured ratio 0.052), and units
equal on at least 95 % of frames.  The tiny config of
``tests/test_torch_hubert.py`` (its pos-conv has 12 channels a group,
where oneDNN's own bfloat16 grouped conv on the CPU sums wrongly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.models import hubert as jhub
from dissc_tpu.train.checkpoints import save_checkpoint
from dissc_tpu_torch.compat.from_jax import hubert_state_dict
from dissc_tpu_torch.models import hubert as thub
from test_torch_hubert import TINY, _wav, random_hubert_params

torch.set_num_threads(2)


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def _port_encoder(params, compute_dtype):
    cfg = thub.HubertConfig(**TINY, compute_dtype=compute_dtype)
    model = thub.HubertEncoder(cfg)
    model.load_hf_state_dict(hubert_state_dict(params, cfg))
    return model.eval()


@pytest.fixture(scope="module")
def runs():
    params = random_hubert_params(jhub.HubertConfig(**TINY))
    wav = _wav(T=3200)
    ref = {dt: np.asarray(jhub.HubertEncoder(jhub.HubertConfig(**TINY, compute_dtype=dt)).apply(
        {"params": params}, jnp.asarray(wav))) for dt in (None, "bfloat16")}
    port = {}
    for dt in (None, "bfloat16"):
        with torch.no_grad():
            port[dt] = _port_encoder(params, dt)(torch.from_numpy(wav))
    codebook = ref[None].reshape(-1, ref[None].shape[-1])[::7][:20] + 0.01
    return dict(params=params, wav=wav, ref=ref, port=port, codebook=codebook)


def test_hubert_bf16_features_track_jax_bf16(runs):
    ref, port = runs["ref"], runs["port"]
    jax_gap = rel(ref["bfloat16"], ref[None])
    assert jax_gap >= 1e-3
    assert rel(port[None].numpy(), ref[None]) < 1e-5
    # measured: 0.052 (port 4.3e-4 from JAX bf16, JAX bf16 8.3e-3 from f32)
    assert rel(port["bfloat16"].numpy(), ref["bfloat16"]) <= 0.5 * jax_gap


def test_hubert_bf16_units_agree_with_jax_bf16(runs):
    codebook = runs["codebook"]
    ref_units = np.asarray(jhub.kmeans_quantize(jnp.asarray(runs["ref"]["bfloat16"]),
                                                jnp.asarray(codebook)))
    units = thub.kmeans_quantize(runs["port"]["bfloat16"], torch.from_numpy(codebook)).numpy()
    assert len(np.unique(ref_units)) > 5  # the codebook is not degenerate
    assert (units == ref_units).mean() >= 0.95


def test_hubert_bf16_output_and_norms_are_float32(runs):
    """Flax's norms have float32 parameters and promote their output to
    float32, so the residual stream after each LayerNorm, and the encoder's
    output, are float32; torch's norms would return bfloat16 on a bfloat16
    input, so the port casts their input first."""
    model = _port_encoder(runs["params"], "bfloat16")
    seen = []

    def hook(module, inputs, output):
        seen.append((type(module).__name__, inputs[0].dtype, output.dtype))

    for m in model.modules():
        if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        out = model(torch.from_numpy(runs["wav"]))
    assert out.dtype == torch.float32
    # group norm, the projection's and the encoder's norms, two a layer
    assert len(seen) == 1 + 2 + 2 * TINY["num_layers"]
    assert {(i, o) for _, i, o in seen} == {(torch.float32, torch.float32)}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert runs["port"]["bfloat16"].dtype == torch.float32


def test_load_encoder_passes_the_bf16_config_through(runs, tmp_path):
    """The JAX loader's files read by ``load_encoder(cfg=HubertConfig(
    compute_dtype="bfloat16"))``: the encoder runs in bfloat16 and its units
    agree with JAX's bfloat16 units on at least 95 % of frames."""
    params, codebook, wav = runs["params"], runs["codebook"], runs["wav"][0]
    save_checkpoint(str(tmp_path / "hubert.pkl"), {"params": params})
    np.save(tmp_path / "km.npy", codebook)
    cfg = thub.HubertConfig(**TINY, compute_dtype="bfloat16")
    enc = thub.load_encoder(str(tmp_path / "hubert.pkl"), str(tmp_path / "km.npy"), cfg,
                            device="cpu")
    assert enc.cfg.dtype == torch.bfloat16
    assert enc.model.feature_extractor.conv_layers[0].dtype == torch.bfloat16
    units = enc.encode_units(wav)
    ref_units = np.asarray(jhub.kmeans_quantize(jnp.asarray(runs["ref"]["bfloat16"][:1]),
                                                jnp.asarray(codebook)))[0]
    assert units.shape == ref_units.shape
    assert (units == ref_units).mean() >= 0.95


@pytest.mark.parametrize("name,dtype", [(None, None), ("float32", None),
                                        ("bfloat16", torch.bfloat16)])
def test_hubert_config_accepts_compute_dtypes(name, dtype):
    assert thub.HubertConfig(**TINY, compute_dtype=name).dtype is dtype


def test_hubert_config_refuses_an_unknown_compute_dtype():
    with pytest.raises(ValueError, match="bfloat16"):
        thub.HubertConfig(compute_dtype="float16")
