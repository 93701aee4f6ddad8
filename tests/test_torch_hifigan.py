"""Port's CodeGenerator vs JAX ``CodeGenerator.apply`` on the same weights.

Small width (``upsample_initial_channel=32``), full rates and MRF, with
multi-speaker conditioning and f0 at the code rate (r=1) and at twice it
(r=2).  Weights: numpy draws into the flax parameter shapes, carried by
``compat.from_jax``.  Tolerance: waveform max-abs < 1e-4 (f32 convs in
another summation order through ~20 layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.models.hifigan import CodeGenerator as JaxCodeGenerator
from dissc_tpu_torch.compat.from_jax import generator_state_dict
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.models.hifigan import CodeGenerator
from dissc_tpu_torch.models.layers import fold_weight_norm

torch.set_num_threads(2)
SMALL = dict(upsample_initial_channel=32, embedding_dim=8, model_in_dim=17)


def random_generator_params(h, seed=0):
    """Seeded numpy weights in the flax CodeGenerator's parameter shapes
    (``eval_shape`` only: no flax init is compiled)."""
    shapes = jax.eval_shape(JaxCodeGenerator(h).init, jax.random.key(0),
                            jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 4, 1)),
                            jnp.zeros((1, 1), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        scale = {"embedding": 1.0, "g": 0.5, "bias": 0.05}.get(name, 0.1)
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs(r, T=6, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 100, (2, T)).astype(np.int32),
            rng.normal(0, 1, (2, T * r, 1)).astype(np.float32),
            np.array([[3], [150]], np.int32))


@pytest.mark.parametrize("r,resblock", [(1, "1"), (2, "1"), (1, "2")])
def test_code_generator_matches_jax(r, resblock):
    jh, th = JaxConfig(**SMALL, resblock=resblock), VocoderConfig(**SMALL, resblock=resblock)
    params = random_generator_params(jh)
    code, f0, spkr = _inputs(r)
    ref = np.asarray(jax.jit(JaxCodeGenerator(jh).apply)(
        {"params": params}, jnp.asarray(code), jnp.asarray(f0), jnp.asarray(spkr)))
    model = CodeGenerator(th)
    model.load_state_dict(generator_state_dict(params, th))
    with torch.no_grad():
        out = model(torch.from_numpy(code).long(), torch.from_numpy(f0),
                    torch.from_numpy(spkr).long()).numpy()
    assert out.shape == ref.shape == (2, 6 * r * 320)
    assert np.abs(ref).max() > 1e-2  # the comparison is not of near-zeros
    assert np.abs(out - ref).max() < 1e-4


def test_folded_generator_equals_unfolded():
    th = VocoderConfig(**SMALL)
    model = CodeGenerator(th, generator=torch.Generator().manual_seed(0))
    folded = CodeGenerator(VocoderConfig(**SMALL, folded_weights=True))
    folded.load_state_dict(fold_weight_norm(model.state_dict()))
    assert not any(k.endswith("weight_v") for k in folded.state_dict())
    code, f0, spkr = (torch.from_numpy(a) for a in _inputs(1))
    with torch.no_grad():
        a = model(code.long(), f0, spkr.long())
        b = folded(code.long(), f0, spkr.long())
    torch.testing.assert_close(b, a, atol=1e-6, rtol=0)


def test_jax_folded_tree_loads_into_folded_generator():
    """A tree folded by the JAX package (``kernel`` leaves) carries into a
    port generator built with ``folded_weights`` and equals the port's own
    fold of the unfolded tree."""
    from dissc_tpu.models.layers import fold_weight_norm as jax_fold

    params = random_generator_params(JaxConfig(**SMALL), seed=6)
    th = VocoderConfig(**SMALL)
    folded_h = VocoderConfig(**SMALL, folded_weights=True)
    from_jax_fold = CodeGenerator(folded_h)
    from_jax_fold.load_state_dict(generator_state_dict(jax.device_get(jax_fold(params)), th))
    port_fold = CodeGenerator(folded_h)
    port_fold.load_state_dict(fold_weight_norm(generator_state_dict(params, th)))
    code, f0, spkr = (torch.from_numpy(a) for a in _inputs(1))
    with torch.no_grad():
        a = from_jax_fold(code.long(), f0, spkr.long())
        b = port_fold(code.long(), f0, spkr.long())
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_state_dict_keys_follow_reference_layout():
    sd = CodeGenerator(VocoderConfig(**SMALL)).state_dict()
    for key in ("conv_pre.weight_v", "conv_pre.weight_g", "ups.0.weight_v",
                "resblocks.14.convs1.2.weight_g", "resblocks.0.convs2.0.bias",
                "conv_post.bias", "dict.weight", "spkr.weight"):
        assert key in sd, key
    assert sd["ups.0.weight_g"].shape == (32, 1, 1)  # per input channel
