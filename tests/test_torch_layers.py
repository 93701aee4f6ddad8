"""Port's conv layers vs ``dissc_tpu.models.layers`` on the same weights.

Weights come from the flax init and are transposed by hand here (not
through ``compat.from_jax``), so a layout slip in either shows up.
Tolerance 1e-5: f32 convolutions summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.models import layers as jl
from dissc_tpu_torch.models import layers as tl

torch.set_num_threads(2)
ATOL = 1e-5


def _t(a, *perm):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.transpose(perm) if perm else a, order="C"))


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
def test_weight_norm_conv1d(k, dilation):
    x = _x(k, (2, 40, 6))  # NWC
    m = jl.Conv1d(5, k, dilation=dilation, norm="weight", kernel_init=jl.hifigan_init(0.3))
    p = m.init(jax.random.key(k), jnp.asarray(x))["params"]
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    c = tl.Conv1d(6, 5, k, dilation=dilation, norm="weight")
    c.load_state_dict({"weight_v": _t(p["v"], 2, 1, 0),
                       "weight_g": _t(p["g"]).reshape(-1, 1, 1), "bias": _t(p["bias"])})
    out = c(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("k,u", [(11, 5), (8, 4), (4, 2)])
def test_weight_norm_conv_transpose1d_upsampler_shapes(k, u):
    """Every HiFi-GAN upsampler shape; g is per input channel."""
    x = _x(u, (2, 9, 12))
    m = jl.ConvTranspose1d(6, k, stride=u, padding=(k - u) // 2, norm="weight",
                           kernel_init=jl.hifigan_init(0.3))
    p = m.init(jax.random.key(u), jnp.asarray(x))["params"]
    assert p["g"].shape == (1, 1, 12)
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    c = tl.ConvTranspose1d(12, 6, k, u, padding=(k - u) // 2, norm="weight")
    c.load_state_dict({"weight_v": _t(p["v"], 2, 1, 0),
                       "weight_g": _t(p["g"]).reshape(-1, 1, 1), "bias": _t(p["bias"])})
    out = c(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert out.shape == ref.shape == (2, 9 * u, 6)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)


def test_spectral_conv1d_train_twice_then_eval():
    """u advances once per call in train mode; eval divides by the current
    sigma without advancing.  Grouped, strided, like the MSD's convs."""
    x = _x(3, (2, 64, 8))
    m = jl.Conv1d(16, 41 // 4, stride=2, groups=4, padding=2, norm="spectral")
    variables = m.init(jax.random.key(3), jnp.asarray(x))
    p, spec = variables["params"], variables["spectral"]
    c = tl.Conv1d(8, 16, 41 // 4, stride=2, groups=4, padding=2, norm="spectral")
    c.load_state_dict({"weight_orig": _t(p["kernel"], 2, 1, 0), "bias": _t(p["bias"]),
                       "weight_u": _t(spec["u"])})
    c.train()
    xt = torch.from_numpy(x).transpose(1, 2)
    for _ in range(2):
        ref, upd = m.apply({"params": p, "spectral": spec}, jnp.asarray(x), True,
                           mutable=["spectral"])
        spec = upd["spectral"]
        out = c(xt).transpose(1, 2)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(c.weight_u.numpy(), np.asarray(spec["u"]), atol=1e-6)
    c.eval()
    u_before = c.weight_u.clone()
    ref = m.apply({"params": p, "spectral": spec}, jnp.asarray(x), False)
    np.testing.assert_allclose(c(xt).transpose(1, 2).detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    assert torch.equal(c.weight_u, u_before)


def test_mpd_conv2d_k_by_1():
    """The MPD's (5, 1) strided weight-norm Conv2d on a period fold."""
    x = _x(4, (2, 30, 3, 4))  # NHWC: [B, T/p, p, C]
    m = jl.Conv2d(7, (5, 1), strides=(3, 1), padding=(2, 0), norm="weight")
    p = m.init(jax.random.key(4), jnp.asarray(x))["params"]
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    c = tl.Conv2d(4, 7, (5, 1), (3, 1), (2, 0), norm="weight")
    c.load_state_dict({"weight_v": _t(p["v"], 3, 2, 0, 1),
                       "weight_g": _t(p["g"]).reshape(-1, 1, 1, 1), "bias": _t(p["bias"])})
    out = c(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)


def test_fold_weight_norm_matches_jax_fold():
    x = _x(5, (2, 9, 12))
    m = jl.ConvTranspose1d(6, 8, stride=4, padding=2, norm="weight")
    p = m.init(jax.random.key(5), jnp.asarray(x))["params"]
    folded = jl.fold_weight_norm({"up": p})["up"]["kernel"]
    sd = {"up.weight_v": _t(p["v"], 2, 1, 0), "up.weight_g": _t(p["g"]).reshape(-1, 1, 1),
          "up.bias": _t(p["bias"])}
    out = tl.fold_weight_norm(sd)
    assert set(out) == {"up.weight", "up.bias"}
    np.testing.assert_allclose(out["up.weight"].numpy(),
                               np.asarray(folded).transpose(2, 1, 0), atol=1e-7)
    # the folded conv equals the weight-normed one
    c = tl.ConvTranspose1d(12, 6, 8, 4, padding=2, norm="weight")
    c.load_state_dict({k[3:]: v for k, v in sd.items()})
    f = tl.ConvTranspose1d(12, 6, 8, 4, padding=2, norm=None)
    f.load_state_dict({k[3:]: v for k, v in out.items()})
    xt = torch.from_numpy(x).transpose(1, 2)
    torch.testing.assert_close(f(xt), c(xt), atol=1e-7, rtol=0)
