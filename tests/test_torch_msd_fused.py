"""Port's fused MSD G step (``dissc_tpu_torch.models.msd_fused``) vs its plain
MSD and vs the JAX package, and the plain MPD/MSD vs JAX's ``disc_s2d``.

The MSD is the reference's (``MSD_SPECS`` at full width, 3 scales) on two
waveforms of 1,000 samples (not a multiple of 4: the pool lengths chain
unevenly).  The fused forward must give the plain module's scores and
feature maps, train mode, and advance the spectral ``u`` as its two calls
do; its gradient for ``y_hat`` and the ``u`` must equal autograd's on the
plain module (f32, 1e-6) and the JAX ``fold_msd_weights`` +
``msd_g_apply`` from the same weights (2e-5).  In bfloat16 the fused
gradient must lie within half of the plain module's own bf16-vs-f32
distance of the plain bf16 gradient (relative L2, the bound of
``test_torch_bf16_vocoder.py``).

One ``GANTrainer`` SGD step at the JAX dry run's ``tiny_gan_config`` with
``msd_fused_gstep`` is held to JAX ``make_gan_train_step`` with the same
flag (parameters 2e-5, losses rtol 1e-4); that JAX step also sets
``disc_s2d``, which the port accepts and ignores, and the port's plain
MPD/MSD of that config are held to the JAX ones built with ``s2d=True``
(every output and the input gradient within 2e-5): the space-to-depth
lowering has the plain form's numbers.  The three JAX programs compile on
threads while the port's side runs.
"""
import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from dissc_tpu.losses import gan as jgan
from dissc_tpu.models.msd_fused import fold_msd_weights as jax_fold
from dissc_tpu.models.msd_fused import msd_g_apply as jax_msd_g_apply
from dissc_tpu.parallel.dryrun import tiny_gan_config as jax_tiny_gan_config
from dissc_tpu.train.vocoder_trainer import make_models as jax_make_models
from dissc_tpu_torch.compat import to_jax
from dissc_tpu_torch.losses.gan import feature_loss, generator_loss
from dissc_tpu_torch.models.discriminators import MultiScaleDiscriminator
from dissc_tpu_torch.models.msd_fused import fold_msd_weights, msd_g_apply
from dissc_tpu_torch.parallel import dryrun
from dissc_tpu_torch.train.vocoder_trainer import make_models
from test_torch_parallel import assert_trees_close

BATCH = 8


def g_loss(out):
    """The G step's MSD terms: LS-GAN adversarial + feature match."""
    _, s_gs, s_fr, s_fg = out
    return generator_loss(s_gs)[0] + feature_loss(s_fr, s_fg)


def jax_g_loss(out):
    _, s_gs, s_fr, s_fg = out
    return jgan.generator_loss(list(s_gs))[0] + jgan.feature_loss(list(s_fr), list(s_fg))


def port_run(msd, y, y_hat, fused, dtype=None):
    """(outputs, the loss's gradient for ``y_hat``, the ``u`` after) of the
    G step's MSD: the plain module (frozen) or the fused stack."""
    x = y_hat.clone().requires_grad_()
    for p in msd.parameters():
        p.requires_grad_(False)
    out = msd_g_apply(fold_msd_weights(msd, True, dtype), y, x) if fused else msd(y, x)
    g_loss(out).backward()
    return out, x.grad, to_jax.msd_trees(msd.state_dict())[1]


def with_dtype(msd, dtype):
    msd = copy.deepcopy(msd)
    for m in msd.modules():
        if hasattr(m, "dtype"):
            m.dtype = dtype
    return msd


def jax_fused(params, spectral, y, y_hat):
    def loss(y_hat):
        weights, new_spectral = jax_fold(params, spectral, train=True)
        out = jax_msd_g_apply(weights, y, y_hat)
        return jax_g_loss(out), (out, new_spectral)

    return jax.value_and_grad(loss, has_aux=True)(y_hat)


def jax_s2d(jh):
    _, mpd, msd = jax_make_models(jh)

    def run(mpd_p, msd_p, spectral, y, y_hat):
        def loss(y_hat):
            p = mpd.apply({"params": mpd_p}, y, y_hat, True)
            s, new = msd.apply({"params": msd_p, "spectral": spectral}, y, y_hat, True,
                               mutable=["spectral"])
            return jax_g_loss(p) + jax_g_loss(s), (p, s, new["spectral"])

        return jax.value_and_grad(loss, has_aux=True)(y_hat)

    return run


@pytest.fixture(scope="module")
def runs():
    """The two JAX programs are traced, then compiled on threads while the
    port's side runs."""
    rng = np.random.default_rng(0)
    y, y_hat = (rng.normal(0, 0.3, (2, 1000)).astype(np.float32) for _ in range(2))
    ty, ty_hat = torch.from_numpy(y), torch.from_numpy(y_hat)
    msd = MultiScaleDiscriminator(3, generator=torch.Generator().manual_seed(1))
    params, spectral = to_jax.msd_trees(msd.state_dict())
    h = dataclasses.replace(dryrun.tiny_gan_config(BATCH), disc_s2d=True)
    jh = dataclasses.replace(jax_tiny_gan_config(BATCH), disc_s2d=True)
    _, mpd_t, msd_t = make_models(h, seed=h.seed)
    mpd_p = to_jax.mpd_tree(mpd_t.state_dict())
    msd_p, spectral_t = to_jax.msd_trees(msd_t.state_dict())

    with ThreadPoolExecutor(2) as pool:
        fused_c = pool.submit(jax.jit(jax_fused).lower(params, spectral, y, y_hat).compile)
        s2d_c = pool.submit(jax.jit(jax_s2d(jh)).lower(mpd_p, msd_p, spectral_t, y,
                                                        y_hat).compile)
        out = {"plain": port_run(copy.deepcopy(msd), ty, ty_hat, False),
               "fused": port_run(copy.deepcopy(msd), ty, ty_hat, True)}
        bf16 = with_dtype(msd, torch.bfloat16)
        out["plain_bf16"] = port_run(copy.deepcopy(bf16), ty, ty_hat, False)
        out["fused_bf16"] = port_run(bf16, ty, ty_hat, True, torch.bfloat16)
        x = ty_hat.clone().requires_grad_()
        s2d_out = (mpd_t(ty, x), msd_t(ty, x))
        (g_loss(s2d_out[0]) + g_loss(s2d_out[1])).backward()
        out["s2d"] = (s2d_out, x.grad, to_jax.msd_trees(msd_t.state_dict())[1])
        (_, (j_out, j_u)), j_grad = fused_c.result()(params, spectral, y, y_hat)
        (_, (jp, js, js_u)), js_grad = s2d_c.result()(mpd_p, msd_p, spectral_t, y, y_hat)
    return dict(port=out, jax_fused=(j_out, j_grad, j_u), jax_s2d=((jp, js), js_grad, js_u))


def flat_maps(out):
    """Scores then feature maps of a discriminator's output, as numpy."""
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = out
    return ([np.asarray(s) for s in (*y_d_rs, *y_d_gs)]
            + [np.asarray(f) for maps in (*fmap_rs, *fmap_gs) for f in maps])


def port_maps(out):
    """The port's outputs in the JAX layout (feature maps channels last)."""
    maps = [t.detach().float().numpy() for t in (*out[0], *out[1])]
    for group in (*out[2], *out[3]):
        for f in group:
            f = f.detach().float().numpy()
            maps.append(np.moveaxis(f, 1, -1))
    return maps


def test_fused_forward_and_spectral_u_equal_the_plain_module(runs):
    (plain, _, u_plain), (fused, _, u_fused) = runs["port"]["plain"], runs["port"]["fused"]
    for a, b in zip(port_maps(fused), port_maps(plain)):
        np.testing.assert_array_equal(a, b)
    assert_trees_close(u_fused, u_plain, 0.0, "spectral u")


def test_fused_waveform_gradient_equals_autograd(runs):
    _, g_plain, _ = runs["port"]["plain"]
    _, g_fused, _ = runs["port"]["fused"]
    assert float(g_plain.abs().max()) > 0
    torch.testing.assert_close(g_fused, g_plain, rtol=0, atol=1e-6)


def test_fused_matches_jax_fold_and_msd_g_apply(runs):
    out, grad, u = runs["port"]["fused"]
    j_out, j_grad, j_u = runs["jax_fused"]
    for a, b in zip(port_maps(out), flat_maps(j_out)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=0, atol=2e-5)
    assert_trees_close(u, j_u, 2e-5, "spectral u")


def rel(a, b):
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_fused_bf16_tracks_the_plain_bf16_module(runs):
    """Within half of the plain module's bf16-vs-f32 distance (the bound of
    ``test_torch_bf16_vocoder.py``)."""
    port = runs["port"]
    f32, b16, fused = port["plain"][1], port["plain_bf16"][1], port["fused_bf16"][1]
    gap = rel(b16.numpy(), f32.numpy())
    assert 0 < gap and rel(fused.numpy(), b16.numpy()) <= 0.5 * gap
    for a, b in zip(port_maps(port["fused_bf16"][0]), port_maps(port["plain_bf16"][0])):
        np.testing.assert_array_equal(a, b)
    assert port["fused_bf16"][0][3][0][0].dtype == torch.bfloat16
    assert_trees_close(port["fused_bf16"][2], port["plain_bf16"][2], 0.0, "bf16 spectral u")


def test_plain_discriminators_match_jax_s2d(runs):
    (mpd_out, msd_out), grad, u = runs["port"]["s2d"]
    (jp, js), j_grad, j_u = runs["jax_s2d"]
    for a, b in zip(port_maps(mpd_out)[:4], flat_maps(jp)[:4]):  # the MPD's scores
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    for maps, ref in zip((*mpd_out[2], *mpd_out[3]), (*jp[2], *jp[3])):  # NCHW vs NHWC
        for a, b in zip(maps, ref):
            np.testing.assert_allclose(a.detach().numpy().transpose(0, 2, 3, 1),
                                       np.asarray(b), rtol=0, atol=2e-5)
    for a, b in zip(port_maps(msd_out), flat_maps(js)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=0, atol=2e-5)
    assert_trees_close(u, j_u, 2e-5, "spectral u")
