"""The port's bfloat16 vocoder paths vs the JAX package's, same weights.

``compute_dtype`` / ``disc_compute_dtype`` = ``"bfloat16"`` is flax's mixed
precision: float32 parameters, each conv run in bfloat16, its output kept
in bfloat16, the generator's head in float32.  Two bfloat16
implementations cannot agree bit for bit (the convs sum in another
order, so a few outputs round the other way), so the criterion is
relative: the port's bfloat16 output must lie within half of JAX's own
bfloat16-vs-float32 distance from JAX's bfloat16 output (relative L2).

Weights: numpy draws with the JAX init's distributions (HiFi-GAN convs
``v ~ N(0, 0.01)``, other convs and every bias ``U(+-1/sqrt(fan_in))``,
embeddings ``N(0, 1)``), the weight-norm gains ``g`` set to 5 times
``||v||``: at 1 times the generator's bfloat16 and float32 outputs differ
by about 1e-4 relative, too little to tell a misplaced cast from a right
one.  At 5 times, ``VocoderConfig(upsample_initial_channel=64,
embedding_dim=16, model_in_dim=33)`` on 2 x 32 frames, seeds 0-3 gave
ratios of 0.095, 0.043, 0.164 and 0.082 (JAX distances 3.9e-4 to
1.1e-2); seed 3 is used (distance 2.3e-3, output rms 0.11, no
saturation; seed 1's output is near silent, rms 0.008).  With every bias at zero the activations' rounding flips
cascade through the MRF stacks: the ratio then reads 0.6-1.0 for any
reordering of the sums, so those weights cannot tell the two apart.

The GAN step in bfloat16 is held to the port's own float32 step (a JAX
GAN step would take a minute to compile on the CPU), with the band of
``tests/test_vocoder_pipeline.py::test_gan_step_bf16_discriminators_track_f32``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.models.discriminators import (MultiPeriodDiscriminator as JaxMPD,
                                             MultiScaleDiscriminator as JaxMSD)
from dissc_tpu.models.hifigan import CodeGenerator as JaxCodeGenerator
from dissc_tpu.train.checkpoints import save_checkpoint
from dissc_tpu_torch.audio.mel import mel_spectrogram
from dissc_tpu_torch.compat.from_jax import (generator_state_dict, mpd_state_dict,
                                             msd_state_dict)
from dissc_tpu_torch.core.config import VocoderConfig, resolve_dtype
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                   MultiScaleDiscriminator)
from dissc_tpu_torch.models.hifigan import CodeGenerator
from dissc_tpu_torch.models.layers import Conv1d, ConvTranspose1d
from dissc_tpu_torch.parallel.dryrun import tiny_gan_config
from dissc_tpu_torch.train.vocoder_trainer import GANTrainer, make_models

torch.set_num_threads(2)
WIDE = dict(upsample_initial_channel=64, embedding_dim=16, model_in_dim=33)
GAIN, SEED, FRAMES = 5.0, 3, 32
DISC = dict(mpd_periods=(2, 3), msd_scales=2)
BF16 = dict(compute_dtype="bfloat16", disc_compute_dtype="bfloat16")


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def jax_init_like(shapes, seed, gain=GAIN, hifigan=False):
    """Numpy draws with the JAX init's distributions into a flax tree's
    shapes, each weight-norm gain ``gain * ||v||``; ``hifigan``: the
    generator's convs after ``conv_pre`` draw ``N(0, 0.01)``."""
    rng = np.random.default_rng(seed)
    uniform = lambda shape, fan_in: rng.uniform(-1, 1, shape) / np.sqrt(fan_in)

    def fill(name, node):
        if "embedding" in node:
            return {"embedding": rng.standard_normal(node["embedding"].shape)}
        if "v" not in node and "kernel" not in node:
            return {k: fill(k, sub) for k, sub in node.items()}
        w = node.get("v", node.get("kernel")).shape
        # (k, out, in) for a transposed conv, else (k..., in, out)
        fan_in = w[0] * w[2] if name.startswith("ups_") else int(np.prod(w[:-1]))
        v = (rng.standard_normal(w) * 0.01 if hifigan and name != "conv_pre"
             else uniform(w, fan_in))
        if "kernel" in node:
            return {"kernel": v, "bias": uniform(node["bias"].shape, fan_in)}
        g = gain * np.sqrt((v ** 2).sum(axis=tuple(range(v.ndim - 1))))
        return {"v": v, "g": g.reshape(node["g"].shape),
                "bias": uniform(node["bias"].shape, fan_in)}

    tree = {k: fill(k, sub) for k, sub in shapes.items()}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _inputs(frames=FRAMES, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 100, (2, frames)).astype(np.int32),
            rng.normal(0, 1, (2, frames, 1)).astype(np.float32),
            np.array([[3], [50]], np.int32))


def _torch_inputs(code, f0, spkr):
    return torch.from_numpy(code).long(), torch.from_numpy(f0), torch.from_numpy(spkr).long()


def _generator_pair(params):
    """The port's float32 and bfloat16 generators on ``params``."""
    out = []
    for dt in ("float32", "bfloat16"):
        th = VocoderConfig(**WIDE, compute_dtype=dt)
        model = CodeGenerator(th)
        model.load_state_dict(generator_state_dict(params, th))
        out.append(model)
    return out


@pytest.fixture(scope="module")
def generator_runs():
    jh = JaxConfig(**WIDE)
    shapes = jax.eval_shape(JaxCodeGenerator(jh).init, jax.random.key(0),
                            jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 4, 1)),
                            jnp.zeros((1, 1), jnp.int32))["params"]
    params = jax_init_like(shapes, SEED, hifigan=True)
    code, f0, spkr = _inputs()
    ref = {dt: np.asarray(jax.jit(JaxCodeGenerator(JaxConfig(**WIDE, compute_dtype=dt)).apply)(
        {"params": params}, code, f0, spkr)) for dt in ("float32", "bfloat16")}
    with torch.no_grad():
        port = {dt: m(*_torch_inputs(code, f0, spkr))
                for dt, m in zip(("float32", "bfloat16"), _generator_pair(params))}
    return dict(params=params, ref=ref, port=port)


def test_generator_bf16_tracks_jax_bf16(generator_runs):
    ref, port = generator_runs["ref"], generator_runs["port"]
    jax_gap = rel(ref["bfloat16"], ref["float32"])
    assert jax_gap >= 1e-3  # the weights tell bfloat16 from float32
    assert rel(port["float32"].numpy(), ref["float32"]) < 1e-5
    # measured: 0.082 (port 1.9e-4 from JAX bf16, JAX bf16 2.3e-3 from f32)
    assert rel(port["bfloat16"].numpy(), ref["bfloat16"]) <= 0.5 * jax_gap
    y = ref["float32"]
    assert np.sqrt(np.mean(y ** 2)) > 0.05 and np.abs(y).max() < 0.9  # a signal, unsaturated


def test_generator_bf16_waveform_is_float32_and_its_convs_bfloat16(generator_runs):
    """The f32 head (``dissc_tpu/models/hifigan.py:219-225``): every conv
    before ``conv_post`` returns bfloat16, ``conv_post`` and the waveform
    float32, and every parameter stays float32."""
    model = _generator_pair(generator_runs["params"])[1]
    seen = {}

    def record(name):
        def hook(module, inputs, output):
            seen[name] = (inputs[0].dtype, output.dtype)
        return hook

    for name, m in model.named_modules():
        if isinstance(m, (Conv1d, ConvTranspose1d)):
            m.register_forward_hook(record(name))
    with torch.no_grad():
        y = model(*_torch_inputs(*_inputs()))
    assert y.dtype == torch.float32
    assert seen.pop("conv_post") == (torch.float32, torch.float32)
    assert seen["conv_pre"] == (torch.float32, torch.bfloat16)  # the conditioning is cast
    assert len(seen) == 1 + 5 + 5 * 3 * 3 * 2
    assert {out for _, out in seen.values()} == {torch.bfloat16}
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_generator_bf16_mel_distance_small(generator_runs):
    """``tests/test_bf16.py`` on the port alone: its shape (1 x 16 frames),
    weights at the JAX init's gains (at 5 times the near-silent bands of
    the log-mel move by more)."""
    jh = JaxConfig(**WIDE)
    shapes = jax.eval_shape(JaxCodeGenerator(jh).init, jax.random.key(0),
                            jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 4, 1)),
                            jnp.zeros((1, 1), jnp.int32))["params"]
    params = jax_init_like(shapes, 0, gain=1.0, hifigan=True)
    code, f0, _ = _inputs(frames=16)
    inputs = _torch_inputs(code[:1], f0[:1], np.zeros((1, 1), np.int32))
    with torch.no_grad():
        y32, y16 = (m(*inputs) for m in _generator_pair(params))
    assert y16.dtype == torch.float32
    mel32, mel16 = mel_spectrogram(y32), mel_spectrogram(y16)
    assert float((mel32 - mel16).abs().mean()) < 0.05
    assert float((y32 - y16).abs().max()) < 0.05


def _disc_outputs(outs, layout):
    """Scores and feature maps of ``(y_d_rs, y_d_gs, fmap_rs, fmap_gs)`` as
    float32 numpy arrays in the port's layout (NCHW / NCW)."""
    as_np = (lambda a: np.asarray(a, np.float32)) if layout == "jax" else (
        lambda t: t.float().numpy())
    scores = [as_np(s) for s in outs[0] + outs[1]]
    fmaps = [as_np(f) for f in sum(outs[2] + outs[3], [])]
    if layout == "jax":
        fmaps = [f.transpose(0, 3, 1, 2) if f.ndim == 4 else f.transpose(0, 2, 1)
                 for f in fmaps]
    return scores, fmaps


@pytest.fixture(scope="module")
def disc_runs():
    """MPD (periods 2, 3) and MSD (2 scales) at the JAX init's distributions
    (gains 1) on a tone with noise and on noise, 2 x 2560 samples."""
    rng = np.random.default_rng(4)
    t = np.arange(2560) / 16000
    y = (0.4 * np.sin(2 * np.pi * 220 * t)[None] + 0.1 * rng.standard_normal((2, 2560))
         ).astype(np.float32)
    y_hat = (0.3 * rng.standard_normal((2, 2560))).astype(np.float32)
    out = {}
    for kind, jcls, tcls in (("mpd", JaxMPD, MultiPeriodDiscriminator),
                             ("msd", JaxMSD, MultiScaleDiscriminator)):
        kw = {"periods": DISC["mpd_periods"]} if kind == "mpd" else {"scales": DISC["msd_scales"]}
        shapes = jax.eval_shape(jcls(**kw).init, jax.random.key(0), y, y)
        variables = {"params": jax_init_like(shapes["params"], seed=6, gain=1.0)}
        if kind == "msd":
            variables["spectral"] = jax.tree.map(
                lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes["spectral"])
        raw = {dt: jax.jit(jcls(**kw, dtype=jnp_dtype(dt)).apply)(variables, y, y_hat)
               for dt in ("float32", "bfloat16")}
        models, port = {}, {}
        for dt in ("float32", "bfloat16"):
            model = tcls(*kw.values(), dtype=resolve_dtype(dt)).eval()
            params = variables["params"]
            model.load_state_dict(mpd_state_dict(params) if kind == "mpd" else
                                  msd_state_dict(params, variables["spectral"]))
            with torch.no_grad():
                port[dt] = model(torch.from_numpy(y), torch.from_numpy(y_hat))
            models[dt] = model
        out[kind] = dict(ref={dt: _disc_outputs(r, "jax") for dt, r in raw.items()}, port=port,
                         raw=raw, variables=variables, models=models)
    return out


def jnp_dtype(name):
    return None if name == "float32" else jnp.bfloat16


@pytest.mark.parametrize("kind", ["mpd", "msd"])
def test_discriminators_bf16_track_jax_bf16(disc_runs, kind):
    """Every score and feature map of the discriminator, as one vector.
    Measured ratio: MPD 0.017, MSD 0.011.  By tensor the ratio grows with
    depth (0 at the first conv, 0.02-0.2 in the middle, 0.4-0.5 at the last
    1024-channel map) and reads up to 1.0 on the 21 logits of the pooled
    MSD scale: the 1,024 x 3 product of the last layer sums the few
    roundings that came out the other way in the layers before it; fed
    JAX's own bfloat16 input, that layer agrees
    (``test_msd_logits_bf16_from_jax_bf16_features``)."""
    ref, port = disc_runs[kind]["ref"], disc_runs[kind]["port"]
    flat = lambda outs: np.concatenate([a.ravel() for a in outs[0] + outs[1]])
    j32, j16 = flat(ref["float32"]), flat(ref["bfloat16"])
    p32 = flat(_disc_outputs(port["float32"], "port"))
    p16 = flat(_disc_outputs(port["bfloat16"], "port"))
    jax_gap = rel(j16, j32)
    assert jax_gap >= 1e-3
    assert rel(p32, j32) < 1e-5
    assert rel(p16, j16) <= 0.5 * jax_gap, (kind, rel(p16, j16) / jax_gap)


def test_msd_logits_bf16_from_jax_bf16_features(disc_runs):
    """The pooled MSD scale's ``conv_post`` on JAX's bfloat16 input (its
    last feature map of the real waveform): the logits within half of
    JAX's bfloat16-vs-float32 distance of that layer (measured 0.0)."""
    from dissc_tpu.models.layers import Conv1d as JaxConv1d

    run = disc_runs["msd"]
    x = run["raw"]["bfloat16"][2][1][-2]  # [B, T, 1024] bfloat16, the input of conv_post
    p = {"params": run["variables"]["params"]["disc_1"]["conv_post"]}
    ref = {dt: np.asarray(JaxConv1d(1, 3, padding=1, norm="weight", dtype=jnp_dtype(dt)).apply(
        p, x.astype(jnp.float32)), np.float32) for dt in ("float32", "bfloat16")}
    xt = torch.from_numpy(np.asarray(x, np.float32)).transpose(1, 2).bfloat16()
    with torch.no_grad():
        out = run["models"]["bfloat16"].discriminators[1].conv_post(xt)
    assert out.dtype == torch.bfloat16
    out = out.float().transpose(1, 2).numpy()
    jax_gap = rel(ref["bfloat16"], ref["float32"])
    assert jax_gap >= 1e-3
    assert rel(out, ref["bfloat16"]) <= 0.5 * jax_gap


@pytest.mark.parametrize("kind", ["mpd", "msd"])
def test_discriminator_bf16_outputs_are_bfloat16(disc_runs, kind):
    """Scores and feature maps leave a bfloat16 discriminator in bfloat16
    (the losses cast them to float32 before they reduce)."""
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = disc_runs[kind]["port"]["bfloat16"]
    assert {t.dtype for t in y_d_rs + y_d_gs + sum(fmap_rs + fmap_gs, [])} == {torch.bfloat16}


@pytest.fixture(scope="module")
def gan_steps():
    """One GAN step of ``GANTrainer`` at the dry run's ``tiny_gan_config``,
    in float32 and with both compute dtypes bfloat16, from one init and
    one batch."""
    rng = np.random.default_rng(8)
    h = tiny_gan_config(batch_size=4)
    frames = h.segment_size // h.code_hop_size
    batch = {"code": torch.from_numpy(rng.integers(0, 100, (4, frames))).long(),
             "f0": torch.from_numpy(rng.normal(0, 1, (4, frames, 1)).astype(np.float32)),
             "spkr": torch.from_numpy(rng.integers(0, 4, (4, 1))).long(),
             "audio": torch.from_numpy((rng.standard_normal((4, h.segment_size)) * 0.3
                                        ).astype(np.float32))}
    out = {}
    for name, kw in (("float32", {}), ("bfloat16", BF16)):
        trainer = GANTrainer(VocoderConfig(**{**h.to_dict(), **kw}), device="cpu", seed=11)
        losses = {k: float(v) for k, v in trainer.train_step(batch).items()}
        out[name] = dict(losses=losses, trainer=trainer)
    return out


@pytest.mark.parametrize("name", ["loss_disc", "loss_gen_total", "loss_mel", "loss_fm",
                                  "loss_adv"])
def test_gan_step_bf16_losses_track_its_f32_step(gan_steps, name):
    a, b = (gan_steps[dt]["losses"][name] for dt in ("float32", "bfloat16"))
    assert np.isfinite(b)
    assert abs(a - b) <= 0.05 * abs(a) + 0.05, (name, a, b)
    assert a != b  # the bfloat16 step did run in bfloat16


def test_gan_step_bf16_keeps_float32_master_params(gan_steps):
    trainer = gan_steps["bfloat16"]["trainer"]
    for module in (trainer.gen, trainer.mpd, trainer.msd):
        assert {p.dtype for p in module.parameters()} == {torch.float32}
    for opt in (trainer.opt_g, trainer.opt_d):
        dtypes = {t.dtype for s in opt.state.values() for t in s.values() if t.dim()}
        assert dtypes == {torch.float32}
    assert trainer.mpd.discriminators[0].convs[0].dtype == torch.bfloat16
    assert trainer.gen.conv_pre.dtype == torch.bfloat16


@pytest.mark.parametrize("knob", ["compute_dtype", "disc_compute_dtype", "param_dtype"])
def test_config_accepts_bf16_knobs_and_params_stay_float32(knob):
    """The JAX package reads ``param_dtype`` nowhere, so neither does the
    port: parameters stay float32 whatever it says."""
    h = VocoderConfig(**tiny_gan_config(2).to_dict() | {knob: "bfloat16"})
    gen, mpd, msd = make_models(h, seed=0)
    for module in (gen, mpd, msd):
        assert {p.dtype for p in module.parameters()} == {torch.float32}
    assert gen.conv_pre.dtype == (torch.bfloat16 if knob == "compute_dtype" else None)
    assert msd.discriminators[1].convs[2].dtype == (
        torch.bfloat16 if knob == "disc_compute_dtype" else None)


@pytest.mark.parametrize("name,dtype", [(None, None), ("float32", None), ("f32", None),
                                        ("bfloat16", torch.bfloat16)])
def test_resolve_dtype_names(name, dtype):
    assert resolve_dtype(name) is dtype


def test_an_unknown_compute_dtype_is_refused():
    with pytest.raises(ValueError, match="bfloat16"):
        VocoderConfig(compute_dtype="float16")


def test_engine_follows_config_json_compute_dtype(generator_runs, tmp_path):
    """A ``config.json`` with ``compute_dtype`` bfloat16 and a JAX-written
    ``g_``: the engine folds the weight norm in float32, then runs the
    bfloat16 generator: its float32 waveforms equal the unfolded bfloat16
    generator's."""
    params = generator_runs["params"]
    save_checkpoint(str(tmp_path / "g_00000001"), {"generator": params})
    with open(tmp_path / "config.json", "w") as f:
        json.dump({**WIDE, "compute_dtype": "bfloat16"}, f)
    engine = VocoderEngine.from_checkpoint(str(tmp_path), exact_lengths=True, device="cpu")
    assert engine.h.compute_dtype == "bfloat16" and engine.h.folded_weights
    assert {p.dtype for p in engine.model.parameters()} == {torch.float32}
    code, f0, spkr = _inputs()
    items = [{"code": code[i], "f0": f0[i], "spkr": spkr[i]} for i in range(2)]
    out, _ = engine.synthesize_utterances(items, batch_size=2)
    assert all(w.dtype == np.float32 for w in out)
    want = generator_runs["port"]["bfloat16"].numpy()
    assert np.abs(np.stack(out) - want).max() < 1e-6
    assert np.abs(np.stack(out) - generator_runs["port"]["float32"].numpy()).max() > 1e-5
