"""Run the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, at the full width of ``VocoderConfig()`` (the reference
``hubert100_lut.json``: 512 initial channels, rates 5*4*4*2*2, MRF
(3, 7, 11) x (1, 3, 5), 8960-sample segments at batch 64) and of
HuBERT-base, with weights drawn from a fixed seed:

1. set-up: the card's name and power limit, TF32 off for cuBLAS and
   cuDNN, and the build of every CUDA kernel from ``dissc_tpu_torch/csrc``;
2. kernels: each kernel against its plain PyTorch version on the card
   (forward and gradient, stated tolerances) and timed beside it and beside
   a cuFFT chain, at the main path's shapes, at the mel widths of the JAX
   package's multi-chip dry run (n_fft 32) and at n_fft 4096, 1000 and
   4095, on noise and on a tone with stretches of silence;
3. train: two steps of a small config held against the CPU path, at the
   default and at the dry run's mel widths, then GAN train steps and one
   validation step through ``GANTrainer`` at full width, with the launch
   counters set to 0 just before and read just after;
4. serve: ``VocoderEngine`` built from the trained generator answers
   requests across the frame buckets plus one that streams, checked
   against exact-length and monolithic forwards and against the CPU;
5. convert, the conversion path, wav in and wav out, with the launch
   counters set to 0 just before and read just after (it launches no
   kernel of the port): (a) ``bench.py``'s shape, 8 utterances of 10.24 s,
   through ``SpeechUnitEncoder`` (HuBERT-base, layer 6, k-means over 100
   units), ``ProsodyConverter`` (rhythm + "new" pitch, 107 speakers,
   bucket 512) and ``VocoderEngine``, timed by stage; (b) one
   ``ConversionPipeline.convert`` call on 10 s at 22.05 kHz with voiced
   stretches at known f0 (YAAPT must find each within 5 %); (c) the card
   against the port's CPU path on small inputs (HuBERT, prosody, YAAPT,
   ``convert_record``).

It exits non-zero on any failure and without a card.  The line before
the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dissc_tpu_torch.audio import yaapt
from dissc_tpu_torch.audio.mel import hann_window, mel_filterbank, mel_spectrogram
from dissc_tpu_torch.audio.probes import STRETCHES, tone_and_silence, voiced_stretches
from dissc_tpu_torch.audio.resample import resample_poly_np
from dissc_tpu_torch.core import seqops
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.infer.prosody import ProsodyConverter
from dissc_tpu_torch.infer.streaming import receptive_field_frames
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.kernels import mel_kernel
from dissc_tpu_torch.models.hubert import HubertConfig, SpeechUnitEncoder, init_state_dict
from dissc_tpu_torch.models.prosody import LenPredictor
from dissc_tpu_torch.pipeline import ConversionPipeline
from dissc_tpu_torch.train.prosody_trainer import build_pitch_model
from dissc_tpu_torch.train.vocoder_trainer import GANTrainer

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync_time_ms(fn, n: int = 20) -> float:
    """Mean time of one call of ``fn`` over ``n`` calls (CUDA events, after
    3 warm-up calls); it counts the host's time to issue each call where
    that exceeds the device's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def own_kernel_us(fn, match: str = "log_mel_fft_kernel", n: int = 20) -> list:
    """The device time of each launch of the kernel named ``match`` over
    ``n`` calls of ``fn`` (``torch.profiler``'s kernel durations, after 3
    warm-up calls): the kernel alone, without the host's time to launch it.

    CUPTI may drop an activity record (one H100 run kept 19 of 20), so the
    list holds the records it kept: at least half of ``n``, and never more
    than ``n`` (more would mean ``match`` names another kernel too)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.duration_ns() / 1e3 for e in prof.profiler.kineto_results.events()
          if match in e.name()]
    if not n // 2 <= len(us) <= n or min(us) <= 0:
        raise RuntimeError(f"the profiler kept {len(us)} records of {n} {match} launches")
    return us


def mel_bound_ms(b: int, t: int, h: VocoderConfig):
    """Least time for one log-mel of ``[b, t]`` and what sets it, the larger
    of two: the operations the function needs at the fp32 peak, per frame a
    windowed real FFT (n_fft multiplies + 2.5 n_fft log2 n_fft), the
    magnitudes (4 per bin), the mel projection over the filters' non-zero
    weights only (2 each) and the log (1 per mel); or the bytes, the
    waveform read once, the log-mel written once and the window and the
    non-zero mel weights read once."""
    freq = h.n_fft // 2 + 1
    frames = b * (1 + (t + 2 * ((h.n_fft - h.hop_size) // 2) - h.n_fft) // h.hop_size)
    mel_nnz = int(np.count_nonzero(mel_filterbank(h.sampling_rate, h.n_fft, h.num_mels,
                                                  float(h.fmin), h.fmax_for_loss)))
    per_frame = (h.n_fft + 2.5 * h.n_fft * np.log2(h.n_fft) + 4 * freq + 2 * mel_nnz
                 + h.num_mels)
    nbytes = 4.0 * (b * t + frames * h.num_mels + h.win_size + mel_nnz)
    t_ops, t_bytes = frames * per_frame / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * float(max(t_ops, t_bytes)), ("operations" if t_ops >= t_bytes else "bytes")


def cufft_chain(h: VocoderConfig, dev: torch.device):
    """The log-mel through cuFFT, a function of ``y``, timed as a yardstick
    only (the port never calls it): reflect-pad, ``torch.stft(center=False)``,
    sqrt(|.|^2 + 1e-9), the mel product and the log.  Its window and mel
    basis go to the card here, once: a copy from host memory in the timed
    call would wait for the card."""
    pad = (h.n_fft - h.hop_size) // 2
    window = torch.from_numpy(hann_window(h.win_size, h.n_fft)).to(dev)
    mel = torch.from_numpy(mel_filterbank(h.sampling_rate, h.n_fft, h.num_mels, float(h.fmin),
                                          h.fmax_for_loss)).to(dev)

    def chain(y: torch.Tensor) -> torch.Tensor:
        yp = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        spec = torch.view_as_real(torch.stft(yp, h.n_fft, h.hop_size, window=window,
                                             center=False, return_complex=True))
        mag = torch.sqrt(spec.square().sum(-1) + 1e-9)
        return torch.log(torch.clamp(mel @ mag, min=1e-5))
    return chain


# n_fft 32, hop 8, win 32, 8 mels: the mel widths of the JAX package's
# multi-chip dry run (dissc_tpu/parallel/dryrun.py:101)
DRY_RUN_MEL = dict(n_fft=32, hop_size=8, win_size=32, num_mels=8, num_freq=17, fmax=None,
                   fmax_for_loss=None)


def kernel_cases():
    """(config, batch, samples) at which K1 is checked and timed: the train
    step's shape (the main path's), a long input, the dry run's widths and,
    on the long input, the ends of the configs K1 takes: n_fft 4096 with a
    centre-padded window (98 KB of shared memory, 256 threads), 1000 (N =
    500 = 4 * 5^3: radix-5 stages) and the odd 4095 (N = 4095 = 3^2 * 5 * 7
    * 13: no packing, 162 KB)."""
    h = VocoderConfig()
    return [(h, h.batch_size, h.segment_size), (h, 2, 40960),
            (VocoderConfig(**DRY_RUN_MEL), 4, 2560),
            (VocoderConfig(n_fft=4096, hop_size=1024, win_size=3200), 2, 40960),
            (VocoderConfig(n_fft=1000, hop_size=250, win_size=1000), 2, 40960),
            (VocoderConfig(n_fft=4095, hop_size=315, win_size=4095), 2, 40960)]


def mel_args(h: VocoderConfig) -> tuple:
    return (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size, h.win_size, float(h.fmin),
            h.fmax_for_loss)


def kernel_phase(dev: torch.device) -> dict:
    """K1 vs the plain chain at ``kernel_cases()``, on noise and, where the
    window spans the frame and n_fft <= 2048, on a tone with silence:
    forward atol 2e-4 / rtol 1e-4 (tests/test_kernels.py); gradient of
    mean|mel| within atol 1e-6 and within 1e-3 of its largest entry (its
    entries shrink with the element count of the mean), and not all zero;
    timed plain, kernel, kernel, plain, then the cuFFT chain twice (``ms``,
    the host's launch time included), and the kernel's own device time
    (``kernel_ms``, the profiler's, as ``chip_profile.py`` takes it).  The
    tone's empty bins hold only rounding noise, which in an fp32 transform
    of any kind grows with its peak bin, so with n_fft: past 2048 it
    outgrows the 1e-9 floor, and with a shorter window the tone leaks into
    every bin; cells at the 1e-5 clip then come out by rounding."""
    g = torch.Generator().manual_seed(0)
    rows, cufft = [], []
    for hc, b, t in kernel_cases():
        args = mel_args(hc)
        where = f"{(b, t)} n_fft {hc.n_fft}"
        y = ((torch.randn((b, t), generator=g) * 0.3).clamp(-1, 1)).to(dev)
        errs = {}
        inputs = [("noise", y)]
        if hc.win_size == hc.n_fft and hc.n_fft <= 2048:
            inputs.append(("tone_and_silence", tone_and_silence(b, t, hc.n_fft).to(dev)))
        for name, x in inputs:
            out = mel_kernel.mel_spectrogram_kernel(x, *args)
            ref = mel_spectrogram(x, *args)
            torch.cuda.synchronize()
            check(out.shape == ref.shape, f"mel shape {tuple(out.shape)} vs {tuple(ref.shape)}")
            check(bool(torch.isfinite(out).all()), f"mel kernel output finite at {where}")
            err = (out - ref).abs()
            check(bool((err <= 2e-4 + 1e-4 * ref.abs()).all()),
                  f"mel forward at {where} on {name}: max abs err {float(err.max())}")
            errs[name] = float(err.max())

        yk = y.clone().requires_grad_(True)
        mel_kernel.mel_spectrogram_grad(yk, *args).abs().mean().backward()
        yp = y.clone().requires_grad_(True)
        mel_spectrogram(yp, *args).abs().mean().backward()
        grad_err = float((yk.grad - yp.grad).abs().max())
        grad_max = float(yp.grad.abs().max())
        check(float(yk.grad.abs().max()) > 0, f"mel gradient at {where} is not all zero")
        check(grad_err <= min(1e-6, 1e-3 * grad_max),
              f"mel gradient at {where}: {grad_err} (largest entry {grad_max})")

        plain = lambda: mel_spectrogram(y, *args)
        kern = lambda: mel_kernel.mel_spectrogram_kernel(y, *args)
        yard = functools.partial(cufft_chain(hc, dev), y)
        p1, k1, k2, p2, c1, c2 = (sync_time_ms(f)
                                  for f in (plain, kern, kern, plain, yard, yard))
        kernel_us = own_kernel_us(kern)
        cufft_err = float((yard() - plain()).abs().max())
        bound_ms, bound_by = mel_bound_ms(b, t, hc)
        row = {"shape": [b, t], "n_fft": hc.n_fft, "hop_size": hc.hop_size,
               "win_size": hc.win_size, "num_mels": hc.num_mels,
               "max_abs_err": max(errs.values()), "max_abs_err_by_input": errs,
               "grad_max_abs_err": grad_err, "grad_max_abs": grad_max, "ms": (k1 + k2) / 2,
               "kernel_ms": float(np.mean(kernel_us)) / 1e3,
               "kernel_ms_records": len(kernel_us),
               "plain_ms": (p1 + p2) / 2, "cufft_chain_ms": (c1 + c2) / 2,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ms_turns": [p1, k1, k2, p2, c1, c2]}
        print("mel kernel", json.dumps(row), flush=True)
        rows.append(row)
        cufft.append({"shape": [b, t], "n_fft": hc.n_fft, "ms": row["cufft_chain_ms"],
                      "max_abs_err_vs_plain": cufft_err})
    print("cufft_chain_ms", json.dumps(cufft), flush=True)
    return rows[0]  # the train shape is the main path's


def synthetic_batch(h: VocoderConfig, g: torch.Generator, dev: torch.device) -> dict:
    """A batch shaped as bench.py's train-step batches."""
    frames = h.segment_size // h.code_hop_size
    b = h.batch_size
    return {"code": torch.randint(0, h.num_embeddings, (b, frames), generator=g).to(dev),
            "f0": torch.randn((b, frames, 1), generator=g).to(dev),
            "spkr": torch.randint(0, 100, (b, 1), generator=g).to(dev),
            "audio": (torch.randn((b, h.segment_size), generator=g) * 0.3).to(dev)}


def train_reference_check(dev: torch.device, **mel_widths) -> None:
    """Two GAN steps of a small config (with ``mel_widths`` over the
    defaults) on the card against the same steps on the CPU (plain mel
    chain, CPU convolutions), from the same seed; each card step launches
    K1 twice.  Losses rtol 1e-3: AdamW's first update is about
    lr * sign(grad), so a gradient entry at float-noise level can move a
    weight by up to 2 lr."""
    h = VocoderConfig(upsample_initial_channel=32, embedding_dim=8, model_in_dim=17,
                      segment_size=1280, batch_size=2, mpd_periods=(2, 3), msd_scales=2,
                      **mel_widths)
    g = torch.Generator().manual_seed(5)
    batches = [synthetic_batch(h, g, torch.device("cpu")) for _ in range(2)]
    runs = []
    for d in (torch.device("cpu"), dev):
        trainer = GANTrainer(h, device=d, seed=h.seed)
        metrics = []
        for b in batches:
            launches = mel_kernel.launch_counts["mel_spectrogram"]
            metrics.append({k: float(v) for k, v in trainer.train_step(b).items()})
            launched = mel_kernel.launch_counts["mel_spectrogram"] - launches
            check(launched == (2 if d.type == "cuda" else 0),
                  f"{launched} mel kernel launches in a small {d.type} step, n_fft {h.n_fft}")
        runs.append(metrics)
    worst = 0.0
    for cpu_m, card_m in zip(*runs):
        for k, ref in cpu_m.items():
            worst = max(worst, abs(card_m[k] - ref) / max(abs(ref), 1e-6))
            check(abs(card_m[k] - ref) <= 1e-3 * abs(ref) + 1e-5,
                  f"{k} at n_fft {h.n_fft}: card {card_m[k]} vs CPU {ref}")
    print(f"train reference (n_fft {h.n_fft}, hop {h.hop_size}, {h.num_mels} mels): 2 small "
          f"GAN steps, card vs CPU, K1 launched twice a card step, worst relative loss error",
          worst, flush=True)


def train_phase(h: VocoderConfig, dev: torch.device, steps: int = 4) -> GANTrainer:
    trainer = GANTrainer(h, device=dev, seed=h.seed)
    g = torch.Generator().manual_seed(1)
    batches = [synthetic_batch(h, g, dev) for _ in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for batch in batches:
        launches = mel_kernel.launch_counts["mel_spectrogram"]
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        check(mel_kernel.launch_counts["mel_spectrogram"] == launches + 2,
              "the mel kernel launched twice in the step")
        metrics = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in metrics.values()), f"finite losses {metrics}")
        print("train step", trainer.step, json.dumps(metrics), f"{step_ms[-1]:.1f} ms",
              flush=True)
    err, y_hat = trainer.val_step(batches[0])
    torch.cuda.synchronize()
    check(tuple(y_hat.shape) == (h.batch_size, h.segment_size), "val y_hat shape")
    check(bool(torch.isfinite(err).all()), "val errors finite")
    print("train: ms/step after the first", json.dumps(step_ms[1:]),
          "mean", float(np.mean(step_ms[1:])), "| first step", step_ms[0],
          "| peak GiB", torch.cuda.max_memory_allocated() / 2**30,
          "| val mel err", float(err.mean()), flush=True)
    return trainer


def serve_phase(h: VocoderConfig, trainer: GANTrainer, dev: torch.device) -> None:
    engine = VocoderEngine(h, trainer.gen.state_dict(), device=dev)
    rng = np.random.default_rng(2)
    lengths = [100, 237, 400, 640, 1000, 1500, 2048, 77, 2600]
    items = [{"code": rng.integers(0, h.num_embeddings, n).astype(np.int64),
              "f0": rng.normal(0, 1, (n, 1)).astype(np.float32),
              "spkr": np.array([i * 11 % 100])} for i, n in enumerate(lengths)]
    engine.synthesize_utterances(items, batch_size=8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs, mean_rtf = engine.synthesize_utterances(items, batch_size=8)
    wall = time.perf_counter() - t0
    audio_s = sum(len(w) for w in wavs) / h.sampling_rate
    for n, w in zip(lengths, wavs):
        check(w.shape == (n * h.code_hop_size,), f"length of a {n}-frame request")
        check(bool(np.isfinite(w).all()), "finite audio")
    check(engine._streamer is not None, "the 2600-frame request streamed")
    print(f"serve: {len(items)} requests, {audio_s:.2f} s of audio in {wall:.3f} s, "
          f"RTF {wall / audio_s:.6f} (engine mean per call {mean_rtf:.6f})", flush=True)

    def forward(item):
        with torch.inference_mode():
            return engine.model(torch.as_tensor(item["code"][None], device=dev),
                                torch.as_tensor(item["f0"][None], device=dev),
                                torch.as_tensor(item["spkr"][None], device=dev))[0].cpu().numpy()

    # bucket padding moves only the last receptive field (infer/vocoder.py)
    rf = receptive_field_frames(engine.h)
    keep = (lengths[1] - rf) * h.code_hop_size
    bucket_err = float(np.abs(wavs[1][:keep] - forward(items[1])[:keep]).max())
    check(bucket_err < 1e-4, f"bucketed vs exact-length forward: {bucket_err}")
    stream_err = float(np.abs(wavs[-1] - forward(items[-1])).max())
    check(stream_err < 1e-4, f"streamed vs monolithic forward: {stream_err}")
    # the card against the port's CPU path on a small input
    small = {"code": items[0]["code"][:16], "f0": items[0]["f0"][:16], "spkr": items[0]["spkr"]}
    cpu_engine = VocoderEngine(h, trainer.gen.state_dict(), device="cpu")
    cpu_wav, _ = cpu_engine.synthesize_utterances([small])
    gpu_wav, _ = engine.synthesize_utterances([small])
    cpu_err = float(np.abs(cpu_wav[0] - gpu_wav[0]).max())
    check(cpu_err < 1e-4, f"card vs CPU on a 16-frame request: {cpu_err}")
    print("serve checks: bucketed vs exact", bucket_err, "| streamed vs monolithic",
          stream_err, "| card vs CPU", cpu_err, flush=True)


# bench.py's conversion batch: 8 utterances of 512 HuBERT frames (10.24 s),
# 107 speakers, rhythm de-normalised by (mean 4, std 2)
BENCH_B, BENCH_T = 8, 512
N_SPEAKERS = 107
BENCH_LEN_STATS = (4.0, 2.0)


@contextlib.contextmanager
def timed_calls(module, name: str, log: list):
    """While open, every call of ``module.name`` appends its wall ms to ``log``."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log.append(1e3 * (time.perf_counter() - t0))
        return out

    setattr(module, name, timed)
    try:
        yield log
    finally:
        setattr(module, name, fn)


def converter(m: dict, dev, len_stats) -> ProsodyConverter:
    """A ``ProsodyConverter`` on ``dev`` with copies of ``m``'s predictors."""
    conv = ProsodyConverter(device=dev)
    conv.set_models(len_model=copy.deepcopy(m["len_model"]), len_norm_stats=len_stats,
                    pitch_model=copy.deepcopy(m["pitch_model"]))
    conv.id2pitch_mean, conv.id2pitch_std = m["id2mean"], m["id2std"]
    return conv


def build_convert_models(h: VocoderConfig, gen_state: dict, dev: torch.device) -> dict:
    """HuBERT-base to layer 6 with a 100-unit codebook, the rhythm and "new"
    pitch models for 107 speakers and the vocoder, from fixed seeds."""
    g = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(7)
    hub_cfg = HubertConfig()
    hub_state = init_state_dict(hub_cfg, g)
    encoder = SpeechUnitEncoder(hub_state, np.zeros((100, hub_cfg.hidden_size), np.float32),
                                hub_cfg, device=dev)
    # k-means centroids seeded as k-means++ starts: the features of 100
    # frames of a seeded input (random centroids far from the features
    # would give a handful of units)
    with torch.inference_mode():
        seed_wav = torch.from_numpy((rng.standard_normal((2, 163920)) * 0.1).astype(np.float32))
        feats = encoder.model(seed_wav.to(dev)).reshape(-1, hub_cfg.hidden_size).cpu().numpy()
    codebook = feats[rng.choice(len(feats), 100, replace=False)]
    encoder.codebook = torch.from_numpy(codebook).to(dev)
    m = dict(hub_cfg=hub_cfg, hub_state=hub_state, codebook=codebook, encoder=encoder,
             len_model=LenPredictor(n_tokens=100, n_speakers=N_SPEAKERS, generator=g),
             pitch_model=build_pitch_model("new", 100, N_SPEAKERS, generator=g),
             id2mean=rng.uniform(100, 250, N_SPEAKERS).astype(np.float32),
             id2std=rng.uniform(10, 40, N_SPEAKERS).astype(np.float32),
             spk_dict={f"spk{i:03d}": i for i in range(N_SPEAKERS)},
             engine=VocoderEngine(h, gen_state, device=dev))
    m["prosody"] = converter(m, dev, BENCH_LEN_STATS)
    return m


def bench_inputs(rng: np.random.Generator):
    """``bench.py``'s batch: 8 waveforms of 163,920 samples (512 HuBERT
    frames; noise, std 0.1) and a speaker each."""
    wavs = (rng.standard_normal((BENCH_B, BENCH_T * 320 + 80)) * 0.1).astype(np.float32)
    return wavs, [f"spk{s:03d}" for s in rng.integers(0, N_SPEAKERS, BENCH_B)]


def convert_stages(m: dict, wavs: np.ndarray, names: list):
    """Units -> prosody (bucket 512, out_cap 1024) -> waveforms, with a sync
    after each stage; returns (units, converted records, waveforms, the
    stages' wall ms)."""
    T = wavs.shape[1] // 320
    t = [time.perf_counter()]
    units = m["encoder"].encode_units(wavs)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    records = [{"units": u.tolist(), "f0": [0.0] * T, "audio": f"{n}_{j:03d}.wav"}
               for j, (u, n) in enumerate(zip(units, names))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # truncations: the converter counts them
        converted = m["prosody"].convert_records(records, m["spk_dict"], norm_pitch=False,
                                                 batch_size=len(wavs))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    items = [{"code": np.asarray(c["units"], np.int64),
              "f0": np.asarray(c["f0"], np.float32).reshape(-1, 1),
              "spkr": np.array([m["spk_dict"][n]])} for c, n in zip(converted, names)]
    out, _ = m["engine"].synthesize_utterances(items, batch_size=len(wavs))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    return units, converted, out, np.diff(t) * 1e3


def convert_bench(m: dict, runs: int = 3) -> list:
    """(a) ``bench.py``'s shape through the three stages.  The first run
    warms up; returns the rest."""
    rng = np.random.default_rng(9)
    prosody = m["prosody"]
    results = []
    for run in range(runs):
        wavs, names = bench_inputs(rng)
        carry_ms = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        truncated = prosody.truncation_count
        with timed_calls(seqops, "carryover_host", carry_ms):
            units, converted, out, stage_ms = convert_stages(m, wavs, names)
        check(units.shape == (BENCH_B, BENCH_T) and 0 <= units.min() and units.max() < 100,
              f"units of shape {units.shape} in [0, 100)")
        out_cap = int(prosody.expand_factor * next(b for b in prosody.buckets if BENCH_T <= b))
        for c, w in zip(converted, out):
            check(0 < len(c["units"]) <= out_cap, f"prosody output within out_cap {out_cap}")
            check(w.shape == (320 * len(c["units"]),) and bool(np.isfinite(w).all()),
                  "vocoded length 320 x units, finite")
        audio_s = sum(len(w) for w in out) / m["engine"].h.sampling_rate
        row = {"run": run, "encode_ms": stage_ms[0], "prosody_ms": stage_ms[1],
               "vocode_ms": stage_ms[2], "wall_ms": float(stage_ms.sum()), "audio_s": audio_s,
               "rtf": float(stage_ms.sum()) / 1e3 / audio_s, "carryover_loop_ms": carry_ms,
               "truncations": prosody.truncation_count - truncated,
               "distinct_units": int(len(np.unique(units))),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print("convert (a) bench shape", json.dumps(row), flush=True)
        results.append(row)
    return results[1:]


def convert_phase(h: VocoderConfig, gen_state: dict, dev: torch.device) -> None:
    t0 = time.perf_counter()
    m = build_convert_models(h, gen_state, dev)
    encoder, prosody, spk_dict = m["encoder"], m["prosody"], m["spk_dict"]
    print(f"convert: models built in {time.perf_counter() - t0:.1f} s (HuBERT-base to layer "
          f"{m['hub_cfg'].output_layer}, {len(encoder.model.encoder.layers)} layers built)",
          flush=True)

    runs = convert_bench(m)
    mean = {k: float(np.mean([r[k] for r in runs]))
            for k in ("encode_ms", "prosody_ms", "vocode_ms", "wall_ms", "audio_s", "rtf")}
    print("convert (a) mean of the timed runs", json.dumps(mean), flush=True)

    # (b) one call, wav in and wav out, YAAPT included; a rhythm
    # de-normalisation that keeps the output inside out_cap
    sr = 22050
    wav = voiced_stretches(sr, seed=8)
    pipe_prosody = converter(m, dev, (1.5, 0.5))
    f0_stats = {n: {"mean": float(m["id2mean"][i]), "std": float(m["id2std"][i])}
                for n, i in spk_dict.items()}
    pipe = ConversionPipeline(m["engine"], pipe_prosody, spk_dict, f0_stats=f0_stats,
                              encoder=encoder)
    viterbi_ms, convert_ms, outs = [], [], []
    with timed_calls(yaapt, "_viterbi_states", viterbi_ms):
        for _ in range(2):  # the first call is cold (scipy's resampler loads on first use)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(pipe.convert(wav, "spk003", sr=sr, source_speaker="spk010"))
            torch.cuda.synchronize()
            convert_ms.append(1e3 * (time.perf_counter() - t0))
        record = pipe.encode(wav, sr)
    out, out_sr = outs[-1]
    # cuDNN picks its algorithms by the workspace free at the call, so two
    # calls agree to rounding, not bit for bit
    check(outs[0][0].shape == out.shape, "two convert calls give the same length")
    repeat_err = float(np.abs(outs[0][0] - out).max())
    check(repeat_err <= 1e-4, f"two convert calls differ by {repeat_err}")
    converted = pipe_prosody.convert_records([dict(record, audio="spk010_probe.wav")], spk_dict,
                                             "spk003", norm_pitch=True)[0]
    check(pipe_prosody.truncation_count == 0, "no truncation in the pipeline call")
    check(out_sr == 16000 and out.shape == (320 * len(converted["units"]),),
          f"output length {out.shape} is 320 x the predicted durations' sum "
          f"{len(converted['units'])}")
    check(bool(np.isfinite(out).all()), "finite converted waveform")
    f0 = np.asarray(record["f0"])
    medians = []
    for a, b, f_true in STRETCHES:
        seg = f0[int(a / 0.02) + 5:int(b / 0.02) - 5]
        voiced = seg[seg > 0]
        check(voiced.size > 0.7 * seg.size, f"stretch at {f_true} Hz mostly voiced")
        medians.append(float(np.median(voiced)))
        check(abs(medians[-1] - f_true) / f_true < 0.05,
              f"YAAPT median {medians[-1]} Hz on the {f_true} Hz stretch")
    print("convert (b) pipeline", json.dumps({
        "input_s": len(wav) / sr, "input_sr": sr, "units": len(record["units"]),
        "output_frames": len(converted["units"]), "output_s": len(out) / out_sr,
        "convert_ms_cold_then_warm": convert_ms, "repeat_max_abs_diff": repeat_err,
        "viterbi_loop_ms": viterbi_ms,
        "yaapt_frames": 4 * len(record["units"]), "stretch_f0_true": [s[2] for s in STRETCHES],
        "stretch_f0_median": medians}), flush=True)

    # (c) the card against the port's CPU path on small inputs: every
    # comparison is taken and printed, then each is checked
    cpu_encoder = SpeechUnitEncoder(m["hub_state"], m["codebook"], m["hub_cfg"], device="cpu")
    wav1 = (np.random.default_rng(10).standard_normal(16000) * 0.1).astype(np.float32)
    with torch.inference_mode():
        f_card = encoder.model(torch.as_tensor(wav1[None], device=dev)).cpu()
        f_cpu = cpu_encoder.model(torch.as_tensor(wav1[None]))
    hubert_err = float((f_card - f_cpu).abs().max())
    units_equal = np.array_equal(encoder.encode_units(wav1), cpu_encoder.encode_units(wav1))

    records = [dict(record, units=record["units"][40 * j:40 * j + 120],
                    f0=record["f0"][40 * j:40 * j + 120], audio=f"spk{7 * j:03d}_{j}.wav")
               for j in range(6)]
    cpu_prosody = converter(m, "cpu", BENCH_LEN_STATS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # truncations, counted by the converters
        card_p = prosody.convert_records(records, spk_dict, "spk050", norm_pitch=False)
        cpu_p = cpu_prosody.convert_records(records, spk_dict, "spk050", norm_pitch=False)
    fa, fb = (np.concatenate([np.asarray(r["f0"]) for r in p]) for p in (card_p, cpu_p))
    prosody_units_equal = [a["units"] for a in card_p] == [b["units"] for b in cpu_p]
    prosody_voicing_equal = fa.shape == fb.shape and np.array_equal(fa > 0, fb > 0)
    f0_rel = (float(np.max(np.abs(fa - fb) / np.maximum(np.abs(fb), 1e-6)))
              if fa.shape == fb.shape else float("inf"))

    # the candidates' tie order (a stable sort) on the card, on the CPU's NCCF
    nccf = torch.rand((400, 241), generator=torch.Generator().manual_seed(11)) * 0.5
    nccf[:, ::3] = 0.25  # runs of equal values and frames short of 5 peaks
    f_cpu, m_cpu = yaapt._candidates(nccf, 16000, 40, 267)
    f_dev, m_dev = (t.cpu() for t in yaapt._candidates(nccf.to(dev), 16000, 40, 267))
    lags_equal = torch.equal(torch.round(16000 / f_dev), torch.round(16000 / f_cpu))
    merit_err = float((m_dev - m_cpu).abs().max())

    wav16 = resample_poly_np(wav, sr, 16000)
    y_card = yaapt.yaapt_f0(wav16, 16000, device=dev)
    y_cpu = yaapt.yaapt_f0(wav16, 16000, device="cpu")
    v = y_cpu > 0
    rel = np.abs(y_card - y_cpu) / np.maximum(y_cpu, 1e-6)
    yaapt_rel = float(np.max(rel[v])) if v.any() else 0.0
    bad = np.nonzero(((y_card > 0) != v) | (rel > 1e-4))[0]

    small = dict(record, units=record["units"][:30], f0=record["f0"][:30])
    cpu_pipe = ConversionPipeline(VocoderEngine(h, gen_state, device="cpu"),
                                  converter(m, "cpu", (1.5, 0.5)), spk_dict, f0_stats=f0_stats)
    w_card, _ = pipe.convert_record(small, "spk003", source_speaker="spk010")
    w_cpu, _ = cpu_pipe.convert_record(small, "spk003", source_speaker="spk010")
    wave_err = (float(np.abs(w_card - w_cpu).max()) if w_card.shape == w_cpu.shape
                else float("inf"))
    print("convert (c) card vs CPU", json.dumps({
        "hubert_feature_max_abs_err": hubert_err, "hubert_units_equal": units_equal,
        "prosody_records": len(records), "prosody_units_equal": prosody_units_equal,
        "prosody_voicing_equal": prosody_voicing_equal, "prosody_f0_max_rel_err": f0_rel,
        "candidate_lags_equal": lags_equal, "candidate_merit_max_abs_err": merit_err,
        "yaapt_frames": len(y_cpu), "yaapt_voiced_f0_max_rel_err": yaapt_rel,
        "yaapt_frames_that_differ": {"count": int(len(bad)), "frames": bad[:20].tolist(),
                                     "card": y_card[bad[:20]].tolist(),
                                     "cpu": y_cpu[bad[:20]].tolist()},
        "convert_record_max_abs_err": wave_err}), flush=True)
    check(hubert_err <= 1e-4, f"HuBERT features card vs CPU: {hubert_err}")
    check(units_equal, "HuBERT units card vs CPU")
    check(prosody_units_equal, "prosody units and durations card vs CPU")
    check(prosody_voicing_equal, "prosody voicing card vs CPU")
    check(f0_rel <= 1e-4, f"prosody f0 card vs CPU, relative {f0_rel}")
    check(lags_equal and merit_err <= 1e-6, "YAAPT candidates and their tie order card vs CPU")
    check(np.array_equal(y_card > 0, v), "YAAPT voicing card vs CPU on every frame")
    check(yaapt_rel <= 1e-4, f"YAAPT voiced f0 card vs CPU, relative {yaapt_rel}")
    check(wave_err <= 1e-4, f"convert_record waveform card vs CPU: {wave_err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "| allow_tf32: cuda.matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32, flush=True)
    t0 = time.perf_counter()
    mel_kernel._launcher()  # builds csrc/mel_kernel.cu
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    h = VocoderConfig()
    mel_row = kernel_phase(dev)
    train_reference_check(dev)
    train_reference_check(dev, **DRY_RUN_MEL)

    mel_kernel.reset_launch_counts()
    steps = 4
    trainer = train_phase(h, dev, steps)
    launches = mel_kernel.launch_counts["mel_spectrogram"]
    check(launches == 2 * steps + 2, f"mel kernel launches {launches} != 2 per step + 2 (val)")
    serve_phase(h, trainer, dev)
    gen_state = {k: v.detach().clone() for k, v in trainer.gen.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()

    mel_kernel.reset_launch_counts()
    convert_phase(h, gen_state, dev)
    check(mel_kernel.launch_counts["mel_spectrogram"] == 0,
          "the conversion path launched no kernel of the port")

    kernels = [{"name": "mel_spectrogram", "route": "cuda",
                "source": "dissc_tpu_torch/csrc/mel_kernel.cu",
                "replaces": "dissc_tpu/kernels/mel_kernel.py:112",
                "launches": launches, "max_abs_err": mel_row["max_abs_err"],
                "grad_max_abs_err": mel_row["grad_max_abs_err"],
                "ms": mel_row["ms"], "kernel_ms": mel_row["kernel_ms"],
                "plain_ms": mel_row["plain_ms"],
                "bound_ms": mel_row["bound_ms"],
                "bound_by": mel_row["bound_by"], "library_ms": None}]
    print("library_ms: null; no single PyTorch call computes a log-mel spectrogram (the "
          "cuFFT chain above is several calls)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
