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
   ``convert_record``);
6. train loop, the training paths through their CLIs, with the launch and
   native-crop counters set to 0 just before and read just after: (a)
   ``cli.sr_train`` at ``VocoderConfig()`` width, batch 64, over a seeded
   corpus of 128 wavs (0.4-4 s, 4 speakers; the short ones tile) for 6
   steps with checkpoints and validation every 3 (the val manifest has no
   f0, so YAAPT runs on every val crop), then again to step 8, resuming;
   K1 must launch twice a step and twice a validation batch, the crops
   must come from the native loader, the resumed run must start from the
   saved state exactly, the learning rate must follow the per-epoch decay,
   and ``VocoderEngine.from_checkpoint`` must serve from the written
   ``g_``; (b) ``cli.train_len`` and ``cli.train_f0`` (base and new) for 2
   epochs on 107 speakers, 4,096 train and 256 val records, then
   ``ProsodyConverter.load`` converts the val records on the card; (c) the
   card against the CPU: one rhythm and one pitch train step, and two
   ``train_vocoder`` steps at a small config;
7. convert + eval, the offline conversion-and-evaluation path through its
   CLIs, with the launch counters set to 0 just before and read just after
   (it launches no kernel of the port): a seeded VCTK-shaped corpus (4
   speakers x 2 utterances of 2-5 s at 48 / 22.05 kHz, transcripts, FLAC
   ground truth) through ``cli.preprocess --trim --pad``, ``cli.encode``
   (HuBERT-base) and ``cli.prep_dataset``, then ``cli.convert_eval --data
   vctk --dissc_type dissc_b --sort_gt --dtw_align --whisper_model`` with
   the prosody models at ``ProsodyConfig()``, ``VocoderConfig()`` and
   Whisper medium.en written from seeds as a local HF directory; every
   output, DTW grid and metric checked, every stage timed; (c) the card
   against the CPU (``run_inference``, ``calc_errors``, Whisper at a
   reduced config); (d) Whisper medium.en's encoder and decode step timed;
8. speaker verification, over phase 7's tree, with the launch counters set
   to 0 just before and read just after (no kernel of the port): a pair CSV
   with a leading index column (each val utterance converted to the three
   other speakers, scored against the target's own utterance and another
   speaker's) and a speechbrain-keyed ECAPA-TDNN at ``EcapaConfig()`` width
   from a seed, then ``cli.convert_eval_sv --data vctk --dissc_type dissc_b
   --speechbrain_ckpt``; every restructured file checked and the EER held
   to ``compute_eer`` of the scores recomputed from the files, each stage
   and ECAPA's ms a file timed; (b) ECAPA card vs CPU on 3 files;
9. F0-VQ and k-means, with the launch counters set to 0 just before and
   read just after (no kernel of the port): (a)-(b) an ``F0Dataset`` of
   8960-sample crops over phase 6's corpus, ``train_f0_quantizer`` at
   ``DEFAULT_F0_PARAMS``, batch 16, 40 steps, ``g_`` every 20 (finite
   losses, the codebook bootstrapped by step 1, the last ``g_`` reloaded
   gives the same eval mse); (c) ``CodeGenerator`` at ``VocoderConfig()``
   with ``lambda_commit`` (conditioning 384 channels) at batch 64 x 28
   codes, timed, and card vs CPU at a small width; (d) ``train_kmeans``,
   k=100, 5 epochs, over HuBERT-base layer-6 features of phase 5's inputs
   (4,096 x 768), timed; every step of a recorded card run redone on the
   CPU from the card's state, and the final assignment: a label that flips
   is reported with its tie's gap, which must lie within f32's rounding of
   the distance expansion, and the centroids no flip touched within 1e-4;
10. data parallel, through ``parallel/dryrun.py`` as commands (their ranks
   spawn from them) and the CLIs, with the launch counters set to 0 just
   before and read just after (the ranks count their own): (a) the GAN step
   at ``VocoderConfig()`` width, global batch 64, 3 SGD steps (lr 1e-3),
   cuDNN's deterministic algorithms, through ``init_process_group("nccl")``
   and DDP at W = 1, held to the plain ``GANTrainer`` step within 1e-7; (b)
   the same at W = 2 over gloo, both ranks on the one card, 32 rows each,
   parameters within 2e-5 of (a) and losses within rtol 1e-4, with each
   rank's ms a step, its all-reduce's share and peak GiB; (c) one
   ``LenPredictor``, ``PitchPredictor`` and ``PitchPredictorBase`` step
   (masking off and on, synced BatchNorm) and a ``BottleneckBlock`` update
   and ``Quantizer`` step with a restart at W = 2 gloo, each within 2e-5
   of one process; (d) ``VocoderEngine`` and ``ConversionPipeline`` split
   over the card twice against one device (9 utterances of 77-2600 frames,
   one streamed; 9 records), within 1e-4 and in order; (e) ``cli.sr_train``
   with its own launcher (W = the cards that divide the batch) for 2 steps,
   then resumed to 4, rank 0's ``g_``/``do_`` served; (f) where there are
   several cards, (a) at W = the card count; else it says it skipped;
11. bfloat16, the mixed-precision compute paths, with the launch counters
   set to 0 just before and read just after: (a) ``bench.py``'s shape
   through phase 5's float32 models and, in turn on the same inputs, their
   bfloat16 counterparts loaded through the entry points (a vocoder
   ``config.json`` with ``compute_dtype`` bfloat16, ``load_encoder`` with
   ``HubertConfig(compute_dtype="bfloat16")``, a ``ConversionPipeline``),
   stage ms and RTF of both; the vocoder on the same records in both
   dtypes within ``tests/test_bf16.py``'s bounds (log-mel mean L1 and max
   |dy| < 0.05), its waveform float32, HuBERT's units equal on >= 95 % of
   frames, one pipeline call on a recording; card vs CPU bfloat16 on one
   utterance (vocoder) and 1 s (HuBERT), within the sum of the two
   devices' bfloat16-vs-float32 distances; the generator is phase 10's
   seeded init with its weight-norm gains 0.8 and biases 0, so that its
   waveform has speech's level; (b) ``cli.sr_train`` at
   ``VocoderConfig()`` with ``compute_dtype`` and ``disc_compute_dtype``
   bfloat16, batch 64, over phase 6's corpus, 4 steps: ms a step, peak
   GiB, K1 twice a step, float32 master parameters, the ``g_`` file in the
   JAX layout; then one ``GANTrainer`` step in float32 and in bfloat16
   from one init and one batch, each loss within 0.05 |f32| + 0.05.

12. the model axis and the fused MSD G step, with the launch counters set
   to 0 just before and read just after (the ranks count their own): (a)
   through ``parallel/dryrun.py``, the GAN step at ``VocoderConfig()``
   width, global batch 32 (cut from 64: each rank of a model group holds
   all of its data shard's rows), 3 SGD steps, cuDNN deterministic: plain
   at W = 1 (and again on cuDNN's heuristics, for the spread), then
   ``--shard tp --model 2`` at W = 2 (data 1 x model 2) and W = 4 (data 2 x
   model 2), gloo with the ranks sharing the card (NCCL where there is a
   card a rank); the gathered generator, MPD, MSD and losses within 2e-5 of
   the plain step after step 1 and within 8 x its spread after 3, each
   rank's ms a step, peak GiB, model-group collective ms, K1 twice a step
   and the largest gap between the model ranks' replicated parameters
   (0); (b) ``GANTrainer`` at ``VocoderConfig()``, batch 64, 3 steps from
   one seed and batch with ``msd_fused_gstep`` off and then on, in float32
   and in bfloat16 (``disc_compute_dtype``), cuDNN deterministic: ms a step
   and peak GiB of each, and of the MSD's G-step terms alone, the fused
   generator gradient and spectral ``u``
   after step 1 within 1e-5 of the plain step's (relative L2) in float32
   and within half of the plain step's bf16-vs-f32 distance in bfloat16.

It exits non-zero on any failure and without a card.  The line before
the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import glob
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dissc_tpu_torch.audio import yaapt
from dissc_tpu_torch.audio.mel import hann_window, mel_filterbank, mel_spectrogram
from dissc_tpu_torch.audio.probes import STRETCHES, tone_and_silence, voiced_stretches
from dissc_tpu_torch.audio.resample import resample_poly_np
from dissc_tpu_torch.cli import sr_train, train_f0, train_len
from dissc_tpu_torch.compat.from_jax import generator_state_dict
from dissc_tpu_torch.core import seqops
from dissc_tpu_torch.core.config import ProsodyConfig, VocoderConfig, resolve_dtype
from dissc_tpu_torch.core.wav import write_wav
from dissc_tpu_torch.data import native_loader
from dissc_tpu_torch.data.stats import load_f0_stats, load_id_to_spkr, prep_stats_arrays
from dissc_tpu_torch.device import generator_for
from dissc_tpu_torch.infer.prosody import ProsodyConverter
from dissc_tpu_torch.infer.streaming import receptive_field_frames
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.kernels import mel_kernel
from dissc_tpu_torch.losses.gan import feature_loss, generator_loss
from dissc_tpu_torch.models.discriminators import MultiScaleDiscriminator
from dissc_tpu_torch.models.hubert import HubertConfig, SpeechUnitEncoder, init_state_dict
from dissc_tpu_torch.models.msd_fused import fold_msd_weights, msd_g_apply
from dissc_tpu_torch.models.prosody import LenPredictor
from dissc_tpu_torch.parallel.mesh import world_for_batch
from dissc_tpu_torch.pipeline import ConversionPipeline
from dissc_tpu_torch.train import prosody_trainer, vocoder_trainer
from dissc_tpu_torch.train.checkpoints import load_checkpoint
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


WINDOW_SETTLE_S = 0.05  # profiler window margin around the timed launches


def own_kernel_us(fn, match: str = "log_mel_fft_kernel", n: int = 20) -> list:
    """The device time of each launch of the kernel named ``match`` over
    ``n`` calls of ``fn`` (``torch.profiler``'s kernel durations, after 3
    warm-up calls): the kernel alone, without the host's time to launch it.

    CUPTI may drop an activity record (one H100 run kept 19 of 20, another 3
    of 20 at n_fft 4095), so the list holds the records it kept: at least
    half of ``n``, and never more than ``n`` (more would mean ``match`` names
    another kernel too).  The window stays open ``WINDOW_SETTLE_S`` before
    the first launch and after the last kernel ends: the profiler keeps only
    activity inside its window, timed on the device's clock against the
    host's, and reads CUPTI's buffers at its close, so a kernel that ends
    right at the close (the 109 us ones at n_fft 4095 end last) is the one
    at risk."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_SETTLE_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(WINDOW_SETTLE_S)
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
    check(bool(engine._streamers), "the 2600-frame request streamed")
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


# ---------------------------------------------------------------------------
# 6. train loop: the training paths through their CLIs
# ---------------------------------------------------------------------------

N_TRAIN_WAVS, N_VAL_WAVS, N_WAV_SPEAKERS = 128, 8, 4


def write_vocoder_corpus(root: str, n: int = N_TRAIN_WAVS, n_val: int = N_VAL_WAVS,
                         seconds=(0.4, 4.0), seed: int = 12) -> tuple:
    """Seeded 16 kHz wavs ``pNNN_xxxx.wav`` (``N_WAV_SPEAKERS`` speakers) of
    voiced harmonics between stretches of silence, a JSONL train manifest
    whose lines carry ``units`` (100 codes, one per 320 samples) and per-unit
    ``f0``, and a val manifest of ``n_val`` of them with ``units`` only.
    Returns (train manifest, val manifest)."""
    rng = np.random.default_rng(seed)
    train, val = [], []
    for i in range(n):
        samples = int(rng.uniform(*seconds) * 16000)
        f = rng.uniform(90, 250)
        t = np.arange(samples) / 16000
        env = (np.sin(2 * np.pi * rng.uniform(0.5, 2) * t) > -0.3).astype(np.float64)
        x = env * (0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(4 * np.pi * f * t))
        x += 0.02 * rng.standard_normal(samples)
        name = f"p{225 + i % N_WAV_SPEAKERS}_{i:04d}.wav"
        write_wav(os.path.join(root, name), x, 16000)
        frames = samples // 320
        voiced = env[::320][:frames] > 0
        line = {"audio": name, "units": rng.integers(0, 100, frames).tolist()}
        train.append(dict(line, f0=np.where(voiced, f, 0.0).round(2).tolist()))
        if i < n_val:
            val.append(line)
    paths = []
    for split, lines in (("train", train), ("val", val)):
        paths.append(os.path.join(root, f"{split}.jsonl"))
        with open(paths[-1], "w") as fh:
            fh.writelines(json.dumps(line) + "\n" for line in lines)
    return tuple(paths)


def write_vocoder_config(root: str, manifests: tuple, **over) -> str:
    cfg = dict(VocoderConfig().to_dict(), input_training_file=manifests[0],
               input_validation_file=manifests[1], train_base_path=root, val_base_path=root,
               **over)
    path = os.path.join(root, "config.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


@contextlib.contextmanager
def recorded_steps(log: list):
    """While open, every ``GANTrainer.train_step`` appends its metrics."""
    step = GANTrainer.train_step

    def recording(self, batch):
        out = step(self, batch)
        log.append(out)
        return out

    GANTrainer.train_step = recording
    try:
        yield log
    finally:
        GANTrainer.train_step = step


@contextlib.contextmanager
def restored_states(log: list):
    """While open, each ``GANTrainer.restore`` appends a host copy of the
    trainer's state as it stands right after the restore."""
    restore = GANTrainer.restore

    def recording(self, cp_g, cp_do):
        epoch = restore(self, cp_g, cp_do)
        log.append(trainer_state(self))
        return epoch

    GANTrainer.restore = recording
    try:
        yield log
    finally:
        GANTrainer.restore = restore


def trainer_state(trainer: GANTrainer) -> dict:
    """Host copies of a trainer's parameters, buffers and optimizer moments."""
    host = lambda t: t.detach().cpu().clone()  # noqa: E731
    out = {"step": trainer.step}
    for name in ("gen", "mpd", "msd"):
        out[name] = {k: host(v) for k, v in getattr(trainer, name).state_dict().items()}
    for name in ("opt_g", "opt_d"):
        state = getattr(trainer, name).state_dict()
        out[name] = {(i, k): host(v) for i, st in state["state"].items() for k, v in st.items()}
        out[name + "_lr"] = state["param_groups"][0]["lr"]
    return out


def same_state(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        if isinstance(a[k], dict):
            if a[k].keys() != b[k].keys() or not all(torch.equal(a[k][j], b[k][j])
                                                    for j in a[k]):
                return False
        elif a[k] != b[k]:
            return False
    return True


def vocoder_loop(h: VocoderConfig, root: str, dev: torch.device) -> int:
    """(a): 6 steps, checkpoints and validation every 3, then resume to 8;
    returns K1's launches over both runs."""
    manifests = write_vocoder_corpus(root)
    config = write_vocoder_config(root, manifests)
    ckpt = os.path.join(root, "ckpt")
    argv = ["--config", config, "--checkpoint_path", ckpt, "--stdout_interval", "1",
            "--checkpoint_interval", "3", "--validation_interval", "3"]
    steps_per_epoch = N_TRAIN_WAVS // h.batch_size
    val_batches = -(-N_VAL_WAVS // min(h.batch_size, N_VAL_WAVS))
    metrics, restored, runs = [], [], []
    torch.cuda.reset_peak_memory_stats()
    mel_kernel.reset_launch_counts()
    native_loader.reset_call_counts()
    t0 = time.perf_counter()
    with recorded_steps(metrics), restored_states(restored):
        for steps, n_val in ((6, 2), (8, 0)):
            launches = mel_kernel.launch_counts["mel_spectrogram"]
            trainer, stats = sr_train.main(argv + ["--training_steps", str(steps)])
            launched = mel_kernel.launch_counts["mel_spectrogram"] - launches
            check(trainer.step == steps, f"the loop ended at step {trainer.step}, not {steps}")
            check(launched == 2 * (steps - stats["start_step"])
                  + 2 * n_val * val_batches,
                  f"{launched} K1 launches in a run to step {steps}: 2 a step, 2 a val batch")
            runs.append({"to_step": steps, "launches": launched,
                         "lr": [trainer.opt_g.param_groups[0]["lr"],
                                trainer.opt_d.param_groups[0]["lr"]], **stats})
            if steps == 6:
                saved = trainer_state(trainer)
            del trainer
            torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    launches = mel_kernel.launch_counts["mel_spectrogram"]
    crops = native_loader.call_counts["load_crops"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]

    check(launches == 2 * 8 + 2 * 2 * val_batches, f"K1 launches {launches} in the loop")
    check(crops >= 8 + 2 * val_batches, f"{crops} batches from the native crop loader")
    check(len(losses) == 8 and all(np.isfinite(v) for m in losses for v in m.values()),
          "8 steps with finite losses")
    check(len(restored) == 1 and restored[0]["step"] == 6 and runs[1]["start_step"] == 6,
          "the second run resumed at step 6")
    check(same_state(restored[0], saved), "the resumed run began with the saved parameters, "
                                          "buffers and optimizer moments")
    g_file = load_checkpoint(os.path.join(ckpt, "g_00000006"))["generator"]
    check(all(torch.equal(v, saved["gen"][k])
              for k, v in generator_state_dict(g_file, h).items()), "g_00000006 = the state")
    do_file = load_checkpoint(os.path.join(ckpt, "do_00000006"))
    check(all(np.array_equal(do_file["optim_g"]["state"][i][k], v.numpy())
              for (i, k), v in saved["opt_g"].items()), "do_00000006 holds the moments")
    want_lr = h.learning_rate * h.lr_decay ** (8 // steps_per_epoch)
    check(all(abs(lr - want_lr) <= 1e-12 * want_lr for lr in runs[1]["lr"]),
          f"learning rate after step 8 {runs[1]['lr']} vs the schedule's {want_lr}")
    engine = VocoderEngine.from_checkpoint(ckpt, device=dev)
    rng = np.random.default_rng(13)
    item = {"code": rng.integers(0, 100, 200), "spkr": np.array([1]),
            "f0": rng.uniform(-1, 1, (200, 1)).astype(np.float32)}
    wavs, _ = engine.synthesize_utterances([item])
    check(wavs[0].shape == (200 * 320,) and bool(np.isfinite(wavs[0]).all()),
          "the written g_ serves a request")

    step_ms = [1e3 * s for r in runs for s in r["step_s"][1:]]
    row = {"steps": [r["to_step"] for r in runs], "launches": launches,
           "launches_by_run": [r["launches"] for r in runs], "native_crop_batches": crops,
           "ms_per_step_with_data_steps_2_plus": step_ms,
           "ms_per_step_mean": float(np.mean(step_ms)),
           "first_step_ms": [1e3 * r["step_s"][0] for r in runs],
           "prefetch_wait_share": [r["prefetch_wait_s"] / r["wall_s"] for r in runs],
           "checkpoint_write_s": [s for r in runs for s in r["checkpoint_s"]],
           "validation_s": [s for r in runs for s in r["validation_s"]],
           "loop_wall_s": [r["wall_s"] for r in runs], "phase_wall_s": wall, "peak_gib": peak,
           "lr_after_8": runs[1]["lr"], "losses_step_8": losses[-1]}
    print("train loop (a) vocoder", json.dumps(row), flush=True)
    return launches


N_PROSODY_SPEAKERS = 107


def write_unit_corpus(root: str, n_train: int = 4096, n_val: int = 256, seed: int = 14) -> list:
    """``train.txt``/``val.txt`` of unit records (50-400 units, runs of 1-6,
    per-unit f0 with a third unvoiced) over ``N_PROSODY_SPEAKERS`` speakers,
    with ``id_to_spkr.pkl`` and ``f0_stats.pkl``; returns the val records."""
    rng = np.random.default_rng(seed)
    names = [f"spk{i:03d}" for i in range(N_PROSODY_SPEAKERS)]
    means = rng.uniform(100, 250, N_PROSODY_SPEAKERS)
    records = {}
    for split, n in (("train", n_train), ("val", n_val)):
        recs = []
        for j in range(n):
            k = int(rng.integers(50, 401))
            spk = int(rng.integers(0, N_PROSODY_SPEAKERS))
            units = np.repeat(rng.integers(0, 100, k), rng.integers(1, 7, k))[:k]
            f0 = np.where(rng.random(k) < 0.33, 0.0, rng.normal(means[spk], 20, k))
            recs.append({"units": units.tolist(), "f0": f0.round(2).tolist(),
                         "audio": f"{names[spk]}_{split}{j:05d}.wav"})
        with open(os.path.join(root, f"{split}.txt"), "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in recs)
        records[split] = recs
    with open(os.path.join(root, "id_to_spkr.pkl"), "wb") as fh:
        pickle.dump(names, fh)
    with open(os.path.join(root, "f0_stats.pkl"), "wb") as fh:
        pickle.dump({n: {"mean": float(means[i]), "std": 20.0} for i, n in enumerate(names)}, fh)
    return records["val"]


@contextlib.contextmanager
def timed_train_steps(step_ms: list):
    """While open, the train steps that ``prosody_trainer`` builds append
    their wall ms (synchronised)."""
    makers = {name: getattr(prosody_trainer, name)
              for name in ("make_len_steps", "make_pitch_steps")}

    def wrap(make):
        def made(*args, **kw):
            train_step, eval_step = make(*args, **kw)

            def timed(*a):
                t0 = time.perf_counter()
                out = train_step(*a)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                return out
            return timed, eval_step
        return made

    for name, make in makers.items():
        setattr(prosody_trainer, name, wrap(make))
    try:
        yield step_ms
    finally:
        for name, make in makers.items():
            setattr(prosody_trainer, name, make)


def prosody_loop(root: str, dev: torch.device) -> None:
    """(b): the rhythm and both pitch trainers for 2 epochs through their
    CLIs, then ``ProsodyConverter.load`` converts the val records."""
    data = os.path.join(root, "units")
    os.makedirs(data)
    t0 = time.perf_counter()
    val = write_unit_corpus(data)
    corpus_s = time.perf_counter() - t0
    common = ["--data_path", data, "--n_epochs", "2"]
    f0_path = os.path.join(data, "f0_stats.pkl")
    rows, dirs = {}, {}
    for name, cli, extra in (("len", train_len, []),
                             ("f0_base", train_f0, ["--f0_path", f0_path, "--model_type", "base"]),
                             ("f0_new", train_f0, ["--f0_path", f0_path, "--model_type", "new"])):
        step_ms, epoch_ms = [], []
        with timed_train_steps(step_ms), timed_calls(prosody_trainer, "_run_epoch", epoch_ms):
            t0 = time.perf_counter()
            dirs[name] = cli.main(common + extra + ["--out_path", os.path.join(root, name)])
            wall = time.perf_counter() - t0
        check(os.path.exists(os.path.join(dirs[name], "best_model.pth")), f"{name} best model")
        rows[name] = {"steps": len(step_ms), "ms_per_step_mean": float(np.mean(step_ms[1:])),
                      "ms_per_step_median": float(np.median(step_ms)),
                      "first_step_ms": step_ms[0], "train_epoch_ms": epoch_ms[0::2],
                      "val_epoch_ms": epoch_ms[1::2], "cli_wall_s": wall}
    spk = load_id_to_spkr(os.path.join(data, "id_to_spkr.pkl"))
    id2mean, id2std = prep_stats_arrays(spk, load_f0_stats(f0_path))
    converted = {}
    for pitch in ("f0_new", "f0_base"):
        conv = ProsodyConverter.load(N_PROSODY_SPEAKERS, dirs["len"], dirs[pitch],
                                     pitch.split("_")[1], id2mean, id2std, device=dev)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # truncations: the converter counts them
            out = conv.convert_records(val, spk, norm_pitch=False, batch_size=64)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(len(out) == len(val) and all(
            0 < len(r["units"]) == len(r["f0"]) and 0 <= min(r["units"]) and max(r["units"]) < 100
            and np.isfinite(r["f0"]).all() for r in out), f"{pitch}: converted val records")
        converted[pitch] = {"ms": ms, "truncations": conv.truncation_count,
                            "mean_units": float(np.mean([len(r["units"]) for r in out])),
                            "voiced_share": float(np.mean([np.mean(np.asarray(r["f0"]) > 0)
                                                           for r in out]))}
    print("train loop (b) prosody", json.dumps({"corpus_s": corpus_s, "trainers": rows,
                                                "convert_val": converted}), flush=True)


def _pre_bn_bias(model: torch.nn.Module, key: str) -> bool:
    """``cnnX.bias`` of a conv that feeds a BatchNorm: its gradient is 0 in
    exact arithmetic (the norm removes it), rounding noise in practice."""
    conv, _, leaf = key.partition(".")
    bn = {"cnn1": "bn1", "cnn2": "bn2", "cnn_class1": "bn_c1", "cnn_reg1": "bn_r1",
          **{f"cnn1{i}": f"bn1{i}" for i in range(1, 8)}}.get(conv)
    return leaf == "bias" and bn is not None and hasattr(model, bn)


ADAM_EPS = 1e-8  # torch.optim.Adam's default, as the trainers build it
# A card gradient may lie at most this many times as far from the float64
# step's as the CPU's float32 gradient lies, per tensor.  Sound card steps
# read up to 1.9 and the TF32 control's worst tensor at least 186 (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md §6), so 8 leaves a factor of 4 above the
# one and of 23 below the other.
GRAD_ERR_FACTOR = 8.0


def _prosody_train_step(name: str, model: torch.nn.Module, arrays: tuple, stats: tuple,
                        d: torch.device, dtype: torch.dtype, lr: float) -> tuple:
    """One Adam step of a copy of ``model`` on ``d`` in ``dtype``: the loss,
    the updated state and the gradients, on the host."""
    m = copy.deepcopy(model).to(d, dtype)
    opt = torch.optim.Adam(m.parameters(), lr=lr, eps=ADAM_EPS)
    vals, target, spk_ids = prosody_trainer._device_batch(arrays, d)
    if name == "len":
        step, _ = prosody_trainer.make_len_steps(m, (4.0, 2.0), opt)
    else:
        step, _ = prosody_trainer.make_pitch_steps(m, *(a.to(d, dtype) for a in stats), opt)
    metrics = step(vals, target.to(dtype), spk_ids)
    return (float(metrics["Loss" if name == "len" else "loss"]),
            {k: v.detach().cpu() for k, v in m.state_dict().items()},
            {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()})


@contextlib.contextmanager
def card_math(deterministic: bool, tf32: bool = False):
    """cuDNN pinned to deterministic algorithms or left to its heuristics
    (as the trainers run), with TF32 off or (the control) on."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=deterministic, allow_tf32=tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _grad_readings(model, ref_g: dict, cpu_g: dict, g: dict) -> dict:
    """Per parameter tensor, how many times as far from the float64
    gradient ``g`` lies as the CPU's float32 gradient does (max abs error,
    less 1e-6 of the tensor's largest float64 entry); a conv bias that feeds
    a BatchNorm, whose gradient is 0 in exact arithmetic, is left out."""
    out = {}
    for k, ref in ref_g.items():
        if _pre_bn_bias(model, k):
            continue
        excess = max(float((g[k] - ref).abs().max()) - 1e-6 * float(ref.abs().max()), 0.0)
        e_cpu = float((cpu_g[k] - ref).abs().max())
        out[k] = excess / e_cpu if e_cpu else (0.0 if excess == 0 else float("inf"))
    return out


def _param_agreement(before: dict, cpu: tuple, card: tuple, lr: float) -> dict:
    """Adam's first step moves each parameter by about lr times the sign of
    its gradient.  Where the card's and the CPU's float32 gradients share a
    sign and both exceed 100 x Adam's eps, the two updated parameters must
    agree to atol 1e-5; elsewhere (a sign that float32 rounding flips) each
    may only have moved within lr."""
    (_, cpu_sd, cpu_g), (_, card_sd, card_g) = cpu, card
    row = {"held_entries": 0, "free_entries": 0, "held_max_abs_err": 0.0,
           "free_max_move": 0.0, "running_stats_max_abs_err": 0.0}
    for k, v in cpu_sd.items():
        if k not in cpu_g:  # buffers: running statistics, num_batches_tracked
            err = float((card_sd[k] - v).abs().max()) if v.is_floating_point() else (
                0.0 if torch.equal(card_sd[k], v) else float("inf"))
            row["running_stats_max_abs_err"] = max(row["running_stats_max_abs_err"], err)
            continue
        a, b = cpu_g[k], card_g[k]
        held = (torch.sign(a) == torch.sign(b)) & (torch.minimum(a.abs(), b.abs())
                                                   >= 100 * ADAM_EPS)
        row["held_entries"] += int(held.sum())
        row["free_entries"] += int((~held).sum())
        if held.any():
            row["held_max_abs_err"] = max(row["held_max_abs_err"],
                                          float((card_sd[k] - v).abs()[held].max()))
        if (~held).any():
            move = torch.maximum((v - before[k]).abs(), (card_sd[k] - before[k]).abs())
            row["free_max_move"] = max(row["free_max_move"], float(move[~held].max()))
    return row


def prosody_step_card_vs_cpu(root: str, dev: torch.device) -> dict:
    """(c) one rhythm and one pitch ("new", PE dropout 0) train step, masking
    0, from the same weights on two batches of 32 val records: on the CPU in
    float64 (the reference), on the CPU in float32, and on the card three
    ways: cuDNN pinned to deterministic algorithms, cuDNN left to its
    heuristics as the trainers run (the two pick different convolution
    algorithms), and the control, TF32 on.

    Losses card vs CPU rtol 1e-4; running statistics atol 1e-5; updated
    parameters as :func:`_param_agreement` says.  Gradients: the loss is a
    sum over the batch, and the pitch model's gradients lose up to ~1e-2 of
    their largest entry to float32 rounding on the CPU as on the card, so
    each card tensor is held to ``GRAD_ERR_FACTOR`` times the CPU's error
    against float64 (:func:`_grad_readings`), and the TF32 control must
    break that limit, which shows the check can fail."""
    lr, cfg = 3e-4, ProsodyConfig(len_masking_rate=0.0, pitch_masking_rate=0.0)
    from dissc_tpu_torch.data.datasets import LenDataset, PitchDataset

    data = os.path.join(root, "units")
    spk = load_id_to_spkr(os.path.join(data, "id_to_spkr.pkl"))
    f0_stats = load_f0_stats(os.path.join(data, "f0_stats.pkl"))
    lens_ds = LenDataset.from_file(os.path.join(data, "val.txt"), spk)
    pitch_ds = PitchDataset.from_file(os.path.join(data, "val.txt"), spk, f0_stats)
    stats = tuple(torch.from_numpy(a) for a in prep_stats_arrays(spk, f0_stats))
    cpu = torch.device("cpu")
    rows, failures = {}, []
    for name in ("len", "pitch"):
        if name == "len":
            model = LenPredictor(n_speakers=len(spk), masking_rate=0.0, generator=generator_for(3))
        else:
            model = build_pitch_model("new", 100, len(spk), cfg, generator=generator_for(4))
            model.pe.dropout = 0.0
        before = {k: v.clone() for k, v in model.state_dict().items()}
        for b, rec in enumerate((slice(0, 32), slice(32, 64))):
            ds = lens_ds if name == "len" else pitch_ds
            arrays = (ds.vals[rec], ds.lens[rec] if name == "len" else ds.fs[rec],
                      ds.spk_ids[rec])
            step = functools.partial(_prosody_train_step, name, model, arrays, stats, lr=lr)
            ref, on_cpu = step(cpu, torch.float64), step(cpu, torch.float32)
            with card_math(deterministic=True):
                pinned = step(dev, torch.float32)
            with card_math(deterministic=False):
                heuristic = step(dev, torch.float32)
            with card_math(deterministic=False, tf32=True):
                control = step(dev, torch.float32)
            for tag, card in (("pinned", pinned), ("heuristic", heuristic),
                              ("tf32_control", control)):
                readings = _grad_readings(model, ref[2], on_cpu[2], card[2])
                worst = max(readings, key=readings.get)
                row = {"loss_cpu64": ref[0], "loss_cpu": on_cpu[0], "loss_card": card[0],
                       "loss_rel_err": abs(card[0] - on_cpu[0]) / abs(on_cpu[0]),
                       "grad_err_cpu_rel": max(float((on_cpu[2][k] - r).abs().max()
                                                     / r.abs().max()) for k, r in ref[2].items()
                                               if not _pre_bn_bias(model, k)),
                       "grad_reading_worst": readings[worst], "grad_reading_worst_at": worst,
                       "grad_readings_over_1": {k: v for k, v in readings.items() if v > 1},
                       **_param_agreement(before, on_cpu, card, lr)}
                rows[f"{name}/batch{b}/{tag}"] = row
                what = f"{name} batch {b} {tag}"
                if tag == "tf32_control":
                    if row["grad_reading_worst"] <= GRAD_ERR_FACTOR:
                        failures.append(f"{what}: the TF32 step passes the gradient check")
                    continue
                for ok, msg in ((row["loss_rel_err"] <= 1e-4, "loss"),
                                (row["running_stats_max_abs_err"] <= 1e-5, "running stats"),
                                (row["grad_reading_worst"] <= GRAD_ERR_FACTOR, "gradients"),
                                (row["held_max_abs_err"] <= 1e-5, "parameters"),
                                (row["free_max_move"] <= lr + 1e-6, "moves")):
                    failures += [] if ok else [f"{what}: {msg}"]
    print("train loop (c) prosody steps", json.dumps(rows), flush=True)
    check(not failures, f"prosody train steps card vs CPU: {failures}")
    return {k: {"loss_rel_err": r["loss_rel_err"], "grad_reading_worst": r["grad_reading_worst"],
                "free_entries": r["free_entries"]} for k, r in rows.items()}


def vocoder_loop_card_vs_cpu(root: str, dev: torch.device) -> float:
    """(c) two ``train_vocoder`` steps of a small config on the CPU and on the
    card, from the same seed over the same crops: losses rtol 1e-3 (AdamW's
    first update is about lr * sign(grad), as in ``train_reference_check``)."""
    small = os.path.join(root, "small")
    os.makedirs(small)
    manifests = write_vocoder_corpus(small, n=4, n_val=2, seconds=(0.05, 0.2), seed=15)
    config = write_vocoder_config(small, manifests, upsample_initial_channel=32, embedding_dim=8,
                                  model_in_dim=17, segment_size=1280, batch_size=2,
                                  mpd_periods=[2, 3], msd_scales=2)
    h = VocoderConfig.from_json(config)
    runs = []
    for i, d in enumerate(("cpu", dev)):
        metrics = []
        with recorded_steps(metrics):
            vocoder_trainer.train_vocoder(h, os.path.join(small, f"ckpt_{i}"), training_steps=2,
                                          device=d)
        runs.append([{k: float(v) for k, v in m.items()} for m in metrics])
    worst = 0.0
    for cpu_m, card_m in zip(*runs):
        for k, ref in cpu_m.items():
            worst = max(worst, abs(card_m[k] - ref) / max(abs(ref), 1e-6))
            check(abs(card_m[k] - ref) <= 1e-3 * abs(ref) + 1e-5,
                  f"train_vocoder {k}: card {card_m[k]} vs CPU {ref}")
    check(len(runs[1]) == 2, "two small train_vocoder steps")
    return worst


def train_loop_phase(h: VocoderConfig, dev: torch.device) -> int:
    """Phase 6; returns K1's launches over the vocoder loop's two runs."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        launches = vocoder_loop(h, root, dev)
        t1 = time.perf_counter()
        prosody_loop(root, dev)
        t2 = time.perf_counter()
        steps = prosody_step_card_vs_cpu(root, dev)
        voc_worst = vocoder_loop_card_vs_cpu(root, dev)
        print("train loop (c) card vs CPU", json.dumps({
            "prosody_steps": steps, "train_vocoder_worst_relative_loss_error": voc_worst}),
            flush=True)
        print(f"train loop: vocoder {t1 - t0:.1f} s, prosody {t2 - t1:.1f} s, "
              f"card vs CPU {time.perf_counter() - t2:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 7. convert + eval: data prep, conversion and the paper's metrics, through the CLIs
# ---------------------------------------------------------------------------

CE_SPEAKERS = {"p231": 6, "p239": 13, "p245": 18, "p270": 43}  # convert_eval --data vctk
CE_SEQS = (1, 25)  # 001 falls in the paired val split (<= 24); 025 in train (the f0 stats)
CE_N_SPEAKERS = 107
CE_SENTENCES = ("Please call Stella.", "Ask her.", "Bring these things.", "Snow peas.")


def _crc(data: bytes, poly: int, bits: int) -> int:
    crc, top, mask = 0, 1 << (bits - 1), (1 << bits) - 1
    for byte in data:
        crc ^= byte << (bits - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
    return crc


def write_flac16(path: str, x: np.ndarray, sr: int, block: int = 4096) -> None:
    """Mono 16-bit FLAC of verbatim subframes (VCTK's ground truth is FLAC):
    STREAMINFO, then frames of ``block`` samples, each with its header
    CRC-8 and frame CRC-16."""
    pcm = np.round(np.clip(np.asarray(x, np.float64), -1, 1) * 32767).astype(">i2")
    n = len(pcm)
    check(n <= 127 * block, "write_flac16: one-byte frame numbers")
    info = (block.to_bytes(2, "big") * 2 + b"\0" * 6
            + ((sr << 44) | (15 << 36) | n).to_bytes(8, "big") + b"\0" * 16)
    out = [b"fLaC", bytes([0x80, 0, 0, 34]), info]
    for k, start in enumerate(range(0, n, block)):
        chunk = pcm[start:start + block]
        head = bytes([0xFF, 0xF8, 0x70, 0x08, k]) + (len(chunk) - 1).to_bytes(2, "big")
        frame = head + bytes([_crc(head, 0x07, 8)]) + b"\x02" + chunk.tobytes()
        out.append(frame + _crc(frame, 0x8005, 16).to_bytes(2, "big"))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_vctk_corpus(root: str, seconds=(2.0, 5.0), seed: int = 15) -> list:
    """``raw/<spk>/<spk>_<seq>_mic2.wav`` at 48 or 22.05 kHz (``seconds`` long,
    from the voiced-stretch probe: tones at known f0 between noise and
    silence) and ``data/VCTK/txt/<spk>/<spk>_<seq>.txt`` for the four
    speakers and ``CE_SEQS``; returns the stems."""
    rng = np.random.default_rng(seed)
    stems = []
    for i, spk in enumerate(CE_SPEAKERS):
        os.makedirs(f"{root}/raw/{spk}")
        os.makedirs(f"{root}/data/VCTK/txt/{spk}")
        for j, seq in enumerate(CE_SEQS):
            sr = (48000, 22050)[(i + j) % 2]
            # a window of the 10 s probe that opens 0.3 s before a voiced stretch
            start = max(0.0, STRETCHES[int(rng.integers(len(STRETCHES)))][0] - 0.3)
            dur = float(rng.uniform(*seconds))
            x = voiced_stretches(sr, seed=int(rng.integers(1 << 30)))[
                int(start * sr):int((start + dur) * sr)]
            write_wav(f"{root}/raw/{spk}/{spk}_{seq:03}_mic2.wav", x * 0.8, sr)
            with open(f"{root}/data/VCTK/txt/{spk}/{spk}_{seq:03}.txt", "w") as f:
                f.write(CE_SENTENCES[(i + j) % len(CE_SENTENCES)] + "\n")
            stems.append(f"{spk}_{seq:03}")
    return stems


def write_reference_grid(path: str, transcript: str, dur: float) -> None:
    """The aligner's output for a ground-truth recording (MFA is not
    installed): the transcript's words spread evenly over ``dur`` seconds,
    with pauses at both ends and after the first word, and two phones a
    word, as a long TextGrid that ``eval.textgrid`` reads."""
    from dissc_tpu_torch.eval.align import grid_to_text
    from dissc_tpu_torch.eval.textgrid import Interval

    with open(transcript) as f:
        words = f.read().split()
    marks = [""] + words[:1] + [""] + words[1:] + [""]
    edges = np.linspace(0.0, dur, len(marks) + 1)
    word_tier = [Interval(float(a), float(b), m) for a, b, m in zip(edges, edges[1:], marks)]
    phone_tier = []
    for iv in word_tier:
        mid = (iv.minTime + iv.maxTime) / 2
        phone_tier += ([Interval(iv.minTime, iv.maxTime, "")] if not iv.mark else
                       [Interval(iv.minTime, mid, iv.mark[:1].upper()),
                        Interval(mid, iv.maxTime, iv.mark[1:2].upper() or "AH")])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(grid_to_text([("words", word_tier), ("phones", phone_tier)], dur))


def write_whisper_dir(path: str, cfg, seed: int = 18) -> None:
    """A local HF Whisper directory: ``config.json``, ``pytorch_model.bin``
    (weights N(0, 0.02) from a seed) and a synthetic byte-level tokenizer of
    the config's size: 256 byte symbols and made-up merges up to
    ``<|endoftext|>``, then medium.en's 1,607 added tokens (start of
    transcript, 99 language tags, the task tokens, ``<|notimestamps|>``,
    1,501 timestamps)."""
    from dissc_tpu_torch.models.whisper import init_state_dict
    from dissc_tpu_torch.models.whisper_files import bytes_to_unicode

    os.makedirs(path)
    hf = {"model_type": "whisper", "vocab_size": cfg.vocab_size,
          "num_mel_bins": cfg.num_mel_bins, "d_model": cfg.d_model,
          "encoder_layers": cfg.encoder_layers, "decoder_layers": cfg.decoder_layers,
          "encoder_attention_heads": cfg.num_heads, "decoder_attention_heads": cfg.num_heads,
          "encoder_ffn_dim": cfg.ffn_dim, "decoder_ffn_dim": cfg.ffn_dim,
          "max_source_positions": cfg.max_source_positions,
          "max_target_positions": cfg.max_target_positions}
    with open(f"{path}/config.json", "w") as f:
        json.dump(hf, f)
    torch.save(init_state_dict(cfg, torch.Generator().manual_seed(seed)),
               f"{path}/pytorch_model.bin")
    tasks = ["<|startoftranscript|>"] + [f"<|l{i:02d}|>" for i in range(99)] + [
        "<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
        "<|nocaptions|>", "<|notimestamps|>"]
    added_tokens = tasks + [f"<|{0.02 * i:.2f}|>" for i in range(1501)]
    n_vocab = cfg.vocab_size - len(added_tokens)  # <|endoftext|> is the last of these
    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    rng = np.random.default_rng(seed)
    letters = [b2u[b] for b in range(ord("a"), ord("z") + 1)]
    while len(vocab) < n_vocab - 1:
        word = "".join(rng.choice(letters, int(rng.integers(2, 8))))
        vocab.setdefault((b2u[ord(" ")] if rng.random() < 0.6 else "") + word, len(vocab))
    vocab["<|endoftext|>"] = n_vocab - 1
    with open(f"{path}/vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(f"{path}/added_tokens.json", "w") as f:
        json.dump({t: n_vocab + i for i, t in enumerate(added_tokens)}, f)
    with open(f"{path}/special_tokens_map.json", "w") as f:
        json.dump({"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>", "additional_special_tokens": tasks}, f)


def write_convert_checkpoints(root: str, h: VocoderConfig, hub_cfg, dev: torch.device,
                              seed: int = 16) -> None:
    """Every file ``convert_eval --data vctk`` and ``encode`` read, from seeds:
    HuBERT in the JAX layout and a 100-unit codebook (k-means++ starts: 100
    of the corpus' own frames, ``models/``), the rhythm and "base" pitch
    models at ``ProsodyConfig()`` widths (``checkpoints/vctk/{len,pitch}``),
    the generator (``checkpoints/vctk_vocoder``; weight-norm gains 1 and
    biases 0, so that its waveform follows the conditioning), and the 107-speaker
    ``id_to_spkr.pkl`` with the four speakers at convert_eval's ids."""
    from dissc_tpu_torch.compat import to_jax
    from dissc_tpu_torch.core.wav import read_wav
    from dissc_tpu_torch.models import hubert
    from dissc_tpu_torch.models.hifigan import CodeGenerator
    from dissc_tpu_torch.train.checkpoints import save_checkpoint

    g = torch.Generator().manual_seed(seed)
    hub_sd = hubert.init_state_dict(hub_cfg, g)
    save_checkpoint(f"{root}/models/hubert.pkl", to_jax.hubert_params(hub_sd, hub_cfg))
    encoder = SpeechUnitEncoder(hub_sd, np.zeros((1, hub_cfg.hidden_size), np.float32), hub_cfg,
                                device=dev)
    wav_dir = f"{root}/data/VCTK/wav"
    with torch.inference_mode():
        feats = np.concatenate([
            encoder.model(torch.as_tensor(read_wav(f"{wav_dir}/{n}", "float32")[0][None],
                                          device=dev))[0].cpu().numpy()
            for n in sorted(os.listdir(wav_dir)) if n.endswith(".wav")])
    rng = np.random.default_rng(seed)
    np.save(f"{root}/models/km100.npy", feats[rng.choice(len(feats), 100, replace=False)])

    os.makedirs(f"{root}/data/VCTK/hubert100", exist_ok=True)
    names = [f"s{i:03d}" for i in range(CE_N_SPEAKERS)]
    for spk, i in CE_SPEAKERS.items():
        names[i] = spk
    with open(f"{root}/data/VCTK/hubert100/id_to_spkr.pkl", "wb") as f:
        pickle.dump(names, f)
    len_model = LenPredictor(n_tokens=100, n_speakers=CE_N_SPEAKERS, generator=g)
    save_checkpoint(f"{root}/checkpoints/vctk/len/best_model.pth",
                    to_jax.len_predictor_variables(len_model.state_dict()))
    save_checkpoint(f"{root}/checkpoints/vctk/len/len_norm_stats.pth", (2.0, 0.5))
    pitch = build_pitch_model("base", 100, CE_N_SPEAKERS, generator=g)
    save_checkpoint(f"{root}/checkpoints/vctk/pitch/best_model.pth",
                    to_jax.pitch_predictor_variables(pitch.state_dict()))
    gen = CodeGenerator(h, generator=generator_for(seed))
    with torch.no_grad():  # at the init's gains (~0.1) the waveform is its last bias, a constant
        for name, p in gen.named_parameters():
            if name.endswith("weight_g"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
    save_checkpoint(f"{root}/checkpoints/vctk_vocoder/g_00000000",
                    {"generator": to_jax.generator_tree(gen.state_dict(), h)})
    with open(f"{root}/checkpoints/vctk_vocoder/config.json", "w") as f:
        json.dump(dict(h.to_dict(), input_training_file="data/VCTK/hubert100/train.txt"), f)


def prepare_vctk(root: str, h: VocoderConfig, hub_cfg, whisper_cfg, dev: torch.device,
                 seconds=(2.0, 5.0), workers: int = 2, model_ms: Optional[list] = None) -> list:
    """The VCTK-shaped tree that ``convert_eval`` and ``convert_eval_sv``
    read, in ``root``: the corpus through ``cli.preprocess --trim --pad``
    (FLAC ground truth and its reference grids beside it), every checkpoint
    (and, given ``whisper_cfg``, a Whisper directory; their writing time
    appended to ``model_ms``), ``cli.encode`` and ``cli.prep_dataset
    --split_method paired_val``, with f0 stats for all 107 speakers.
    Returns the stems."""
    from dissc_tpu_torch.cli import encode, prep_dataset, preprocess
    from dissc_tpu_torch.core.wav import read_wav

    device = ["--device", str(dev)]
    stems = write_vctk_corpus(root, seconds)
    with contextlib.chdir(root):
        preprocess.main(["--srcdir", "raw", "--outdir", "data/VCTK/wav", "--trim", "--pad",
                         "--workers", str(workers)] + device)
        for stem in stems:  # the ground truth as VCTK ships it, FLAC
            x, sr = read_wav(f"data/VCTK/wav/{stem}_mic2.wav", "float32")
            write_flac16(f"data/VCTK/wav/{stem}_mic2.flac", x, sr)
            write_reference_grid(f"results/vctk/orig/txtgrid/{stem}.TextGrid",
                                 f"data/VCTK/txt/{stem.split('_')[0]}/{stem}.txt", len(x) / sr)
        t0 = time.perf_counter()
        write_convert_checkpoints(".", h, hub_cfg, dev)
        if whisper_cfg is not None:
            write_whisper_dir("models/whisper", whisper_cfg)
        if model_ms is not None:
            model_ms.append(1e3 * (time.perf_counter() - t0))
        n_enc = encode.main(["--base_dir", "data/VCTK/wav", "--out_file",
                             "data/VCTK/hubert100/all.txt", "--hubert_weights",
                             "models/hubert.pkl", "--kmeans_codebook", "models/km100.npy"]
                            + device)
        check(n_enc == len(stems), f"encode wrote {n_enc} of {len(stems)} records (and skipped "
                                   "the FLAC files)")
        prep_dataset.main(["--encoded_path", "data/VCTK/hubert100/all.txt", "--stats_path",
                           "data/VCTK/hubert100/f0_stats.pkl", "--split_method",
                           "paired_val"] + device)
        # the rest of the 107-speaker table: a real corpus has their recordings
        stats = load_f0_stats("data/VCTK/hubert100/f0_stats.pkl")
        check(sorted(stats) == sorted(CE_SPEAKERS), f"f0 stats of {sorted(stats)}")
        for name in load_id_to_spkr("data/VCTK/hubert100/id_to_spkr.pkl"):
            stats.setdefault(name, {"mean": 150.0, "std": 20.0})
        with open("data/VCTK/hubert100/f0_stats.pkl", "wb") as f:
            pickle.dump(stats, f)
    return stems


def convert_eval_run(root: str, h: VocoderConfig, hub_cfg, whisper_cfg, dev: torch.device,
                     seconds=(2.0, 5.0), workers: int = 2) -> dict:
    """Data prep (:func:`prepare_vctk`) and ``cli.convert_eval --data vctk
    --dissc_type dissc_b --sort_gt --dtw_align --whisper_model`` in
    ``root``, on ``dev``, every stage timed; checks the outputs and returns
    the raw errors and the timings."""
    from dissc_tpu_torch.cli import convert_eval, encode, infer, prep_dataset, preprocess
    from dissc_tpu_torch.cli import sr_inference
    from dissc_tpu_torch.eval import align, asr, metrics
    from dissc_tpu_torch.models.whisper import WhisperTranscriber

    device = ["--device", str(dev)]
    timed = ((preprocess, "main", "preprocess"), (encode, "main", "encode"),
             (prep_dataset, "main", "prep_dataset"), (infer, "main", "infer"),
             (sr_inference, "main", "sr_inference"),
             (convert_eval, "restructure", "restructure"),
             (convert_eval, "sort_ground_truth", "sort_gt"),
             (align, "write_dtw_textgrids", "align"), (metrics, "calc_errors", "metrics"),
             (asr, "load_whisper", "load_whisper"), (metrics, "get_yaapt", "yaapt_per_file"),
             (align, "align_textgrid", "dtw_per_file"), (align, "dtw_path", "dtw_dp_per_file"),
             (WhisperTranscriber, "__call__", "transcribe_per_file"))
    log = {key: [] for _, _, key in timed}
    log["write_models"] = []
    with contextlib.ExitStack() as stack:
        for mod, name, key in timed:
            stack.enter_context(timed_calls(mod, name, log[key]))
        stems = prepare_vctk(root, h, hub_cfg, whisper_cfg, dev, seconds, workers,
                             log["write_models"])
        stack.enter_context(contextlib.chdir(root))
        errs = convert_eval.main(["--data", "vctk", "--dissc_type", "dissc_b", "--sort_gt",
                                  "--dtw_align", "--whisper_model", "models/whisper"] + device)

        val = [s for s in stems if int(s.split("_")[1]) <= 24]
        for trg in CE_SPEAKERS:
            for s in val:
                check(os.path.isfile(f"results/vctk/dissc_b/{trg}/{s}.wav"),
                      f"results/vctk/dissc_b/{trg}/{s}.wav")
        pairs = [(trg, s) for trg in CE_SPEAKERS for s in val if not s.startswith(trg)]
        grids = [f"results/vctk/dissc_b/{t}/txtgrid/{s}.TextGrid" for t, s in pairs]
        check(all(os.path.isfile(p) for p in grids), "a DTW TextGrid for every pair")
    with open(f"{root}/results/vctk/dissc_b_results.pkl", "rb") as f:
        saved = pickle.load(f)
    for key in ("len", "emd", "w_len", "p_len"):
        check(len(saved[key]) == len(pairs) and bool(np.all(np.isfinite(saved[key]))),
              f"{len(saved[key])} finite '{key}' entries for {len(pairs)} pairs")
    kept = ffe_kept(f"{root}/results/vctk", pairs)
    for key, tier in (("w_ffe", 0), ("p_ffe", 1)):
        check(len(saved[key]) == kept[tier] and bool(np.all(np.isfinite(saved[key]))),
              f"{len(saved[key])} finite '{key}' entries, where the pairs whose DTW intervals "
              f"all hold a 5 ms f0 frame are {kept[tier]}")
    check(saved["wer_d"] > 0 and saved["cer_d"] > 0, "WER/CER denominators")
    check(len(log["transcribe_per_file"]) == len(pairs), "Whisper transcribed every pair")
    check(len(log["sr_inference"]) == len(CE_SPEAKERS), "sr_inference once a target")
    return {"errs": errs, "log": log, "pairs": len(pairs), "stems": stems, "ffe_kept": kept}


def ffe_kept(base: str, pairs: list) -> tuple:
    """How many pairs the FFE of each tier (words, phones) keeps.  As in the
    reference (``eval.py:106-129``), an utterance drops out of a tier's FFE
    when one of its synthetic intervals holds no 5 ms f0 frame (the slice
    ``int(t * 200 + 2)`` of the contour, zero-padded to the reference's
    length, is empty and ``interp`` raises): a DTW warp that is flat across
    an interval, which random weights give often."""
    from dissc_tpu_torch.core.wav import read_wav
    from dissc_tpu_torch.eval.textgrid import TextGrid

    kept = [0, 0]
    for trg, stem in pairs:
        frames = [round(len(read_wav(p, "float32")[0]) / 80) for p in (
            f"{base}/dissc_b/{trg}/{stem}.wav", f"{base}/orig/{trg}_{stem.split('_')[1]}.wav")]
        n = max(frames)  # calc_errors pads the synthetic contour up to the reference's
        grid = TextGrid.fromFile(f"{base}/dissc_b/{trg}/txtgrid/{stem}.TextGrid")
        for tier in (0, 1):
            kept[tier] += all(min(int(iv.maxTime * 200 + 2), n) > int(iv.minTime * 200 + 2)
                              for iv in grid[tier] if iv.mark)
    return tuple(kept)


def whisper_timing(model_dir: str, dev: torch.device, seed: int = 19) -> dict:
    """Whisper from ``model_dir`` (medium.en in phase 7) on the card:
    ``transcribe_batch`` of 1 and of 8 noise clips of 30 s, the encoder
    alone on the same log-mel, and the decoder's ms a token (the batch's
    time less the encoder's, over the ``n_init + max_len - 1`` steps)."""
    from dissc_tpu_torch.eval.asr import load_whisper
    from dissc_tpu_torch.models import whisper as tw

    transcriber = load_whisper(model_dir, dev)
    steps = len(transcriber.initial_tokens) + transcriber.max_len - 1
    rng = np.random.default_rng(seed)
    out = {}
    for b in (1, 8):
        wavs = list((rng.standard_normal((b, tw.CHUNK_SAMPLES)) * 0.1).astype(np.float32))
        mel = tw.log_mel_spectrogram(torch.as_tensor(np.stack(wavs), device=dev))
        enc_ms, batch_ms = [], []
        for _ in range(2):  # the first is warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                tw.encode(transcriber.model, mel)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            texts = transcriber.transcribe_batch(wavs)
            enc_ms.append(1e3 * (t1 - t0))
            batch_ms.append(1e3 * (time.perf_counter() - t1))
        check(len(texts) == b, f"transcribe_batch of {b} gave {len(texts)} texts")
        out[f"batch_{b}"] = {"encoder_ms": enc_ms[-1], "transcribe_batch_ms": batch_ms[-1],
                             "decode_ms_per_token": (batch_ms[-1] - enc_ms[-1]) / steps}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del transcriber
    torch.cuda.empty_cache()
    return out


def convert_eval_card_vs_cpu(root: str, dev: torch.device) -> dict:
    """(c) on small inputs: ``run_inference`` waveforms, ``calc_errors`` on
    phase 7's results tree (with the uniform fallback grids), Whisper
    encoder states and greedy tokens at a reduced config."""
    from dissc_tpu_torch.core.wav import read_wav
    from dissc_tpu_torch.eval import metrics
    from dissc_tpu_torch.infer import vocoder as tvoc
    from dissc_tpu_torch.models import whisper as tw

    out = {}
    with contextlib.chdir(root):
        with open("data/VCTK/hubert100/val.txt") as f:
            lines = [json.loads(line) for line in f][:2]
        with open("small.txt", "w") as f:
            for rec in lines:
                f.write(json.dumps(dict(rec, units=rec["units"][:25], f0=rec["f0"][:25])) + "\n")
        waves = {}
        for d in (dev, "cpu"):
            got = waves[str(d)] = {}
            real = tvoc.write_wav

            def capture(path, data, sr, got=got, real=real):
                got[os.path.basename(path)] = np.asarray(data)
                real(path, data, sr)

            tvoc.write_wav = capture
            try:
                tvoc.run_inference("checkpoints/vctk_vocoder", "small.txt", f"small_{d}",
                                   data_path="data/VCTK/wav", vc=True, target_speakers=["p245"],
                                   device=d)
            finally:
                tvoc.write_wav = real
        a, b = waves[str(dev)], waves["cpu"]
        out["run_inference_files"] = sorted(a)
        out["run_inference_max_abs_err"] = (
            max(float(np.abs(a[k] - b[k]).max()) for k in a)
            if sorted(a) == sorted(b) and all(a[k].shape == b[k].shape for k in a)
            else float("inf"))
        # scored without the DTW grids, on the uniform fallback grids, whose
        # intervals all hold f0 frames: FFE runs for every pair
        shutil.copytree("results/vctk", "results_uniform",
                        ignore=lambda d, names: ["txtgrid"] if "dissc_b" in d else [])
        errs = {str(d): metrics.calc_errors("results_uniform", "dissc_b", list(CE_SPEAKERS),
                                            device=d) for d in (dev, "cpu")}
        # YAAPT card vs CPU file by file, to say where calc_errors differs
        yaapt_diff = {}
        for path in sorted(glob.glob("results_uniform/*/*.wav") +
                           glob.glob("results_uniform/dissc_b/*/*.wav")):
            x, sr = read_wav(path, "float32")
            a, b = (metrics.get_yaapt(x, sr, device=d) for d in (dev, "cpu"))
            voicing = int(np.sum((a > 0) != (b > 0)))
            both = (a > 0) & (b > 0)
            rel = float(np.max(np.abs(a - b)[both] / b[both])) if both.any() else 0.0
            if voicing or rel > 1e-4:
                yaapt_diff[path] = {"frames": len(a), "voicing_differs": voicing,
                                    "voiced_f0_max_rel": rel}
        out["yaapt_files_that_differ"] = yaapt_diff
    e, c = errs[str(dev)], errs["cpu"]
    out["calc_errors_ffe_entries"] = [len(e["w_ffe"]), len(e["p_ffe"])]
    out["calc_errors_len_equal"] = e["len"] == c["len"]
    out["calc_errors_emd_max_abs_diff"] = float(np.max(np.abs(np.subtract(e["emd"], c["emd"]))))
    out["calc_errors_ffe_equal"] = e["w_ffe"] == c["w_ffe"] and e["p_ffe"] == c["p_ffe"]
    out["calc_errors_durations_equal"] = e["w_len"] == c["w_len"] and e["p_len"] == c["p_len"]

    cfg = tw.WhisperConfig(vocab_size=1000, d_model=256, encoder_layers=4, decoder_layers=4,
                           num_heads=4, ffn_dim=1024)
    g = torch.Generator().manual_seed(20)
    sd = tw.init_state_dict(cfg, g)
    for k in sd:  # wider than N(0, 0.02), so the greedy tokens vary and have clear winners
        if k.endswith("weight") and "layer_norm" not in k:
            sd[k] = sd[k] * (50.0 if "embed_tokens" in k else 100.0 if "embed_positions" in k
                             else 300.0 / sd[k].shape[1] ** 0.5)
    rng = np.random.default_rng(21)
    wav = (rng.standard_normal((2, tw.CHUNK_SAMPLES)) * 0.1).astype(np.float32)
    res = {}
    for d in (dev, "cpu"):
        model = tw.build(sd, cfg, torch.device(d))
        mel = tw.log_mel_spectrogram(torch.as_tensor(wav, device=d))
        with torch.inference_mode():
            enc = tw.encode(model, mel).cpu()
        res[str(d)] = (enc, tw.greedy_decode(model, mel, [1, 2], 999, 32).cpu())
    (ea, ta), (eb, tb) = res[str(dev)], res["cpu"]
    out["whisper_encoder_max_abs_err"] = float((ea - eb).abs().max())
    out["whisper_tokens_equal"] = bool(torch.equal(ta, tb))
    out["whisper_distinct_tokens"] = int(len(torch.unique(ta)))
    return out


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def convert_eval_phase(h: VocoderConfig, dev: torch.device, root: str) -> None:
    """Phase 7 at full width in ``root`` (which phase 8 reads next):
    HuBERT-base (layer 6), ``ProsodyConfig()``, ``VocoderConfig()``, Whisper
    medium.en, weights from seeds."""
    from dissc_tpu_torch.models.whisper import WhisperConfig

    smi = card_name()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = convert_eval_run(root, h, HubertConfig(), WhisperConfig(), dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log = run["log"]
    stage = {k: float(np.sum(log[k])) for k in ("preprocess", "encode", "prep_dataset",
                                                "write_models", "infer", "sr_inference",
                                                "restructure", "sort_gt", "align",
                                                "metrics", "load_whisper")}
    per_file = {k: log[k] for k in ("yaapt_per_file", "dtw_per_file", "dtw_dp_per_file",
                                    "transcribe_per_file")}
    errs = run["errs"]
    print("convert+eval (b) convert_eval", json.dumps({
        "card": smi, "pairs": run["pairs"], "utterances": len(run["stems"]),
        "ffe_kept_words_phones": run["ffe_kept"],
        "stage_ms": stage, "per_file_ms": per_file, "phase_wall_s": wall,
        "peak_gib": peak, "wer": errs["wer_s"] / max(errs["wer_d"], 1),
        "cer": errs["cer_s"] / max(errs["cer_d"], 1), "emd": errs["emd"],
        "len": errs["len"], "w_ffe": errs["w_ffe"], "p_ffe": errs["p_ffe"]}), flush=True)
    t1 = time.perf_counter()
    cmp = convert_eval_card_vs_cpu(root, dev)
    check(cmp["calc_errors_ffe_entries"] == [run["pairs"]] * 2,
          f"FFE on the uniform grids for every pair: {cmp['calc_errors_ffe_entries']}")
    print("convert+eval (c) card vs CPU", json.dumps(dict(cmp, card=smi,
          wall_s=time.perf_counter() - t1)), flush=True)
    torch.cuda.reset_peak_memory_stats()
    timing = whisper_timing(f"{root}/models/whisper", dev)
    shutil.rmtree(f"{root}/models/whisper")  # 3 GB that phase 8 does not read
    print("convert+eval (d) Whisper medium.en", json.dumps(dict(timing, card=smi)), flush=True)
    check(cmp["run_inference_max_abs_err"] <= 1e-4,
          f"run_inference waveforms card vs CPU: {cmp['run_inference_max_abs_err']}")
    check(cmp["calc_errors_len_equal"] and cmp["calc_errors_durations_equal"],
          "calc_errors lengths and durations card vs CPU")
    # EMD is 1-Lipschitz in the contours: YAAPT's 1e-4 relative on f0 under 400 Hz
    check(cmp["calc_errors_emd_max_abs_diff"] <= 0.04,
          f"calc_errors EMD card vs CPU: {cmp['calc_errors_emd_max_abs_diff']}")
    check(cmp["calc_errors_ffe_equal"], "calc_errors FFE card vs CPU")
    check(cmp["whisper_encoder_max_abs_err"] <= 1e-4,
          f"Whisper encoder card vs CPU: {cmp['whisper_encoder_max_abs_err']}")
    check(cmp["whisper_tokens_equal"] and cmp["whisper_distinct_tokens"] > 3,
          "Whisper greedy tokens card vs CPU")


# ---------------------------------------------------------------------------
# 8. speaker verification: convert_eval_sv over phase 7's tree, EER by ECAPA-TDNN
# ---------------------------------------------------------------------------


def write_sv_pairs(path: str, stems: list) -> list:
    """``speaker_verification.csv`` with a leading index column, as pandas'
    ``to_csv`` writes it: each val utterance converted to each other
    speaker, scored against the target's own train utterance (label 1) and
    against the next speaker's (label 0).  Returns the rows."""
    val = [s for s in stems if int(s.split("_")[1]) <= 24]
    refs = {s.split("_")[0]: s for s in stems if int(s.split("_")[1]) > 24}
    spk = list(CE_SPEAKERS)
    rows = []
    for sample in val:
        for trg in spk:
            if sample.startswith(trg):
                continue
            other = spk[(spk.index(trg) + 1) % len(spk)]
            rows += [dict(ref=refs[trg], syn_trgt=trg, syn_sample=sample, label="1"),
                     dict(ref=refs[other], syn_trgt=trg, syn_sample=sample, label="0")]
    with open(path, "w") as f:
        f.write(",ref,syn_trgt,syn_sample,label\n")
        f.writelines(f"{i},{r['ref']},{r['syn_trgt']},{r['syn_sample']},{r['label']}\n"
                     for i, r in enumerate(rows))
    return rows


def write_ecapa_checkpoint(path: str, seed: int = 22) -> None:
    """A speechbrain-keyed ECAPA-TDNN ``embedding_model.ckpt`` at
    ``EcapaConfig()`` width from a seed, with BatchNorm scales, shifts and
    running statistics away from their defaults."""
    from dissc_tpu_torch.models.ecapa import EcapaConfig, EcapaTDNN

    g = torch.Generator().manual_seed(seed)
    model = EcapaTDNN(EcapaConfig(), generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                n = m.num_features
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    torch.save(model.state_dict(), path)


def convert_eval_sv_run(root: str, dev: torch.device) -> dict:
    """``cli.convert_eval_sv --data vctk --dissc_type dissc_b
    --speechbrain_ckpt`` in ``root`` (a tree :func:`prepare_vctk` wrote),
    on ``dev``, every stage timed; checks the restructured files and that
    the EER is ``compute_eer`` of the scores recomputed from them.  Returns
    the EER, the scores, the rows and the timings."""
    from dissc_tpu_torch.cli import convert_eval_sv, eval_sv, infer, sr_inference
    from dissc_tpu_torch.eval import sv
    from dissc_tpu_torch.models.ecapa import (EcapaConfig, EcapaEmbedder,
                                              convert_speechbrain_state_dict)

    timed = ((infer, "main", "infer"), (sr_inference, "main", "sr_inference"),
             (convert_eval_sv, "restructure", "restructure"), (eval_sv, "main", "eer"),
             (eval_sv, "load_embedder", "load_ecapa"), (EcapaEmbedder, "__call__", "ecapa_per_file"))
    log = {key: [] for _, _, key in timed}
    with contextlib.chdir(root), contextlib.ExitStack() as stack:
        stems = sorted(f[:-len("_mic2.flac")] for f in os.listdir("data/VCTK/wav")
                       if f.endswith("_mic2.flac"))
        rows = write_sv_pairs("data/VCTK/speaker_verification.csv", stems)
        write_ecapa_checkpoint("models/embedding_model.ckpt")
        for mod, name, key in timed:
            stack.enter_context(timed_calls(mod, name, log[key]))
        eer = convert_eval_sv.main(["--data", "vctk", "--dissc_type", "dissc_b",
                                    "--speechbrain_ckpt", "models/embedding_model.ckpt",
                                    "--device", str(dev)])
        stack.close()
        syn = [f"results/vctk/sv/dissc_b/{r['syn_trgt']}/{r['syn_sample']}.wav" for r in rows]
        check(all(os.path.isfile(p) for p in syn), "a restructured file for every CSV row")
        check(os.path.isfile("results/vctk/speaker_verification.csv"), "the CSV beside results")
        check(eer is not None and 0.0 <= eer <= 1.0, f"EER {eer} in [0, 1]")
        sd = convert_speechbrain_state_dict(
            torch.load("models/embedding_model.ckpt", map_location="cpu", weights_only=True))
        score = sv.cosine_scorer(EcapaEmbedder(sd, EcapaConfig(), device=dev))
        scores = {0: [], 1: []}
        for r, path in zip(rows, syn):
            scores[int(r["label"])].append(score(f"data/VCTK/wav/{r['ref']}_mic2.flac", path))
        again = sv.compute_eer(np.asarray(scores[1]), np.asarray(scores[0]))[0]
        check(again == eer, f"EER {eer} is compute_eer of the recomputed scores ({again})")
        check(len(log["sr_inference"]) == len(CE_SPEAKERS), "sr_inference once a target")
        check(len(log["ecapa_per_file"]) == 2 * len(rows), "ECAPA on both files of each row")
    return {"eer": eer, "scores": scores, "rows": rows, "syn": syn, "log": log, "sd": sd}


def sv_card_vs_cpu(root: str, run: dict, dev: torch.device) -> dict:
    """ECAPA on the card against the CPU: the embeddings of 3 restructured
    files (relative to their largest entry) and their cosine scores."""
    from dissc_tpu_torch.core.wav import read_audio
    from dissc_tpu_torch.models.ecapa import EcapaConfig, EcapaEmbedder

    wavs = [read_audio(f"{root}/{p}", dtype="float32")[0] for p in run["syn"][:6:2]]
    emb = {str(d): np.stack([EcapaEmbedder(run["sd"], EcapaConfig(), device=d)(w)
                             for w in wavs]) for d in (dev, "cpu")}
    a, b = emb[str(dev)], emb["cpu"]

    def cos(e):
        n = e / np.linalg.norm(e, axis=1, keepdims=True)
        return n @ n.T

    return {"files": len(wavs),
            "embedding_max_rel_err": float(np.max(np.abs(a - b).max(1) / np.abs(b).max(1))),
            "cosine_max_abs_err": float(np.abs(cos(a) - cos(b)).max())}


def sv_phase(root: str, dev: torch.device) -> None:
    """Phase 8 at ``EcapaConfig()`` width over phase 7's tree."""
    smi = card_name()
    t0 = time.perf_counter()
    run = convert_eval_sv_run(root, dev)
    wall = time.perf_counter() - t0
    log = run["log"]
    print("speaker verification (a) convert_eval_sv", json.dumps({
        "card": smi, "rows": len(run["rows"]), "eer": run["eer"],
        "positive_scores": run["scores"][1], "negative_scores": run["scores"][0],
        "stage_ms": {k: float(np.sum(log[k])) for k in ("infer", "sr_inference",
                                                        "restructure", "load_ecapa", "eer")},
        "ecapa_ms_per_file": log["ecapa_per_file"], "phase_wall_s": wall}), flush=True)
    t1 = time.perf_counter()
    cmp = sv_card_vs_cpu(root, run, dev)
    print("speaker verification (b) card vs CPU", json.dumps(
        dict(cmp, card=smi, wall_s=time.perf_counter() - t1)), flush=True)
    check(cmp["embedding_max_rel_err"] <= 1e-4,
          f"ECAPA embeddings card vs CPU, relative {cmp['embedding_max_rel_err']}")
    check(cmp["cosine_max_abs_err"] <= 1e-5, f"cosine scores card vs CPU: "
                                             f"{cmp['cosine_max_abs_err']}")


# ---------------------------------------------------------------------------
# 9. F0-VQ and k-means: the quantizer trainer, the VQ CodeGenerator, a unit codebook
# ---------------------------------------------------------------------------

F0_SEGMENT = 8960  # 112 f0 frames at 200 Hz: 7 codes after the encoder's 16x


@contextlib.contextmanager
def recorded_quantizer_steps(log: list):
    """While open, every quantizer ``train_step`` appends its card time (ms,
    synchronised), its metrics and whether the codebook is initialised."""
    from dissc_tpu_torch.train import quantizer_trainer

    make = quantizer_trainer.make_quantizer_steps

    def recording_make(*args, **kw):
        train_step, eval_step = make(*args, **kw)

        def step(state, f0, generator=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train_step(state, f0, generator)
            torch.cuda.synchronize()
            initted = all(bool(b.initted) for b in state.model.vq.level_blocks)
            log.append(dict({k: float(v) for k, v in metrics.items()},
                            ms=1e3 * (time.perf_counter() - t0), initted=initted))
            return state, metrics

        return step, eval_step

    quantizer_trainer.make_quantizer_steps = recording_make
    try:
        yield log
    finally:
        quantizer_trainer.make_quantizer_steps = make


def quantizer_run(root: str, dev: torch.device, steps: int = 40, batch: int = 16,
                  interval: int = 20, params=None, segment: int = F0_SEGMENT) -> dict:
    """(a) + (b): ``F0Dataset`` over the 16 kHz corpus in ``root`` and
    ``train_f0_quantizer``, every step recorded; the last ``g_`` reloaded
    gives the trained model's eval reconstruction."""
    from dissc_tpu_torch.compat.from_jax import quantizer_state_dict
    from dissc_tpu_torch.data.code_dataset import F0Dataset
    from dissc_tpu_torch.models.vq import Quantizer
    from dissc_tpu_torch.train import quantizer_trainer as qt

    params = params or qt.DEFAULT_F0_PARAMS
    files = sorted(glob.glob(f"{root}/p*.wav"))
    ds = F0Dataset(files, segment, 16000, f0_device=dev)
    item = ds[0]
    check(item["f0"].shape == (segment // 80, 1) and item["audio"].shape == (segment,),
          f"F0Dataset item: f0 {item['f0'].shape}, audio {item['audio'].shape}")
    ds = F0Dataset(files, segment, 16000, f0_device=dev)
    log, yaapt_ms = [], []
    t0 = time.perf_counter()
    with recorded_quantizer_steps(log), timed_calls(yaapt, "yaapt_f0", yaapt_ms):
        state = qt.train_f0_quantizer(ds, f"{root}/f0_vq", batch_size=batch, training_steps=steps,
                                      checkpoint_interval=interval, quantizer_params=params,
                                      device=dev)
    wall = time.perf_counter() - t0
    check(state.step == steps == len(log), f"{state.step} steps, {len(log)} recorded")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["commit"]) for r in log), "finite losses")
    check(log[0]["initted"], "the codebook bootstrapped by step 1")
    check(all(k in log[-1] for k in ("usage", "entropy", "used_curr")), "usage/entropy read")
    want = sorted({f"g_{s:08d}" for s in [*range(interval, steps + 1, interval), steps]})
    got = sorted(f for f in os.listdir(f"{root}/f0_vq") if f.startswith("g_"))
    check(got == want, f"checkpoints {got}, want {want}")
    ckpt = load_checkpoint(f"{root}/f0_vq/g_{steps:08d}")
    back = Quantizer(**params).to(dev)
    back.load_state_dict(quantizer_state_dict(ckpt["generator"], ckpt["vq_state"], params))
    _, eval_step = qt.make_quantizer_steps()
    f0 = torch.as_tensor(np.stack([ds[i]["f0"] for i in range(batch)]), device=dev).transpose(1, 2)
    trained = float(eval_step(state, f0))
    reloaded = float(eval_step(state._replace(model=back), f0))
    check(reloaded == trained, f"eval mse of the reloaded g_ {reloaded} == trained {trained}")
    return {"steps": log, "wall_s": wall, "eval_mse": trained, "yaapt_ms": yaapt_ms}


def vq_generator_config(h: VocoderConfig, params) -> VocoderConfig:
    """``h`` with ``lambda_commit`` 0.02 and the F0 quantizer's encoder and
    VQ; the conditioning is units + quantised f0 + speaker."""
    enc = params["f0_encoder_params"]
    return dataclasses.replace(h, lambda_commit=0.02, f0_encoder_params=enc,
                               f0_vq_params=params["f0_vq_params"],
                               model_in_dim=2 * h.embedding_dim + enc["output_emb_width"])


def vq_generator(h: VocoderConfig, dev, seed: int = 23, state=None):
    """The VQ ``CodeGenerator`` on ``dev`` in eval mode: weights from
    ``seed``, or ``state`` (a state dict) in their place."""
    from dissc_tpu_torch.models.hifigan import CodeGenerator

    model = CodeGenerator(h, generator=generator_for(seed))
    if state is not None:
        model.load_state_dict(state)
    return model.to(dev).eval()


def vq_forward(model, dev, batch: int, codes: int, seed: int = 23):
    """One forward on inputs from ``seed``: ``codes`` units (a multiple of 4,
    for the encoder's 16x), f0 at 4x the code rate, speakers; the codebook's
    restart draws from a generator of the same seed.  Returns (wav, commit
    losses, metrics)."""
    rng = np.random.default_rng(seed)
    code = torch.as_tensor(rng.integers(0, model.h.num_embeddings, (batch, codes)), device=dev)
    f0 = torch.as_tensor(rng.uniform(-1, 1, (batch, 4 * codes, 1)).astype(np.float32),
                         device=dev)
    spkr = torch.as_tensor(rng.integers(0, 200, (batch, 1)), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        return model(code, f0, spkr, generator=g)


SMALL_VQ = dict(
    f0_encoder_params=dict(input_emb_width=1, output_emb_width=16, levels=1, downs_t=[4],
                           strides_t=[2], width=16, depth=2, m_conv=1.0, dilation_growth_rate=3),
    f0_vq_params=dict(l_bins=8, emb_width=16, mu=0.99, levels=1),
    f0_decoder_params=dict(input_emb_width=1, output_emb_width=16, levels=1, downs_t=[4],
                           strides_t=[2], width=16, depth=2, m_conv=1.0, dilation_growth_rate=3))


def vq_generator_card_vs_cpu(dev: torch.device) -> float:
    """(c) at a small width: the codebook bootstrapped once on the CPU (the
    restart draws differ by device), then one forward on other inputs on
    the card and on the CPU from that state; returns the waveforms' max abs
    difference."""
    h = vq_generator_config(VocoderConfig(upsample_initial_channel=32, embedding_dim=8),
                            SMALL_VQ)
    model = vq_generator(h, "cpu")
    vq_forward(model, "cpu", 2, 12)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    wav = {str(d): vq_forward(vq_generator(h, d, state=state), d, 2, 12, seed=24)[0].cpu()
           for d in (dev, "cpu")}
    return float((wav[str(dev)] - wav["cpu"]).abs().max())


def hubert_features(dev: torch.device) -> list:
    """Phase 5's HuBERT-base (seed 7, layer 6) on its first batch of
    ``bench.py``'s inputs: 8 arrays of 512 x 768 features."""
    hub_cfg = HubertConfig()
    encoder = SpeechUnitEncoder(init_state_dict(hub_cfg, torch.Generator().manual_seed(7)),
                                np.zeros((100, hub_cfg.hidden_size), np.float32), hub_cfg,
                                device=dev)
    wavs, _ = bench_inputs(np.random.default_rng(9))
    with torch.inference_mode():
        feats = encoder.model(torch.as_tensor(wavs, device=dev)).cpu().numpy()
    del encoder
    torch.cuda.empty_cache()
    return list(feats)


@contextlib.contextmanager
def recorded_kmeans_steps(log: list):
    """While open, every ``minibatch_update`` appends host copies of its
    batch, centroids and counts in, the labels it gave and the centroids
    out."""
    from dissc_tpu_torch.models import kmeans

    update = kmeans.minibatch_update

    def recording(x, centroids, counts):
        out = update(x, centroids, counts)
        log.append(dict(x=x.cpu(), c=centroids.cpu(), n=counts.cpu(),
                        labels=kmeans.assign(x, centroids).cpu(), c_out=out[0].cpu()))
        return out

    kmeans.minibatch_update = recording
    try:
        yield log
    finally:
        kmeans.minibatch_update = update


def kmeans_card_vs_cpu(feats: list, dev: torch.device, k: int = 100, epochs: int = 5) -> dict:
    """(d): ``train_kmeans`` on the card, timed; then every step of a recorded
    card run redone on the CPU from the card's own state, and the final
    assignment of every feature.  A label the CPU gives otherwise is a flip:
    it is reported with its tie's gap, relative to the squared distance and
    to the magnitude the f32 expansion ``|x|^2 - 2 x.c + |c|^2`` cancels.
    The centroids of each step's clusters that no flip touched are held to
    the CPU's within 1e-4."""
    from dissc_tpu_torch.models import kmeans

    kmeans.train_kmeans(feats[:1], k=k, n_epochs=1, seed=0, device=dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, inertia = kmeans.train_kmeans(feats, k=k, n_epochs=epochs, seed=0, device=dev)
    card_s = time.perf_counter() - t0
    log = []
    with recorded_kmeans_steps(log):
        cents, _ = kmeans.train_kmeans(feats, k=k, n_epochs=epochs, seed=0, device=dev)
    steps = len(log)
    x = torch.as_tensor(np.concatenate(feats))
    c = torch.as_tensor(cents)
    log.append(dict(x=x, c=c, labels=kmeans.assign(x.to(dev), c.to(dev)).cpu(), c_out=None))
    flips, gaps, ties, touched_all, err = 0, [], [], set(), 0.0
    for st in log:
        labels = kmeans.assign(st["x"], st["c"])
        differ = torch.nonzero(labels != st["labels"]).flatten().tolist()
        flips += len(differ)
        touched = set()
        xd, cd = st["x"].double(), st["c"].double()
        for i in differ:
            a, b = int(st["labels"][i]), int(labels[i])
            touched |= {a, b}
            da, db = (float(((xd[i] - cd[j]) ** 2).sum()) for j in (a, b))
            scale = float((xd[i] ** 2).sum()) + max(float((cd[j] ** 2).sum()) for j in (a, b))
            gaps.append(abs(da - db) / db)
            ties.append(abs(da - db) / scale)
        touched_all |= touched
        if st["c_out"] is not None:
            c_cpu = kmeans.minibatch_update(st["x"], st["c"], st["n"])[0]
            keep = [j for j in range(k) if j not in touched]
            err = max(err, float((c_cpu[keep] - st["c_out"][keep]).abs().max()))
    return {"card_s": card_s, "inertia": inertia, "steps": steps, "flipped_labels": flips,
            "flip_gap_over_distance": gaps, "flip_gap_over_cancelled_terms": ties,
            "clusters_touched_by_flips": sorted(touched_all), "centroid_max_abs_err": err}


def f0_vq_phase(h: VocoderConfig, dev: torch.device) -> None:
    """Phase 9: (a)-(b) the F0 quantizer over phase 6's corpus, (c) the VQ
    ``CodeGenerator`` at ``VocoderConfig()`` width, (d) a k-means codebook
    over HuBERT-base features."""
    from dissc_tpu_torch.train.quantizer_trainer import DEFAULT_F0_PARAMS

    smi = card_name()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vq_") as root:
        write_vocoder_corpus(root)
        run = quantizer_run(root, dev)
    step_ms = [r["ms"] for r in run["steps"]]
    print("F0-VQ (b) train_f0_quantizer", json.dumps({
        "card": smi, "steps": len(step_ms), "batch": 16, "ms_per_step": step_ms,
        "loss": [r["loss"] for r in run["steps"]], "usage": [r["usage"] for r in run["steps"]],
        "entropy": [r["entropy"] for r in run["steps"]], "eval_mse": run["eval_mse"],
        "yaapt_calls": len(run["yaapt_ms"]), "yaapt_ms_total": float(np.sum(run["yaapt_ms"])),
        "wall_s": run["wall_s"]}), flush=True)

    hv = vq_generator_config(h, DEFAULT_F0_PARAMS)
    torch.cuda.reset_peak_memory_stats()
    model = vq_generator(hv, dev)
    fwd_ms = []
    for _ in range(4):  # the first warms cuDNN up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav, commit, metrics = vq_forward(model, dev, 64, 28)
        torch.cuda.synchronize()
        fwd_ms.append(1e3 * (time.perf_counter() - t0))
    del model
    check(tuple(wav.shape) == (64, 28 * 320) and bool(torch.isfinite(wav).all()),
          f"VQ generator output {tuple(wav.shape)}, finite")
    g_err = vq_generator_card_vs_cpu(dev)
    print("F0-VQ (c) VQ CodeGenerator", json.dumps({
        "card": smi, "batch": 64, "codes": 28, "f0_frames": 112, "model_in_dim": hv.model_in_dim,
        "forward_ms": fwd_ms, "commit": float(commit[0]),
        "usage": float(metrics[0]["usage"]), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card_vs_cpu_wave_max_abs_err": g_err}), flush=True)
    check(g_err <= 1e-4, f"VQ CodeGenerator waveforms card vs CPU: {g_err}")

    feats = hubert_features(dev)
    km = kmeans_card_vs_cpu(feats, dev)
    print("F0-VQ (d) k-means", json.dumps(dict(km, card=smi, k=100, epochs=5, features=[
        sum(len(f) for f in feats), feats[0].shape[1]])), flush=True)
    check(km["steps"] == 5 * len(feats), f"{km['steps']} k-means steps")
    # f32 rounding of 768-term dot products: a few ulps of the cancelled terms
    check(km["flipped_labels"] == 0 or max(km["flip_gap_over_cancelled_terms"]) <= 1e-5,
          f"labels that flip card vs CPU are near ties: {km['flip_gap_over_cancelled_terms']}")
    check(km["centroid_max_abs_err"] <= 1e-4,
          f"k-means centroids card vs CPU (clusters no flip touched): "
          f"{km['centroid_max_abs_err']}")


# ---------------------------------------------------------------------------
# 10. data parallel: DDP over NCCL and gloo, the serving split, the CLI's ranks
# ---------------------------------------------------------------------------

DP_STEPS = 3  # SGD steps (lr 1e-3) of each GAN run
DP_PROSODY_BATCH = 32  # the prosody and quantizer steps' global batch
# (b) after DP_STEPS: the limit on W = 2 vs W = 1 is this many times the
# spread of two W = 1 runs (cuDNN's deterministic and heuristic algorithms),
# which varied 5.0e-5 to 2.2e-4 over four runs on an H100 while W = 2 vs 1
# read 1.16e-4 in each (``PERF.md``)
DP_SPREAD_FACTOR = 8.0
DP_ARGS = ["--device", "cuda", "--width", "full", "--batch", "64", "--steps", str(DP_STEPS),
           "--step-batch", str(DP_PROSODY_BATCH), "--deterministic", "--dtype", "float64"]


def dryrun(out: str, *args: str) -> tuple:
    """``python -m dissc_tpu_torch.parallel.dryrun`` as a command (its ranks
    spawn from it, never from this script); its lines echoed; returns (rank
    0's arrays, the command's wall s).  Fails on a non-zero exit."""
    cmd = [sys.executable, "-m", "dissc_tpu_torch.parallel.dryrun", *args, "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print("  |", line[:400], flush=True)
    if proc.returncode:
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
        raise RuntimeError(f"dryrun {' '.join(args)} exited {proc.returncode}")
    with np.load(out) as f:
        return dict(f), wall


def diffs(a: dict, b: dict, prefix: str) -> list:
    """(largest absolute difference, key, largest magnitude) of each ``prefix``
    array both runs hold, largest difference first."""
    keys = [k for k in a if k.startswith(prefix)]
    check(keys and all(k in b for k in keys), f"the runs both hold {prefix}*")
    return sorted(((float(np.abs(a[k].astype(np.float64) - b[k]).max()), k,
                    float(np.abs(b[k]).max())) for k in keys), reverse=True)


def worst_diff(a: dict, b: dict, prefix: str) -> tuple:
    """(largest absolute difference over the ``prefix`` arrays of both, its key)."""
    return diffs(a, b, prefix)[0][:2]


def gan_row(run: dict, wall: float) -> dict:
    """ms a step (steps 2+: the first warms cuDNN up), the all-reduce's share
    of them, peak GiB and K1 launches, a rank each."""
    ms, comm = run["gan/ms_per_step"], run["gan/allreduce_ms"]
    return {"ms_per_step": ms.tolist(), "ms_per_step_2_plus_mean": float(ms[:, 1:].mean()),
            "allreduce_ms": comm.tolist(),
            "allreduce_share_2_plus": float(comm[:, 1:].sum() / ms[:, 1:].sum()),
            "peak_gib": run["gan/peak_gib"].tolist(),
            "k1_launches": run["gan/k1_launches"].tolist(), "command_wall_s": wall}


def data_parallel_steps(root: str) -> dict:
    """(a)-(c) and (f): the GAN step at full width, global batch 64, plain,
    NCCL W = 1 and gloo W = 2 on the one card; the prosody and quantizer
    steps at W = 2 against one process; NCCL over every card where there
    are several.

    The GAN runs use cuDNN's deterministic algorithms, so (a) can be held
    bit for bit.  Batch halves change the sums' order, and the GAN step
    amplifies that rounding from step to step (on an H100, two runs of the
    plain step at W = 1 on cuDNN's heuristic algorithms part by ~1e-4 after
    3 steps; ``PERF.md``), so (b) holds step 1 to 2e-5 and step 3 to
    ``DP_SPREAD_FACTOR`` times the spread this run measures between the
    plain step and its repeat on heuristic algorithms (``--control``).  (c)
    runs in float64, where the ranks' arithmetic is exact to ~1e-15: in
    float32 an activation within rounding of a LeakyReLU's kink flips a
    whole element's gradient (2.9e-5 in one of six steps on the CPU)."""
    common = DP_ARGS
    plain, plain_s = dryrun(f"{root}/plain.npz", "--phase", "gan", "prosody", "vq", "--world",
                            "1", "--backend", "none", "--control", *common)
    nccl, nccl_s = dryrun(f"{root}/nccl1.npz", "--phase", "gan", "--world", "1", "--backend",
                          "nccl", *common)
    gloo, gloo_s = dryrun(f"{root}/gloo2.npz", "--phase", "gan", "prosody", "vq", "--world",
                          "2", "--backend", "gloo", *common)
    smi = card_name()
    a_err, a_key = worst_diff(nccl, plain, "gan/final/")
    a_bits = all(np.array_equal(nccl[k], plain[k]) for k in nccl if k.startswith("gan/final/"))
    row_a = dict(gan_row(nccl, nccl_s), card=smi, world=1, backend="nccl",
                 params_max_abs_err_vs_plain=a_err, worst=a_key, bit_equal=a_bits,
                 losses=nccl["gan/losses"].tolist(), plain=gan_row(plain, plain_s))
    print("data parallel (a) NCCL W=1", json.dumps(row_a), flush=True)
    check(a_err <= 1e-7, f"NCCL W=1 vs the plain step: {a_err} at {a_key}")
    check(nccl["gan/k1_launches"].tolist() == [2 * DP_STEPS],
          f"K1 launches at NCCL W=1: {nccl['gan/k1_launches'].tolist()}")

    b1_err, b1_key = worst_diff(gloo, nccl, "gan/step1/")
    b_top = diffs(gloo, nccl, "gan/final/")
    b_err, b_key = b_top[0][:2]
    spread, spread_key, limit = spread_limit(plain)
    loss_rel = float(np.max(np.abs(gloo["gan/losses"] - nccl["gan/losses"])
                            / np.abs(nccl["gan/losses"])))
    row_b = dict(gan_row(gloo, gloo_s), card=smi, world=2, backend="gloo",
                 params_max_abs_err_vs_a_step_1=b1_err, worst_step_1=b1_key,
                 params_max_abs_err_vs_a=b_err, worst=b_key, largest_five=b_top[:5],
                 plain_spread_heuristic_vs_deterministic=spread, spread_worst=spread_key,
                 limit_after_steps=limit, losses_max_rel_err_vs_a=loss_rel)
    print("data parallel (b) gloo W=2 on one card", json.dumps(row_b), flush=True)
    check(b1_err <= 2e-5, f"gloo W=2 vs (a) after step 1: {b1_err} at {b1_key}")
    check(b_err <= limit, f"gloo W=2 vs (a) after {DP_STEPS} steps: {b_err} at {b_key}, "
                          f"limit {limit} ({DP_SPREAD_FACTOR} x the plain spread {spread})")
    check(loss_rel <= 1e-4, f"gloo W=2 losses vs (a): relative {loss_rel}")
    check(gloo["gan/k1_launches"].tolist() == [2 * DP_STEPS] * 2,
          f"K1 launches at gloo W=2: {gloo['gan/k1_launches'].tolist()}")

    row_c = {"card": smi, "world": 2, "backend": "gloo", "batch": DP_PROSODY_BATCH}
    for prefix in [f"prosody/{v}/{m}/final/" for v in ("plain", "masked")
                   for m in ("len", "new", "base")] + ["vq/block/final/", "vq/quantizer/final/"]:
        err, key = worst_diff(gloo, plain, prefix)
        row_c[prefix.rstrip("/")] = {"max_abs_err_vs_w1": err, "worst": key}
        check(err <= 2e-5, f"{prefix} W=2 vs W=1: {err} at {key}")
    k_elem = gloo["vq/quantizer/final/vq.level_blocks.0.k_elem"]
    check(float(gloo["vq/quantizer/usage"]) < len(k_elem), "a code of the quantizer restarted")
    print("data parallel (c) prosody and VQ", json.dumps(row_c), flush=True)

    launches = int(nccl["gan/k1_launches"].sum() + gloo["gan/k1_launches"].sum()
                   + plain["gan/k1_launches"].sum())
    return {"k1_launches": launches + nccl_over_cards(root, nccl, limit, smi)}


def spread_limit(plain: dict) -> tuple:
    """(the plain step's spread after ``DP_STEPS``: its parameters against
    its repeat on cuDNN's heuristic algorithms, the key, the limit it sets
    for another world's parameters)."""
    control = {"gan/" + k[len("gan/control/"):]: v for k, v in plain.items()
               if k.startswith("gan/control/final/")}
    spread, key = worst_diff(control, plain, "gan/final/")
    return spread, key, max(2e-5, DP_SPREAD_FACTOR * spread)


def nccl_over_cards(root: str, nccl: dict, limit: float, smi: str) -> int:
    """(f): the GAN run of (a) over NCCL at W = every card, where there are
    several, held to (a) as (b) is; returns its K1 launches (0 when there
    is one card)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print("data parallel (f) skipped: NCCL over several cards needs more than the "
              f"{cards} card this machine has (torch.cuda.device_count() == {cards})",
              flush=True)
        return 0
    many, many_s = dryrun(f"{root}/nccl{cards}.npz", "--phase", "gan", "--world", str(cards),
                          "--backend", "nccl", *DP_ARGS)
    f1_err, f1_key = worst_diff(many, nccl, "gan/step1/")
    f_err, f_key = worst_diff(many, nccl, "gan/final/")
    loss_rel = float(np.max(np.abs(many["gan/losses"] - nccl["gan/losses"])
                            / np.abs(nccl["gan/losses"])))
    print(f"data parallel (f) NCCL W={cards}", json.dumps(dict(
        gan_row(many, many_s), card=smi, world=cards, backend="nccl",
        params_max_abs_err_vs_a_step_1=f1_err, worst_step_1=f1_key,
        params_max_abs_err_vs_a=f_err, worst=f_key, limit_after_steps=limit,
        losses_max_rel_err_vs_a=loss_rel)), flush=True)
    check(f1_err <= 2e-5, f"NCCL W={cards} vs (a) after step 1: {f1_err} at {f1_key}")
    check(f_err <= limit, f"NCCL W={cards} vs (a): {f_err} at {f_key}, limit {limit}")
    check(loss_rel <= 1e-4, f"NCCL W={cards} losses vs (a): relative {loss_rel}")
    check(many["gan/k1_launches"].tolist() == [2 * DP_STEPS] * cards,
          f"K1 launches at NCCL W={cards}: {many['gan/k1_launches'].tolist()}")
    return int(many["gan/k1_launches"].sum())


def write_serving_tree(root: str, h: VocoderConfig, gen_state: dict) -> dict:
    """A vocoder checkpoint dir (``config.json`` + ``g_``) from ``gen_state``,
    rhythm and "new" pitch checkpoints from seeds and a 107-speaker
    ``id_to_spkr.pkl``: what ``ConversionPipeline.load`` reads."""
    from dissc_tpu_torch.compat import to_jax
    from dissc_tpu_torch.train.checkpoints import save_checkpoint

    g = torch.Generator().manual_seed(24)
    save_checkpoint(f"{root}/vocoder/g_00000000", {"generator": to_jax.generator_tree(
        {k: v.cpu() for k, v in gen_state.items()}, h)})
    with open(f"{root}/vocoder/config.json", "w") as f:
        json.dump(h.to_dict(), f)
    save_checkpoint(f"{root}/len/best_model.pth", to_jax.len_predictor_variables(
        LenPredictor(100, N_SPEAKERS, generator=g).state_dict()))
    save_checkpoint(f"{root}/len/len_norm_stats.pth", BENCH_LEN_STATS)
    save_checkpoint(f"{root}/pitch/best_model.pth", to_jax.pitch_predictor_variables(
        build_pitch_model("new", 100, N_SPEAKERS, generator=g).state_dict()))
    names = [f"s{i:03d}" for i in range(N_SPEAKERS)]
    with open(f"{root}/id_to_spkr.pkl", "wb") as f:
        pickle.dump(names, f)
    return dict(vocoder_ckpt=f"{root}/vocoder", id_to_spkr=f"{root}/id_to_spkr.pkl",
                len_model_dir=f"{root}/len", f0_model_dir=f"{root}/pitch")


def serving_split(h: VocoderConfig, gen_state: dict, root: str, dev: torch.device) -> dict:
    """(d): ``VocoderEngine`` and ``ConversionPipeline`` split over the card
    twice (every card where there are several) against one device."""
    cards = torch.cuda.device_count()
    split = [f"cuda:{i % cards}" for i in range(max(2, cards))]
    rng = np.random.default_rng(2)
    lengths = [100, 237, 400, 640, 1000, 1500, 2048, 77, 2600]  # the serve phase's
    items = [{"code": rng.integers(0, h.num_embeddings, n).astype(np.int64),
              "f0": rng.normal(0, 1, (n, 1)).astype(np.float32),
              "spkr": np.array([i * 11 % 100])} for i, n in enumerate(lengths)]
    one = VocoderEngine(h, gen_state, device=dev)
    many = VocoderEngine(h, gen_state, devices=split)
    timings = {}
    for name, engine in (("one", one), ("split", many), ("one_again", one),
                         ("split_again", many)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs, _ = engine.synthesize_utterances(items, batch_size=8)
        timings[name] = 1e3 * (time.perf_counter() - t0)
        if name == "one":
            ref = wavs
        elif name == "split":
            got = wavs
    check([len(w) for w in got] == [n * h.code_hop_size for n in lengths],
          "the split engine's waveforms in input order, at their lengths")
    wave_err = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    check(wave_err <= 1e-4, f"split vs one-device waveforms: {wave_err}")

    tree = write_serving_tree(root, h, gen_state)
    records = [{"units": [int(u) for u in rng.integers(0, 100, n)], "f0": [0.0] * n,
                "audio": f"s{i * 13 % N_SPEAKERS:03d}_{i}.wav"}
               for i, n in enumerate([60, 120, 200, 90, 300, 150, 45, 250, 180])]
    out = []
    for devices in (None, split):
        pipe = ConversionPipeline.load(**tree, device=dev, devices=devices)
        t0 = time.perf_counter()
        out.append(pipe.convert_batch(records, "s007", batch_size=8)[0])
        timings["pipeline_one" if devices is None else "pipeline_split"] = (
            1e3 * (time.perf_counter() - t0))
    check([len(w) for w in out[1]] == [len(w) for w in out[0]], "pipeline waveforms in order")
    pipe_err = max(float(np.abs(a - b).max()) for a, b in zip(*out))
    check(pipe_err <= 1e-4, f"split vs one-device pipeline: {pipe_err}")
    return {"devices": split, "wave_max_abs_err": wave_err, "pipeline_max_abs_err": pipe_err,
            "ms": timings, "utterances": len(items), "records": len(records)}


def cli_ranks(h: VocoderConfig, root: str, dev: torch.device) -> dict:
    """(e): ``cli.sr_train`` at full width over a seeded corpus with its own
    launcher (W = the cards that divide the batch): 2 steps with a
    checkpoint, then resumed to 4."""
    os.makedirs(root, exist_ok=True)
    manifests = write_vocoder_corpus(root, n=h.batch_size, n_val=4)
    config = write_vocoder_config(root, manifests)
    ckpt = os.path.join(root, "ckpt")
    argv = ["--config", config, "--checkpoint_path", ckpt, "--stdout_interval", "1",
            "--checkpoint_interval", "2", "--validation_interval", "1000", "--device", str(dev)]
    world = world_for_batch(h.batch_size, torch.cuda.device_count())
    runs, restored = [], []
    mel_kernel.reset_launch_counts()
    with restored_states(restored):
        for steps in (2, 4):
            t0 = time.perf_counter()
            result = sr_train.main(argv + ["--training_steps", str(steps)])
            wall = time.perf_counter() - t0
            files = sorted(f for f in os.listdir(ckpt) if f[:2] in ("g_", "do"))
            runs.append({"to_step": steps, "wall_s": wall, "files": files,
                         "stats": None if result is None else
                         {k: result[1][k] for k in ("start_step", "step_s")}})
            if result is not None:
                del result
            torch.cuda.empty_cache()
    launches = mel_kernel.launch_counts["mel_spectrogram"]
    check(runs[0]["files"] == ["do_00000002", "g_00000002"], f"files after run 1 {runs[0]}")
    check(runs[1]["files"] == ["do_00000002", "do_00000004", "g_00000002", "g_00000004"],
          f"files after run 2 {runs[1]['files']}")
    if world == 1:
        check(runs[1]["stats"]["start_step"] == 2 and len(restored) == 1
              and restored[0]["step"] == 2, "the second run resumed at step 2")
        check(launches == 2 * 4, f"K1 launches in the CLI's runs: {launches}")
    saved = load_checkpoint(os.path.join(ckpt, "do_00000004"))
    check(saved["steps"] == 4, f"do_00000004 holds step {saved['steps']}")
    engine = VocoderEngine.from_checkpoint(ckpt, device=dev)
    wav, _ = engine.synthesize_utterances([{"code": np.arange(50) % 100, "spkr": np.array([1]),
                                            "f0": np.zeros((50, 1), np.float32)}])
    check(wav[0].shape == (50 * h.code_hop_size,) and bool(np.isfinite(wav[0]).all()),
          "the written g_ serves")
    return {"world": world, "runs": runs, "k1_launches": launches}


def data_parallel_phase(h: VocoderConfig, gen_state: dict, dev: torch.device) -> int:
    """Phase 10; returns K1's launches over its runs (every rank's)."""
    smi = card_name()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        t0 = time.perf_counter()
        steps = data_parallel_steps(root)
        t1 = time.perf_counter()
        serve = serving_split(h, gen_state, root, dev)
        print("data parallel (d) serving split", json.dumps(dict(serve, card=smi)), flush=True)
        t2 = time.perf_counter()
        cli = cli_ranks(h, os.path.join(root, "cli"), dev)
        print("data parallel (e) cli.sr_train", json.dumps(dict(cli, card=smi)), flush=True)
        print(f"data parallel: steps {t1 - t0:.1f} s, serving {t2 - t1:.1f} s, CLI "
              f"{time.perf_counter() - t2:.1f} s", flush=True)
    return steps["k1_launches"] + cli["k1_launches"]


# ---------------------------------------------------------------------------
# 11. bfloat16: the mixed-precision compute paths
# ---------------------------------------------------------------------------

BF16 = dict(compute_dtype="bfloat16", disc_compute_dtype="bfloat16")
BF16_MEL_L1, BF16_MAX_DY = 0.05, 0.05  # tests/test_bf16.py's bounds, bf16 vs f32 waveforms
BF16_UNIT_SHARE = 0.95  # tests/test_hubert_bf16.py's bound, bf16 vs f32 units
BF16_STEPS = 4


def rel_l2(a, b) -> float:
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_convert_models(m: dict, h: VocoderConfig, gen_state: dict, root: str,
                        dev) -> dict:
    """``m``'s conversion models in bfloat16 through the entry points: the
    generator as a checkpoint directory whose ``config.json`` sets
    ``compute_dtype`` bfloat16 (``VocoderEngine.from_checkpoint``), HuBERT
    from its JAX-layout files through ``load_encoder(...,
    HubertConfig(compute_dtype="bfloat16"))``, both in a
    ``ConversionPipeline`` with ``m``'s prosody models (float32)."""
    from dissc_tpu_torch.compat.to_jax import generator_tree, hubert_params
    from dissc_tpu_torch.models.hubert import load_encoder
    from dissc_tpu_torch.train.checkpoints import save_checkpoint

    ckpt = os.path.join(root, "vocoder")
    save_checkpoint(os.path.join(ckpt, "g_00000000"),
                    {"generator": generator_tree(gen_state, h)})
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(dict(h.to_dict(), compute_dtype="bfloat16"), fh)
    save_checkpoint(os.path.join(root, "hubert.pkl"),
                    {"params": hubert_params(m["hub_state"], m["hub_cfg"])})
    np.save(os.path.join(root, "km.npy"), m["codebook"])
    hub_cfg = dataclasses.replace(m["hub_cfg"], compute_dtype="bfloat16")
    encoder = load_encoder(os.path.join(root, "hubert.pkl"), os.path.join(root, "km.npy"),
                           hub_cfg, device=dev)
    f0_stats = {n: {"mean": float(m["id2mean"][i]), "std": float(m["id2std"][i])}
                for n, i in m["spk_dict"].items()}
    # phase 5 (b)'s rhythm de-normalisation, which keeps a recording inside out_cap
    pipe = ConversionPipeline(VocoderEngine.from_checkpoint(ckpt, device=dev),
                              converter(m, dev, (1.5, 0.5)), m["spk_dict"],
                              f0_stats=f0_stats, encoder=encoder)
    check(pipe.vocoder.model.conv_pre.dtype == torch.bfloat16
          and pipe.vocoder.model.conv_post.dtype is None, "the engine follows config.json")
    return dict(m, hub_cfg=hub_cfg, encoder=encoder, engine=pipe.vocoder, pipe=pipe)


def stage_row(m: dict, wavs: np.ndarray, names: list) -> tuple:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    units, converted, out, stage_ms = convert_stages(m, wavs, names)
    audio_s = sum(len(w) for w in out) / m["engine"].h.sampling_rate
    row = {"encode_ms": stage_ms[0], "prosody_ms": stage_ms[1], "vocode_ms": stage_ms[2],
           "wall_ms": float(stage_ms.sum()), "rtf": float(stage_ms.sum()) / 1e3 / audio_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return row, (units, converted, out)


def waveform_gaps(a: list, b: list, dev) -> tuple:
    """(log-mel mean L1, max |a - b|) over utterances of equal lengths."""
    l1, dy = [], 0.0
    for x, y in zip(a, b):
        tx, ty = (torch.from_numpy(np.ascontiguousarray(v))[None].to(dev) for v in (x, y))
        l1.append(float((mel_spectrogram(tx) - mel_spectrogram(ty)).abs().mean()))
        dy = max(dy, float(np.abs(x - y).max()))
    return float(np.mean(l1)), dy


def bf16_card_vs_cpu(m32: dict, m16: dict, h: VocoderConfig, gen_state: dict, root: str,
                     items: list, dev) -> dict:
    """One utterance through the vocoder and 1 s through HuBERT, each in
    bfloat16 and float32 on the card and on the CPU.  Limit: the card's
    bfloat16 lies no farther from the CPU's than the sum of the two
    devices' own bfloat16-vs-float32 distances (each device's rounding
    moves it that far from float32, float32 agreeing across them)."""
    from dissc_tpu_torch.models.hubert import load_encoder

    item = dict(items[0], code=items[0]["code"][:100], f0=items[0]["f0"][:100])
    wav = (np.random.default_rng(24).standard_normal(16000) * 0.1).astype(np.float32)
    engines = {("card", "bf16"): m16["engine"], ("card", "f32"): m32["engine"],
               ("cpu", "bf16"): VocoderEngine.from_checkpoint(os.path.join(root, "vocoder"),
                                                             device="cpu"),
               ("cpu", "f32"): VocoderEngine(h, gen_state, device="cpu")}
    encoders = {("card", "bf16"): m16["encoder"], ("card", "f32"): m32["encoder"],
                ("cpu", "bf16"): load_encoder(os.path.join(root, "hubert.pkl"),
                                              os.path.join(root, "km.npy"), m16["hub_cfg"],
                                              device="cpu"),
                ("cpu", "f32"): SpeechUnitEncoder(m32["hub_state"], m32["codebook"],
                                                  m32["hub_cfg"], device="cpu")}
    y = {k: e.synthesize_utterances([item])[0][0] for k, e in engines.items()}
    with torch.inference_mode():
        f = {k: e.model(torch.as_tensor(wav[None], device=e.device)).float().cpu().numpy()
             for k, e in encoders.items()}
    out = {}
    for name, v in (("vocoder", y), ("hubert", f)):
        row = {"card_bf16_vs_cpu_bf16": rel_l2(v["card", "bf16"], v["cpu", "bf16"]),
               "card_f32_vs_cpu_f32": rel_l2(v["card", "f32"], v["cpu", "f32"]),
               "card_bf16_vs_f32": rel_l2(v["card", "bf16"], v["card", "f32"]),
               "cpu_bf16_vs_f32": rel_l2(v["cpu", "bf16"], v["cpu", "f32"])}
        row["limit"] = row["card_bf16_vs_f32"] + row["cpu_bf16_vs_f32"]
        out[name] = row
    print("bf16 (a) card vs CPU (relative L2)", json.dumps(out), flush=True)
    for name, row in out.items():
        check(row["card_bf16_vs_cpu_bf16"] <= row["limit"],
              f"{name} bf16 card vs CPU {row['card_bf16_vs_cpu_bf16']} > {row['limit']}")
    return out


BF16_GAIN = 0.8  # the generator's weight-norm gains in (a): speech-level waveforms


def audible(gen_state: dict) -> dict:
    """``gen_state`` (an init's) with every weight-norm gain ``BF16_GAIN`` and
    every bias 0.  At the init's gains (~0.1) the waveform is nearly its
    last bias, a constant, whose log-mel is the clip floor's noise (bf16 vs
    f32 log-mel L1 0.30 at max |dy| 6e-5 on the card); at gains 1, as phase
    7 writes its generator, the bench's f0 in Hz drives it to peaks of 0.99
    (rms 0.46 on the CPU); at 0.8 its rms is ~0.09 with peaks ~0.45, a
    level of speech.  Phase 3's generator, four steps on, saturates at 0.8
    (rms 1.0), so phase 11 takes phase 10's seeded init."""
    return {k: (torch.full_like(v, BF16_GAIN) if k.endswith("weight_g") else
                torch.zeros_like(v) if k.endswith("bias") else v)
            for k, v in gen_state.items()}


def bf16_convert(h: VocoderConfig, gen_state: dict, root: str, dev) -> None:
    """(a): ``bench.py``'s shape through the float32 models of phase 5 and
    their bfloat16 counterparts (the prosody models are float32 in both),
    in turn on the same inputs (the first run warms up); the generator is
    ``gen_state`` made :func:`audible`."""
    gen_state = audible(gen_state)
    m32 = build_convert_models(h, gen_state, dev)
    m16 = bf16_convert_models(m32, h, gen_state, root, dev)
    rng = np.random.default_rng(9)
    rows = []
    for run in range(3):
        wavs, names = bench_inputs(rng)
        r32, (units32, conv32, _) = stage_row(m32, wavs, names)
        r16, (units16, _, _) = stage_row(m16, wavs, names)
        rows.append({"run": run, "f32": r32, "bf16": r16})
        print("bf16 (a) bench shape", json.dumps(rows[-1]), flush=True)
    mean = {dt: {k: float(np.mean([r[dt][k] for r in rows[1:]])) for k in rows[0][dt]}
            for dt in ("f32", "bf16")}
    print("bf16 (a) mean of the timed runs", json.dumps(mean), flush=True)

    # the vocoder on the same converted records in both dtypes
    items = [{"code": np.asarray(c["units"], np.int64),
              "f0": np.asarray(c["f0"], np.float32).reshape(-1, 1),
              "spkr": np.array([m32["spk_dict"][n]])} for c, n in zip(conv32, names)]
    y32, _ = m32["engine"].synthesize_utterances(items, batch_size=len(items))
    y16, _ = m16["engine"].synthesize_utterances(items, batch_size=len(items))
    mel_l1, max_dy = waveform_gaps(y16, y32, dev)
    unit_share = float((units16 == units32).mean())
    with torch.inference_mode():
        head = m16["engine"].model(*(torch.as_tensor(a, device=dev)[None] for a in (
            items[0]["code"][:64], items[0]["f0"][:64], items[0]["spkr"])))
    probe, probe_sr = m16["pipe"].convert(voiced_stretches(22050, seed=8), "spk003",
                                         sr=22050, source_speaker="spk010")
    flat32, flat16 = np.concatenate(y32), np.concatenate(y16)
    gates = {"waveform_log_mel_l1": mel_l1, "waveform_max_abs_diff": max_dy,
             "waveform_rel_l2": rel_l2(flat16, flat32),
             "f32_waveform_rms": float(np.sqrt(np.mean(flat32 ** 2))),
             "f32_waveform_peak": float(np.abs(flat32).max()),
             "waveform_dtype": str(y16[0].dtype), "forward_dtype": str(head.dtype),
             "hubert_unit_share": unit_share, "utterances": len(items),
             "pipeline_probe": {"output_s": len(probe) / probe_sr,
                                "finite": bool(np.isfinite(probe).all())}}
    print("bf16 (a) bf16 vs f32", json.dumps(gates), flush=True)
    check(mel_l1 < BF16_MEL_L1, f"bf16 vs f32 log-mel L1 {mel_l1}")
    check(max_dy < BF16_MAX_DY, f"bf16 vs f32 max |dy| {max_dy}")
    check(max_dy > 0, "the bf16 engine computed in bf16")
    check(gates["f32_waveform_rms"] > 0.01 and gates["f32_waveform_peak"] < 0.99,
          "the compared waveforms are neither near silent nor saturated")
    check(all(w.dtype == np.float32 for w in y16) and head.dtype == torch.float32,
          "the f32 head: the bf16 generator's waveform is float32")
    check(unit_share >= BF16_UNIT_SHARE, f"HuBERT bf16 vs f32 units agree on {unit_share}")
    check(gates["pipeline_probe"]["finite"] and len(probe) % 320 == 0,
          "the bf16 pipeline converts a recording")
    bf16_card_vs_cpu(m32, m16, h, gen_state, root, items, dev)


def bf16_train(h: VocoderConfig, root: str, dev) -> int:
    """(b): ``cli.sr_train`` with both compute dtypes bfloat16 over phase 6's
    corpus for ``BF16_STEPS`` steps, then one ``GANTrainer`` step in float32
    and in bfloat16 from one init and one batch; returns K1's launches."""
    os.makedirs(root)
    manifests = write_vocoder_corpus(root)
    config = write_vocoder_config(root, manifests, **BF16)
    ckpt = os.path.join(root, "ckpt")
    argv = ["--config", config, "--checkpoint_path", ckpt, "--stdout_interval", "1",
            "--checkpoint_interval", str(BF16_STEPS), "--validation_interval", "1000",
            "--training_steps", str(BF16_STEPS), "--device", str(dev)]
    torch.cuda.reset_peak_memory_stats()
    launches = mel_kernel.launch_counts["mel_spectrogram"]
    metrics = []
    with recorded_steps(metrics):
        trainer, stats = sr_train.main(argv)
    loop_launches = mel_kernel.launch_counts["mel_spectrogram"] - launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    h16 = dataclasses.replace(h, **BF16)
    check(trainer.step == BF16_STEPS and loop_launches == 2 * BF16_STEPS,
          f"K1 launched {loop_launches} times in {trainer.step} bf16 steps (2 a step)")
    check(trainer.gen.conv_pre.dtype == torch.bfloat16
          and trainer.msd.discriminators[0].convs[0].dtype == torch.bfloat16,
          "the CLI's trainer runs the generator and the discriminators in bf16")
    masters = {p.dtype for mod in (trainer.gen, trainer.mpd, trainer.msd)
               for p in mod.parameters()}
    check(masters == {torch.float32}, f"master params {masters}")
    g_file = load_checkpoint(os.path.join(ckpt, f"g_{BF16_STEPS:08d}"))["generator"]
    state = generator_state_dict(g_file, h16)  # reads the JAX layout
    leaves = sorted({str(v.dtype) for v in state.values()})
    check(leaves == ["torch.float32"] and all(
        torch.equal(v, trainer.gen.state_dict()[k].cpu()) for k, v in state.items()),
          f"the g_ file holds the float32 state in the JAX layout ({leaves})")
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    check(all(np.isfinite(v) for m in losses for v in m.values()), "finite bf16 losses")
    del trainer
    torch.cuda.empty_cache()

    batch = synthetic_batch(h, torch.Generator().manual_seed(21), dev)
    step1 = {}
    for name, hh in (("f32", h), ("bf16", h16)):
        trainer = GANTrainer(hh, device=dev, seed=h.seed)
        step1[name] = {k: float(v) for k, v in trainer.train_step(batch).items()}
        del trainer
        torch.cuda.empty_cache()
    row = {"ms_per_step_with_data_steps_2_plus": [1e3 * s for s in stats["step_s"][1:]],
           "first_step_ms": 1e3 * stats["step_s"][0], "peak_gib": peak,
           "k1_launches_cli": loop_launches, "losses": losses, "g_file_dtypes": leaves,
           "step1_f32": step1["f32"], "step1_bf16": step1["bf16"]}
    print("bf16 (b) cli.sr_train", json.dumps(row), flush=True)
    for k, a in step1["f32"].items():
        b = step1["bf16"][k]
        check(abs(a - b) <= 0.05 * abs(a) + 0.05, f"step-1 {k}: bf16 {b} vs f32 {a}")
    return mel_kernel.launch_counts["mel_spectrogram"] - launches


def bf16_phase(h: VocoderConfig, gen_state: dict, dev) -> int:
    """Phase 11; returns K1's launches in it."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as root:
        t0 = time.perf_counter()
        bf16_convert(h, gen_state, root, dev)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        launches = bf16_train(h, os.path.join(root, "train"), dev)
        print(f"bf16: convert {t1 - t0:.1f} s, train {time.perf_counter() - t1:.1f} s",
              flush=True)
    return launches


# ---------------------------------------------------------------------------
# 12. the model axis (tensor parallelism) and the fused MSD G step
# ---------------------------------------------------------------------------

# (a) each rank of a model group holds all of its data shard's rows: at the
# plain step's batch of 64 (37.48 GiB at W = 1, PERF.md) two ranks on one
# card would not fit, so the grid's global batch is cut to 32
TP_BATCH = 32
TP_ARGS = ["--device", "cuda", "--width", "full", "--batch", str(TP_BATCH), "--steps",
           str(DP_STEPS), "--deterministic"]
FUSED_STEPS = 3
FUSED_F32_REL = 1e-5  # (b): the fused generator gradient vs autograd's, relative L2


def tensor_parallel_steps(root: str) -> int:
    """(a): the GAN step at ``VocoderConfig()``, global batch ``TP_BATCH``,
    ``DP_STEPS`` SGD steps, cuDNN deterministic: plain (W = 1, with its
    heuristic-algorithm repeat for the spread), then ``--shard tp --model 2``
    at W = 2 (data 1 x model 2) and W = 4 (data 2 x model 2), gloo with the
    ranks sharing the card (NCCL where there is a card a rank); the gathered
    generator, MPD, MSD and the losses held to the plain step as phase 10
    holds W = 2; returns K1's launches over the runs."""
    plain, plain_s = dryrun(f"{root}/tp_plain.npz", "--phase", "gan", "--world", "1",
                            "--backend", "none", "--control", *TP_ARGS)
    spread, spread_key, limit = spread_limit(plain)
    smi = card_name()
    print("model axis (a) plain W=1", json.dumps(dict(
        gan_row(plain, plain_s), card=smi, batch=TP_BATCH,
        spread_heuristic_vs_deterministic=spread, spread_worst=spread_key,
        limit_after_steps=limit)), flush=True)
    launches = int(plain["gan/k1_launches"].sum())
    for world in (2, 4):
        backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
        run, wall = dryrun(f"{root}/tp{world}.npz", "--phase", "gan", "--shard", "tp", "--model",
                           "2", "--world", str(world), "--backend", backend, *TP_ARGS)
        step1_err, step1_key = worst_diff(run, plain, "gan/step1/")
        top = diffs(run, plain, "gan/final/")
        loss_rel = float(np.max(np.abs(run["gan/losses"] - plain["gan/losses"])
                                / np.abs(plain["gan/losses"])))
        ms, model_ms = run["gan/ms_per_step"], run["gan/model_comm_ms"]
        gap = run["gan/replicated_gap"].tolist()
        row = dict(gan_row(run, wall), card=smi, world=world, grid=[world // 2, 2],
                   backend=backend, batch=TP_BATCH, sharded=run["gan/sharded"].tolist(),
                   model_comm_ms=model_ms.tolist(),
                   model_comm_share_2_plus=float(model_ms[:, 1:].sum() / ms[:, 1:].sum()),
                   replicated_gap=gap, params_max_abs_err_vs_plain_step_1=step1_err,
                   worst_step_1=step1_key, params_max_abs_err_vs_plain=top[0][0],
                   worst=top[0][1], largest_five=top[:5], limit_after_steps=limit,
                   losses_max_rel_err_vs_plain=loss_rel)
        print(f"model axis (a) tp W={world}", json.dumps(row), flush=True)
        check(len(row["sharded"]) == 4, f"the rule split {row['sharded']}")
        check(step1_err <= 2e-5, f"tp W={world} vs plain after step 1: {step1_err} at {step1_key}")
        check(top[0][0] <= limit, f"tp W={world} vs plain after {DP_STEPS} steps: {top[0][0]} at "
                                  f"{top[0][1]}, limit {limit}")
        check(loss_rel <= 1e-4, f"tp W={world} losses vs plain: relative {loss_rel}")
        check(gap == [0.0] * world, f"tp W={world}: replicated parameters part by {gap}")
        check(run["gan/k1_launches"].tolist() == [2 * DP_STEPS] * world,
              f"K1 launches at tp W={world}: {run['gan/k1_launches'].tolist()}")
        launches += int(run["gan/k1_launches"].sum())
    return launches


def _gen_grad(trainer: GANTrainer) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in trainer.gen.parameters()])


def _msd_u(trainer: GANTrainer) -> torch.Tensor:
    return torch.cat([b.reshape(-1) for n, b in trainer.msd.named_buffers()
                      if n.endswith("weight_u")])


def msd_g_peak_gib(h: VocoderConfig, dev: torch.device, dtype: str, fused: bool) -> float:
    """GiB the MSD's G-step terms alone (forward, then the gradient for
    ``y_hat``) take above their inputs at ``h``'s batch: the plain module or
    the fused stack, ``msd_scales`` scales in ``dtype``."""
    msd = MultiScaleDiscriminator(int(h.msd_scales), generator=torch.Generator().manual_seed(27),
                                  dtype=resolve_dtype(dtype)).to(dev)
    msd.requires_grad_(False)
    g = torch.Generator().manual_seed(28)
    y, y_hat = (torch.randn((h.batch_size, h.segment_size), generator=g).mul(0.3).to(dev)
                for _ in range(2))
    y_hat.requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = (msd_g_apply(fold_msd_weights(msd, True, resolve_dtype(dtype)), y, y_hat) if fused
           else msd(y, y_hat))
    (generator_loss(out[1])[0] + feature_loss(out[2], out[3])).backward()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del msd, out, y, y_hat
    torch.cuda.empty_cache()
    return peak


def fused_msd_steps(h: VocoderConfig, dev: torch.device) -> int:
    """(b): ``GANTrainer`` at ``h``'s width and batch, ``FUSED_STEPS`` steps
    from one seed and batch with ``msd_fused_gstep`` off, then on, in float32
    and in bfloat16 (``disc_compute_dtype``), cuDNN deterministic; the fused
    generator gradient and spectral ``u`` after step 1 against the plain
    step's: within ``FUSED_F32_REL`` (relative L2) in float32, within half of
    the plain step's own bf16-vs-f32 gradient distance (the bound of
    ``tests/test_torch_bf16_vocoder.py``) in bfloat16; returns K1's
    launches."""
    batch = synthetic_batch(h, torch.Generator().manual_seed(26), dev)
    fused_calls = []
    real = vocoder_trainer.msd_g_apply
    runs, launches = {}, mel_kernel.launch_counts["mel_spectrogram"]
    with card_math(deterministic=True), contextlib.ExitStack() as stack:
        stack.callback(setattr, vocoder_trainer, "msd_g_apply", real)
        vocoder_trainer.msd_g_apply = lambda *a: fused_calls.append(1) or real(*a)
        for dtype in ("float32", "bfloat16"):
            for fused in (False, True):
                hh = dataclasses.replace(h, msd_fused_gstep=fused, disc_compute_dtype=dtype)
                trainer = GANTrainer(hh, device=dev, seed=h.seed)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                calls, ms = len(fused_calls), []
                for step in range(FUSED_STEPS):
                    t0 = time.perf_counter()
                    metrics = trainer.train_step(batch)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                    if step == 0:
                        grad, u = _gen_grad(trainer).clone(), _msd_u(trainer).clone()
                        losses = {k: float(v) for k, v in metrics.items()}
                check(len(fused_calls) - calls == (FUSED_STEPS if fused else 0),
                      f"the fused MSD ran {len(fused_calls) - calls} times, fused={fused}")
                runs[(dtype, fused)] = dict(grad=grad, u=u, ms=ms, losses=losses,
                                            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                del trainer
                torch.cuda.empty_cache()
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).double())
                             / torch.linalg.vector_norm(b.double()))
    bf16_gap = rel(runs[("bfloat16", False)]["grad"], runs[("float32", False)]["grad"])
    smi = card_name()
    for dtype, bound in (("float32", FUSED_F32_REL), ("bfloat16", 0.5 * bf16_gap)):
        plain, fused = runs[(dtype, False)], runs[(dtype, True)]
        row = {"card": smi, "dtype": dtype, "batch": h.batch_size, "deterministic": True,
               "ms_per_step_plain": plain["ms"], "ms_per_step_fused": fused["ms"],
               "peak_gib_plain": plain["peak_gib"], "peak_gib_fused": fused["peak_gib"],
               "msd_g_terms_peak_gib_plain": msd_g_peak_gib(h, dev, dtype, False),
               "msd_g_terms_peak_gib_fused": msd_g_peak_gib(h, dev, dtype, True),
               "grad_rel_l2_fused_vs_plain": rel(fused["grad"], plain["grad"]),
               "u_rel_l2_fused_vs_plain": rel(fused["u"], plain["u"]), "bound": bound,
               "plain_bf16_vs_f32_grad_rel_l2": bf16_gap,
               "losses_step_1_plain": plain["losses"], "losses_step_1_fused": fused["losses"]}
        print(f"model axis (b) fused MSD G step, {dtype}", json.dumps(row), flush=True)
        check(row["grad_rel_l2_fused_vs_plain"] <= bound,
              f"{dtype} fused generator gradient vs plain: {row['grad_rel_l2_fused_vs_plain']}, "
              f"bound {bound}")
        check(row["u_rel_l2_fused_vs_plain"] <= bound,
              f"{dtype} fused spectral u vs plain: {row['u_rel_l2_fused_vs_plain']}, bound {bound}")
    launched = mel_kernel.launch_counts["mel_spectrogram"] - launches
    check(launched == 2 * FUSED_STEPS * len(runs), f"K1 launched {launched} times in (b)")
    return launched


def model_axis_phase(h: VocoderConfig, dev: torch.device) -> int:
    """Phase 12; returns K1's launches over its runs (every rank's)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as root:
        t0 = time.perf_counter()
        launches = tensor_parallel_steps(root)
        t1 = time.perf_counter()
        launches += fused_msd_steps(h, dev)
        print(f"model axis: tp {t1 - t0:.1f} s, fused MSD {time.perf_counter() - t1:.1f} s",
              flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    print(card_name().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "| allow_tf32: cuda.matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32, "| bf16 reduced-precision reduction",
          torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction, flush=True)
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
    del gen_state
    torch.cuda.empty_cache()

    loop_launches = train_loop_phase(h, dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ce_") as ce_root:
        mel_kernel.reset_launch_counts()
        convert_eval_phase(h, dev, ce_root)
        check(mel_kernel.launch_counts["mel_spectrogram"] == 0,
              "the convert + eval path launched no kernel of the port")
        t0 = time.perf_counter()
        mel_kernel.reset_launch_counts()
        sv_phase(ce_root, dev)
        check(mel_kernel.launch_counts["mel_spectrogram"] == 0,
              "the speaker-verification path launched no kernel of the port")
        print(f"speaker verification: phase {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mel_kernel.reset_launch_counts()
    f0_vq_phase(h, dev)
    check(mel_kernel.launch_counts["mel_spectrogram"] == 0,
          "the F0-VQ and k-means paths launched no kernel of the port")
    print(f"F0-VQ and k-means: phase {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mel_kernel.reset_launch_counts()
    dp_launches = data_parallel_phase(h, vocoder_trainer.make_models(h, seed=25)[0].state_dict(),
                                      dev)
    print(f"data parallel: phase {time.perf_counter() - t0:.1f} s, K1 launches {dp_launches}",
          flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mel_kernel.reset_launch_counts()
    bf16_launches = bf16_phase(h, vocoder_trainer.make_models(h, seed=25)[0].state_dict(), dev)
    check(bf16_launches == mel_kernel.launch_counts["mel_spectrogram"] == 2 * BF16_STEPS + 4,
          f"K1 launches in the bf16 phase: {bf16_launches}")
    print(f"bf16: phase {time.perf_counter() - t0:.1f} s, K1 launches {bf16_launches}",
          flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mel_kernel.reset_launch_counts()
    tp_launches = model_axis_phase(h, dev)
    check(tp_launches > 0, "the model-axis phase launched K1")
    print(f"model axis: phase {time.perf_counter() - t0:.1f} s, K1 launches {tp_launches}",
          flush=True)

    kernels = [{"name": "mel_spectrogram", "route": "cuda",
                "source": "dissc_tpu_torch/csrc/mel_kernel.cu",
                "replaces": "dissc_tpu/kernels/mel_kernel.py:112",
                "launches": loop_launches, "launches_gan_steps": launches,
                "launches_data_parallel": dp_launches, "launches_bf16": bf16_launches,
                "launches_model_axis": tp_launches,
                "max_abs_err": mel_row["max_abs_err"],
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
