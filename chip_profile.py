"""Where the device time goes in the port, on one CUDA card.

    python3 chip_profile.py

At the full ``VocoderConfig()`` and HuBERT-base widths, with weights from
fixed seeds: K1's own device time per launch at the shapes
``chip_smoke.py`` times; two warm-up GAN train steps at batch 64 x 8960
samples, then two steps under ``torch.profiler``; one serving batch of 8
utterances x 1024 frames (the shape of ``bench.py``'s vocoder batch); and
the conversion path at ``bench.py``'s shape (``chip_smoke.py``'s convert
(a): units, prosody, vocoder), after two warm-up runs; ten F0 quantizer
train steps at ``DEFAULT_F0_PARAMS`` (batch 16 x 112 frames, the shape of
``chip_smoke.py``'s phase 9) after ten warm-up steps; and ten
ECAPA-TDNN embeddings at ``EcapaConfig()`` of a 3 s waveform (fbank and
forward, as phase 8 scores a file) after two warm-up calls.  For each
window it prints the host wall time, the device kernel time and busy
share, the kernel time by category and the top kernels by name.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (bench_inputs, build_convert_models, convert_stages, kernel_cases,
                        mel_args, own_kernel_us, synthetic_batch)
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.kernels import mel_kernel
from dissc_tpu_torch.models.ecapa import EcapaConfig, EcapaEmbedder, EcapaTDNN
from dissc_tpu_torch.models.vq import Quantizer
from dissc_tpu_torch.train import quantizer_trainer as qt
from dissc_tpu_torch.train.vocoder_trainer import GANTrainer

CATEGORIES = [  # first match wins, on the lower-cased kernel name
    ("K1 mel", ("log_mel_fft_kernel",)),
    ("optimizer", ("adam", "multi_tensor")),
    ("conv via FFT (transforms + complex products)", ("fft", "region_transform", "cf32")),
    ("conv data grad", ("dgrad",)),
    ("conv weight grad", ("wgrad",)),
    ("conv", ("conv", "fprop", "implicit", "winograd", "cudnn")),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("reduction", ("reduce",)),
]


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise / other"


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals, in microseconds."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def report(tag: str, prof, wall_ms: float, steps: int) -> None:
    """Device activity of the window: kernel time by name and category
    (summed, so concurrent kernels count in full) and the busy share (the
    union of their intervals over the host wall time)."""
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    by_cat, by_name = defaultdict(float), defaultdict(float)
    for e in events:
        by_cat[category(e.name())] += e.duration_ns() / 1e3
        by_name[e.name()] += e.duration_ns() / 1e3
    total_us = sum(by_name.values())
    busy = busy_us((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events)
    summary = {
        "window": tag, "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "kernel_ms_per_step": total_us / 1e3 / steps,
        "busy_ms_per_step": busy / 1e3 / steps, "busy_share": busy / 1e3 / wall_ms,
        "device_events_per_step": len(events) / steps,
        "ms_per_step_by_category": {k: v / 1e3 / steps for k, v in
                                    sorted(by_cat.items(), key=lambda kv: -kv[1])},
    }
    print(json.dumps(summary), flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / steps:9.3f} ms/step  {100 * us / total_us:5.1f} %  {name[:110]}")


def k1_report(dev: torch.device, n: int = 20) -> None:
    """K1's own device time per launch (the profiler's kernel durations)
    over ``n`` launches at each of ``chip_smoke.kernel_cases()``."""
    g = torch.Generator().manual_seed(0)
    for hc, b, t in kernel_cases():
        args = mel_args(hc)
        y = (torch.randn((b, t), generator=g) * 0.3).to(dev)
        us = own_kernel_us(lambda: mel_kernel.mel_spectrogram_kernel(y, *args), n=n)
        print(json.dumps({"window": "K1", "shape": [b, t], "n_fft": hc.n_fft, "launches": n,
                          "records": len(us), "kernel_us_mean": float(np.mean(us)), "kernel_us_min": min(us),
                          "kernel_us_max": max(us)}), flush=True)


def k1_records_probe(dev: torch.device, repeats: int = 3, n: int = 20) -> None:
    """How many of ``n`` K1 launches ``torch.profiler`` keeps at each of
    ``chip_smoke.kernel_cases()``, ``repeats`` windows each, with the window
    closed right after the synchronize (as ``own_kernel_us`` closed it) and
    closed after a 0.2 s wait, and with a fresh ``y`` (first calls of a
    config) or a warm one."""
    g = torch.Generator().manual_seed(0)
    for hc, b, t in kernel_cases():
        args = mel_args(hc)
        y = (torch.randn((b, t), generator=g) * 0.3).to(dev)
        kern = lambda: mel_kernel.mel_spectrogram_kernel(y, *args)  # noqa: E731
        counts = {}
        for settle_s in (0.0, 0.2):
            kept = []
            for _ in range(repeats):
                for _ in range(3):
                    kern()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(n):
                        kern()
                    torch.cuda.synchronize()
                    time.sleep(settle_s)
                kept.append(sum("log_mel_fft_kernel" in e.name()
                                for e in prof.profiler.kineto_results.events()))
            counts[f"settle_{settle_s}s"] = kept
        print(json.dumps({"window": "K1 records", "shape": [b, t], "n_fft": hc.n_fft,
                          "launches": n, "records": counts}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    mel_kernel._launcher()  # build K1 before the timed windows
    dev = torch.device("cuda")
    k1_report(dev)
    h = VocoderConfig()
    trainer = GANTrainer(h, device=dev, seed=h.seed)
    g = torch.Generator().manual_seed(1)
    batches = [synthetic_batch(h, g, dev) for _ in range(4)]
    for batch in batches[:2]:
        trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[2:]:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    report("train_step b64 x 8960", prof, wall_ms, 2)

    engine = VocoderEngine(h, trainer.gen.state_dict(), device=dev)
    rng = np.random.default_rng(3)
    code = rng.integers(0, h.num_embeddings, (8, 1024))
    f0 = rng.normal(0, 1, (8, 1024, 1)).astype(np.float32)
    spkr = rng.integers(0, 100, (8, 1))
    engine.synthesize_batch(code, f0, spkr)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.synthesize_batch(code, f0, spkr)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    report("serve batch 8 x 1024 frames", prof, wall_ms, 1)

    m = build_convert_models(h, trainer.gen.state_dict(), dev)
    rng = np.random.default_rng(4)
    for _ in range(2):
        convert_stages(m, *bench_inputs(rng))
    wavs, names = bench_inputs(rng)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, stage_ms = convert_stages(m, wavs, names)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print(json.dumps({"window": "convert stages", "encode_ms": stage_ms[0],
                      "prosody_ms": stage_ms[1], "vocode_ms": stage_ms[2]}), flush=True)
    report("convert 8 x 10.24 s (units, prosody, vocoder)", prof, wall_ms, 1)
    del m, engine, trainer
    torch.cuda.empty_cache()
    quantizer_window(dev)
    ecapa_window(dev)
    return 0


def quantizer_window(dev: torch.device) -> None:
    """Ten F0 quantizer train steps at ``DEFAULT_F0_PARAMS``, batch 16 x 112
    frames, after ten warm-up steps."""
    model = Quantizer(**qt.DEFAULT_F0_PARAMS, generator=torch.Generator().manual_seed(5)).to(dev)
    state = qt.QuantizerState(model, qt.make_optimizer(model, 2e-4), 0)
    step, _ = qt.make_quantizer_steps(0.02)
    f0 = torch.as_tensor(np.random.default_rng(5).uniform(80, 250, (16, 1, 112))
                         .astype(np.float32), device=dev)
    vq_rng = torch.Generator(device=dev).manual_seed(5)
    for _ in range(10):
        state, _ = step(state, f0, vq_rng)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            state, _ = step(state, f0, vq_rng)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    report("F0 quantizer train step b16 x 112 frames", prof, wall_ms, 10)


def ecapa_window(dev: torch.device) -> None:
    """Ten ECAPA-TDNN embeddings at ``EcapaConfig()`` of a 3 s waveform
    (fbank and forward), after two warm-up calls."""
    sd = EcapaTDNN(EcapaConfig(), generator=torch.Generator().manual_seed(6)).state_dict()
    embedder = EcapaEmbedder(sd, device=dev)
    wav = (np.random.default_rng(6).standard_normal(48000) * 0.1).astype(np.float32)
    for _ in range(2):
        embedder(wav)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            embedder(wav)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    report("ECAPA-TDNN embedding of 3 s", prof, wall_ms, 10)


if __name__ == "__main__":
    sys.exit(main())
