"""Run the PyTorch port's vocoder slice on one CUDA card and check it.

    python3 chip_smoke.py

Phases, at the full width of ``VocoderConfig()`` (the reference
``hubert100_lut.json``: 512 initial channels, rates 5*4*4*2*2, MRF
(3, 7, 11) x (1, 3, 5), 8960-sample segments at batch 64), with weights
drawn from a fixed seed:

1. set-up: the card's name and power limit, TF32 off for cuBLAS and
   cuDNN, and the build of every CUDA kernel from ``dissc_tpu_torch/csrc``;
2. kernels: each kernel against its plain PyTorch version on the card
   (forward and gradient, stated tolerances) and timed beside it;
3. train: two steps of a small config held against the CPU path, then
   GAN train steps and one validation step through ``GANTrainer`` at full
   width, with the launch counters set to 0 just before and read just after;
4. serve: ``VocoderEngine`` built from the trained generator answers
   requests across the frame buckets plus one that streams, checked
   against exact-length and monolithic forwards and against the CPU.

It exits non-zero on any failure and without a card.  The line before
the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from dissc_tpu_torch.audio.mel import mel_filterbank, mel_spectrogram
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.infer.streaming import receptive_field_frames
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.kernels import mel_kernel
from dissc_tpu_torch.train.vocoder_trainer import GANTrainer

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync_time_ms(fn, n: int = 20) -> float:
    """Mean device time of ``fn`` over ``n`` launches (CUDA events, warmed)."""
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


def mel_bound_ms(b: int, t: int, h: VocoderConfig):
    """Least time for one log-mel of ``[b, t]`` and what sets it, the larger
    of two: the operations the function needs at the fp32 peak, per frame a
    windowed real FFT (n_fft multiplies + 2.5 n_fft log2 n_fft), the
    magnitudes (4 per bin), the mel projection over the filters' non-zero
    weights only (2 each) and the log (1 per mel); or the bytes, the
    waveform read once, the log-mel written once and the window and the
    non-zero mel weights read once.  K1 itself does a dense DFT as two
    matrix products, some 70x these operations."""
    freq = h.n_fft // 2 + 1
    frames = b * (1 + (t + 2 * ((h.n_fft - h.hop_size) // 2) - h.n_fft) // h.hop_size)
    mel_nnz = int(np.count_nonzero(mel_filterbank(h.sampling_rate, h.n_fft, h.num_mels,
                                                  float(h.fmin), h.fmax_for_loss)))
    per_frame = (h.n_fft + 2.5 * h.n_fft * np.log2(h.n_fft) + 4 * freq + 2 * mel_nnz
                 + h.num_mels)
    nbytes = 4.0 * (b * t + frames * h.num_mels + h.win_size + mel_nnz)
    t_ops, t_bytes = frames * per_frame / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * float(max(t_ops, t_bytes)), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(h: VocoderConfig, dev: torch.device) -> dict:
    """K1 vs the plain chain: forward atol 2e-4 / rtol 1e-4 (tests/test_kernels.py);
    gradient of mean|mel| within atol 1e-6 and within 1e-3 of its largest
    entry (its entries shrink with the element count of the mean), and not
    all zero; timed plain, kernel, kernel, plain."""
    args = (h.n_fft, h.num_mels, h.sampling_rate, h.hop_size, h.win_size, float(h.fmin),
            h.fmax_for_loss)
    g = torch.Generator().manual_seed(0)
    row = {}
    for b, t in [(h.batch_size, h.segment_size), (2, 40960)]:
        y = ((torch.randn((b, t), generator=g) * 0.3).clamp(-1, 1)).to(dev)
        out = mel_kernel.mel_spectrogram_kernel(y, *args)
        ref = mel_spectrogram(y, *args)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        check(out.shape == ref.shape, f"mel shape {tuple(out.shape)} vs {tuple(ref.shape)}")
        check(bool(torch.isfinite(out).all()), "mel kernel output finite")
        check(bool((err <= 2e-4 + 1e-4 * ref.abs()).all()), f"mel forward at {(b, t)}")

        yk = y.clone().requires_grad_(True)
        mel_kernel.mel_spectrogram_grad(yk, *args).abs().mean().backward()
        yp = y.clone().requires_grad_(True)
        mel_spectrogram(yp, *args).abs().mean().backward()
        grad_err = float((yk.grad - yp.grad).abs().max())
        grad_max = float(yp.grad.abs().max())
        check(float(yk.grad.abs().max()) > 0, f"mel gradient at {(b, t)} is not all zero")
        check(grad_err <= min(1e-6, 1e-3 * grad_max),
              f"mel gradient at {(b, t)}: {grad_err} (largest entry {grad_max})")

        plain = lambda: mel_spectrogram(y, *args)
        kern = lambda: mel_kernel.mel_spectrogram_kernel(y, *args)
        p1, k1, k2, p2 = (sync_time_ms(f) for f in (plain, kern, kern, plain))
        bound_ms, bound_by = mel_bound_ms(b, t, h)
        shape_row = {"shape": [b, t], "max_abs_err": float(err.max()),
                     "grad_max_abs_err": grad_err, "grad_max_abs": grad_max,
                     "ms": (k1 + k2) / 2,
                     "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms, "bound_by": bound_by,
                     "ms_turns": [p1, k1, k2, p2]}
        print("mel kernel", json.dumps(shape_row), flush=True)
        if not row:
            row = shape_row  # the train shape is the main path's
    return row


def synthetic_batch(h: VocoderConfig, g: torch.Generator, dev: torch.device) -> dict:
    """A batch shaped as bench.py's train-step batches."""
    frames = h.segment_size // h.code_hop_size
    b = h.batch_size
    return {"code": torch.randint(0, h.num_embeddings, (b, frames), generator=g).to(dev),
            "f0": torch.randn((b, frames, 1), generator=g).to(dev),
            "spkr": torch.randint(0, 100, (b, 1), generator=g).to(dev),
            "audio": (torch.randn((b, h.segment_size), generator=g) * 0.3).to(dev)}


def train_reference_check(dev: torch.device) -> None:
    """Two GAN steps of a small config on the card against the same steps
    on the CPU (plain mel chain, CPU convolutions), from the same seed.
    Losses rtol 1e-3: AdamW's first update is about lr * sign(grad), so a
    gradient entry at float-noise level can move a weight by up to 2 lr."""
    h = VocoderConfig(upsample_initial_channel=32, embedding_dim=8, model_in_dim=17,
                      segment_size=1280, batch_size=2, mpd_periods=(2, 3), msd_scales=2)
    g = torch.Generator().manual_seed(5)
    batches = [synthetic_batch(h, g, torch.device("cpu")) for _ in range(2)]
    runs = []
    for d in (torch.device("cpu"), dev):
        trainer = GANTrainer(h, device=d, seed=h.seed)
        runs.append([{k: float(v) for k, v in trainer.train_step(b).items()}
                     for b in batches])
    worst = 0.0
    for cpu_m, card_m in zip(*runs):
        for k, ref in cpu_m.items():
            worst = max(worst, abs(card_m[k] - ref) / max(abs(ref), 1e-6))
            check(abs(card_m[k] - ref) <= 1e-3 * abs(ref) + 1e-5,
                  f"{k}: card {card_m[k]} vs CPU {ref}")
    print("train reference: 2 small GAN steps, card vs CPU, worst relative loss error",
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
    mel_row = kernel_phase(h, dev)
    train_reference_check(dev)

    mel_kernel.reset_launch_counts()
    steps = 4
    trainer = train_phase(h, dev, steps)
    launches = mel_kernel.launch_counts["mel_spectrogram"]
    check(launches == 2 * steps + 2, f"mel kernel launches {launches} != 2 per step + 2 (val)")
    serve_phase(h, trainer, dev)

    kernels = [{"name": "mel_spectrogram", "route": "cuda",
                "source": "dissc_tpu_torch/csrc/mel_kernel.cu",
                "replaces": "dissc_tpu/kernels/mel_kernel.py:112",
                "launches": launches, "max_abs_err": mel_row["max_abs_err"],
                "grad_max_abs_err": mel_row["grad_max_abs_err"],
                "ms": mel_row["ms"], "kernel_ms": mel_row["ms"],
                "plain_ms": mel_row["plain_ms"], "bound_ms": mel_row["bound_ms"],
                "bound_by": mel_row["bound_by"], "library_ms": None}]
    print("library_ms: none; no single PyTorch call computes a log-mel spectrogram",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
