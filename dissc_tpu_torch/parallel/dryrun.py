"""Data-parallel phases, each run as its own command (``dissc_tpu.parallel.dryrun``).

    python -m dissc_tpu_torch.parallel.dryrun --phase prosody vq gan \\
        --world 2 --backend gloo --device cpu --out result.npz

Each phase runs on ``--world`` ranks joined by
:func:`~dissc_tpu_torch.parallel.distributed.launch` (``--backend
none``: one process, no group: the plain path the others are held to) and
writes rank 0's arrays to ``--out``, keys prefixed by the phase, for a
caller to compare: a test against the JAX package's one-device step, or
``chip_smoke.py`` one world against another.  It runs as a command so a
spawned rank re-imports this module, never a test module or the caller.

Phases (``--width tiny`` is the JAX dry run's ``tiny_gan_config`` and small
prosody and quantizer widths; ``full`` is ``VocoderConfig()``,
``ProsodyConfig()`` and ``DEFAULT_F0_PARAMS``):

* ``gan``: ``--steps`` SGD steps (lr 1e-3, as the JAX parallel tests: Adam
  would amplify reduction-order noise) of :class:`GANTrainer` on seeded
  global batches of ``--batch`` rows; the generator (gathered whole), MPD
  and MSD after step 1 and at the end, each step's losses, ms a step, peak
  GiB, K1 launches and (under a data group of several ranks) the DDP
  all-reduce time of each step, per rank; ``--control`` trains again with
  cuDNN's heuristic algorithms, for the device's run-to-run spread.
  ``--shard`` (the JAX dry run's): ``dp``, each rank its contiguous block of
  rows; ``tp``, the ranks a ``data`` x ``--model`` grid, each model group
  one block of rows and the generator's wide pair split over it (the log
  counts the split tensors), with each rank's model-group collective time a
  step and the largest gap between its replicated parameters and its model
  group's first rank's; ``replicated``, every rank the whole global batch
  and no group reduction.  Several values run in turn on the same ranks,
  each one's arrays under ``gan/<shard>/``;
* ``prosody``: one SGD step (lr 1e-3 over the global batch's non-pad
  tokens, as the losses are sums over them) of ``LenPredictor``,
  ``PitchPredictor`` and ``PitchPredictorBase`` from numpy-drawn weights on
  a padded batch, with
  masks and PE dropout at rate 0 (``plain/``) and at the config's rates
  (``masked/``), through the trainers' steps: synced BatchNorm, DDP, the
  loss scaled by W; initial and updated states and the metrics summed over
  the ranks;
* ``vq``: one EMA update of a ``BottleneckBlock`` from a given codebook
  whose last code is dead (so it restarts), and one SGD train step of the
  F0 ``Quantizer`` under DDP from a given codebook with a dead code; the
  states before and after;
* ``serving`` (one process): ``VocoderEngine`` and ``ProsodyConverter``
  on one device and split over ``--world`` (cards ``cuda:i`` modulo those
  present, or the CPU ``--world`` times);
* ``multiproc`` (launches its own ranks as torchrun would, through the
  environment): one masked ``LenPredictor`` step on each; every rank must
  report the same loss.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

Arrays = Dict[str, np.ndarray]
GROUP_PHASES = ("prosody", "vq", "gan")
LR = 1e-3
N_SPK = 5


def _log(msg: str) -> None:
    print(f"[dryrun rank {_rank()}] {msg}", flush=True)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _group():
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def _world() -> int:
    return dist.get_world_size() if _group() is not None else 1


def _host(sd: Dict[str, torch.Tensor], prefix: str) -> Arrays:
    return {f"{prefix}/{k}": v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gather(value) -> list:
    """Every rank's ``value`` (a picklable object), in rank order."""
    if _group() is None:
        return [value]
    out = [None] * _world()
    dist.all_gather_object(out, value)
    return out


def numpy_state(model: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """A state dict of numpy draws: weights U(+-1/sqrt(fan_in)), embeddings
    N(0, 1), norm gains U(0.5, 1.5), biases N(0, 0.05); buffers as built."""
    rng = np.random.default_rng(seed)
    params = dict(model.named_parameters())
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k not in params:
            out[k] = v.clone()
        elif k.endswith("emb.weight"):
            out[k] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        elif len(shape) > 1:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            out[k] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
        elif k.split(".")[-2].startswith("bn") and k.endswith("weight"):
            out[k] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            out[k] = torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# gan
# ---------------------------------------------------------------------------


def tiny_gan_config(batch_size: int):
    """The JAX dry run's ``tiny_gan_config``: every component class of the
    GAN step on the smallest graph (2 upsample stages, one MRF branch, MPD
    periods (2, 3), 2 MSD scales, n_fft 32).  ``model_in_dim`` is the
    generator's true input width here (code 16 + speaker 16 + f0 1): flax
    infers it and the JAX config's 17 is never read."""
    from dissc_tpu_torch.core.config import VocoderConfig

    return VocoderConfig(
        upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),), embedding_dim=16,
        model_in_dim=33, code_hop_size=8, segment_size=64, batch_size=batch_size,
        n_fft=32, hop_size=8, win_size=32, num_mels=8, num_freq=17, fmax=None,
        fmax_for_loss=None, mrf_pack_max_ch=0, mpd_periods=(2, 3), msd_scales=2,
        learning_rate=LR)


def gan_config(width: str, batch: int):
    from dissc_tpu_torch.core.config import VocoderConfig

    if width == "tiny":
        return tiny_gan_config(batch)
    return VocoderConfig(batch_size=batch, learning_rate=LR)


def gan_batches(h, steps: int, seed: int = 2) -> List[Arrays]:
    """``steps`` seeded global batches of ``h.batch_size`` rows."""
    rng = np.random.default_rng(seed)
    frames = h.segment_size // h.code_hop_size
    b = h.batch_size
    return [{"code": rng.integers(0, h.num_embeddings, (b, frames)).astype(np.int64),
             "f0": rng.normal(0, 1, (b, frames, 1)).astype(np.float32),
             "spkr": rng.integers(0, 4, (b, 1)).astype(np.int64),
             "audio": rng.uniform(-0.5, 0.5, (b, h.segment_size)).astype(np.float32)}
            for _ in range(steps)]


class CommTimer:
    """A DDP communication hook that runs the default one (divide by the
    size of the group it is registered with, all-reduce over it) and records
    when each bucket's all-reduce was started and finished; :meth:`busy_ms`
    is the union of those spans."""

    def __init__(self):
        self.spans: List[List[float]] = []

    def hook(self, group, bucket):
        buf = bucket.buffer()
        span = [time.perf_counter(), 0.0]
        self.spans.append(span)
        buf.div_(dist.get_world_size(group))
        fut = dist.all_reduce(buf, group=group, async_op=True).get_future()

        def done(f):
            span[1] = time.perf_counter()
            return f.value()[0]

        return fut.then(done)

    def busy_ms(self) -> float:
        total, end = 0.0, None
        for s, e in sorted(tuple(x) for x in self.spans):
            if end is None or s > end:
                total, end = total + e - s, e
            elif e > end:
                total, end = total + e - end, e
        self.spans = []
        return 1e3 * total


def _train_gan(dev: torch.device, h, batches: List[Arrays], grid,
               timer: Optional[CommTimer] = None, save_init: bool = False):
    """SGD steps of a fresh :class:`GANTrainer` on ``grid`` (DDP over its
    data group, the generator split over its model group), on its data
    index's rows of ``batches``: (trainer, arrays of the initial, step-1 and
    final states with the generator gathered whole, losses, ms a step, DDP
    all-reduce ms a step, model-group collective ms a step)."""
    from dissc_tpu_torch.parallel.mesh import shard_rows
    from dissc_tpu_torch.train.vocoder_trainer import GANTrainer

    trainer = GANTrainer(h, device=dev, seed=h.seed, grid=grid)
    trainer.opt_g = torch.optim.SGD(trainer.gen.parameters(), lr=LR)
    trainer.opt_d = torch.optim.SGD(list(trainer.mpd.parameters())
                                    + list(trainer.msd.parameters()), lr=LR)
    if timer is not None:
        for wrapped in (trainer.gen_dp, trainer.disc_dp):
            wrapped.register_comm_hook(trainer.group, timer.hook)
    model_spans = trainer.time_model_comm() if grid.model_group is not None else None
    states: Arrays = {}

    def keep(tag: str) -> None:
        states.update(_host(trainer.generator_state(), f"{tag}/gen"))
        for name in ("mpd", "msd"):
            states.update(_host(getattr(trainer, name).state_dict(), f"{tag}/{name}"))

    if save_init:
        keep("init")
    losses, step_ms, comm_ms, model_ms = [], [], [], []
    for i, batch in enumerate(batches):
        local = {k: torch.from_numpy(v).to(dev) for k, v in
                 shard_rows(batch, grid.data_index, grid.n_data).items()}
        _sync(dev)
        t0 = time.perf_counter()
        m = trainer.train_step(local)
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        comm_ms.append(timer.busy_ms() if timer else 0.0)
        model_ms.append(sum(model_spans) if model_spans is not None else 0.0)
        if model_spans is not None:
            model_spans.clear()
        losses.append([float(v) for v in m.values()])
        if i == 0 and len(batches) > 1:
            keep("step1")
    keep("final")
    states["losses"] = np.asarray(losses, np.float64)
    states["loss_names"] = np.asarray(list(m))
    return trainer, states, step_ms, comm_ms, model_ms


@torch.no_grad()
def replicated_gap(trainer) -> float:
    """The largest difference between this rank's replicated parameters and
    buffers (the generator's unsplit ones, MPD, MSD) and its model group's
    first rank's (0 without a model group)."""
    from dissc_tpu_torch.parallel.tensor import replicated_parameters

    grid = trainer.grid
    if grid.model_group is None:
        return 0.0
    tensors = (replicated_parameters(trainer.gen) + list(trainer.mpd.parameters())
               + list(trainer.msd.parameters()) + list(trainer.msd.buffers()))
    mine = torch.cat([t.detach().reshape(-1) for t in tensors])
    first = mine.clone()
    dist.broadcast(first, src=grid.data_index * grid.n_model, group=grid.model_group)
    return float((mine - first).abs().max())


def _gan_grid(shard: str, n_model: int):
    from dissc_tpu_torch.parallel import distributed

    if shard == "replicated":
        return distributed.LOCAL
    return distributed.grid(n_model if shard == "tp" else 1)


def run_gan_shard(dev: torch.device, args, shard: str) -> Arrays:
    from dissc_tpu_torch.kernels import mel_kernel

    h = gan_config(args.width, args.batch)
    grid = _gan_grid(shard, args.model)
    batches = gan_batches(h, args.steps)
    timer = CommTimer() if grid.data_group is not None and grid.n_data > 1 else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mel_kernel.reset_launch_counts()
    trainer, out, step_ms, comm_ms, model_ms = _train_gan(dev, h, batches, grid, timer,
                                                          args.save_init)
    if trainer.sharded:
        _log(f"gan/{shard}: grid ({grid.n_data}, {grid.n_model}), tensor-sharding "
             f"{len(trainer.sharded)} wide generator kernels over 'model' "
             f"({', '.join(trainer.sharded)}); grads mean over 'data', the replicated ones "
             "over 'model' too")
    gap = replicated_gap(trainer)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    per_rank = _gather({"ms": step_ms, "comm_ms": comm_ms, "model_ms": model_ms,
                        "peak_gib": peak, "k1": mel_kernel.launch_counts["mel_spectrogram"],
                        "gap": gap})
    out.update({
        "ms_per_step": np.asarray([r["ms"] for r in per_rank]),
        "allreduce_ms": np.asarray([r["comm_ms"] for r in per_rank]),
        "model_comm_ms": np.asarray([r["model_ms"] for r in per_rank]),
        "peak_gib": np.asarray([r["peak_gib"] for r in per_rank]),
        "k1_launches": np.asarray([r["k1"] for r in per_rank]),
        "replicated_gap": np.asarray([r["gap"] for r in per_rank]),
        "sharded": np.asarray(trainer.sharded, dtype=str),
        **{f"batch0/{k}": v for k, v in batches[0].items()},
    })
    _log(f"gan/{shard} {args.width} b{h.batch_size} grid ({grid.n_data}, {grid.n_model}): "
         f"losses {out['losses'][-1].tolist()} ms/step {step_ms}")
    if args.control:
        # the same steps again with cuDNN's own choice of algorithms: how far
        # apart two runs of one world land on this device
        del trainer
        _card_math(False)
        _, control, _, _, _ = _train_gan(dev, h, batches, grid)
        _card_math(args.deterministic)
        out.update({f"control/{k}": v for k, v in control.items()
                    if k.startswith("final/") or k == "losses"})
    return out


def run_gan(dev: torch.device, args) -> Arrays:
    if len(args.shard) == 1:
        return run_gan_shard(dev, args, args.shard[0])
    out: Arrays = {}
    for shard in args.shard:
        out.update({f"{shard}/{k}": v for k, v in run_gan_shard(dev, args, shard).items()})
    return out


# ---------------------------------------------------------------------------
# prosody
# ---------------------------------------------------------------------------


def prosody_batch(b: int, length: int, seed: int = 3):
    """A padded global batch: rows of decreasing length, every fourth all
    pad; whitened f0 (the trainers' target), 30 % unvoiced (0)."""
    rng = np.random.default_rng(seed)
    vals = np.full((b, length), 100, np.int64)
    lens = np.full((b, length), -1, np.float32)
    gts = np.full((b, length), -100, np.float32)
    for i in range(b):
        n = 0 if i % 4 == 3 else length - (i * 5) % length
        vals[i, :n] = rng.integers(0, 100, n)
        lens[i, :n] = rng.integers(1, 9, n)
        g = rng.normal(0, 1, n).astype(np.float32)
        g[rng.random(n) < 0.3] = 0
        gts[i, :n] = g
    spk = (np.arange(b) % N_SPK)[:, None].astype(np.int64)
    id2mean = rng.uniform(100, 200, N_SPK).astype(np.float32)
    id2std = rng.uniform(10, 30, N_SPK).astype(np.float32)
    return vals, lens, gts, spk, id2mean, id2std


def run_prosody(dev: torch.device, args, models=("len", "new", "base"),
                maskings=(False, True)) -> Arrays:
    from dissc_tpu_torch.core.config import ProsodyConfig
    from dissc_tpu_torch.models.prosody import LenPredictor
    from dissc_tpu_torch.parallel.mesh import shard_rows
    from dissc_tpu_torch.train import prosody_trainer as pt

    rank, world, group = _rank(), _world(), _group()
    full = args.width == "full"
    cfg = ProsodyConfig() if full else ProsodyConfig(emb_size=8, hidden=16)
    length = 128 if full else 12
    vals, lens, gts, spk, id2mean, id2std = prosody_batch(args.step_batch, length)
    out: Arrays = {"batch/vals": vals, "batch/lens": lens, "batch/gts": gts, "batch/spk": spk,
                   "id2mean": id2mean, "id2std": id2std}
    mine = shard_rows((vals, lens, gts, spk), rank, world)
    dtype = getattr(torch, args.dtype)

    def t(a):
        x = torch.from_numpy(a).to(dev)
        return x.to(dtype) if x.is_floating_point() else x

    norm_stats = (4.0, 2.0)
    for masking in maskings:
        for i, name in enumerate(models):
            tag = f"{'masked' if masking else 'plain'}/{name}"
            if name == "len":
                model = LenPredictor(100, N_SPK, emb_size=cfg.emb_size, hidden=cfg.hidden,
                                     masking_rate=cfg.len_masking_rate if masking else 0.0)
            else:
                model = pt.build_pitch_model(name, 100, N_SPK, ProsodyConfig(
                    emb_size=cfg.emb_size, hidden=cfg.hidden,
                    pitch_masking_rate=cfg.pitch_masking_rate if masking else 0.0))
                if model.pe is not None and not masking:
                    model.pe.dropout = 0.0
            model.load_state_dict(numpy_state(model, seed=10 + i))
            model.to(dev, dtype)
            out.update(_host(model.state_dict(), f"{tag}/init"))
            # the losses are sums over the batch's tokens: lr 1e-3 a token
            tokens = int((vals != 100).sum() if name == "len" else (gts != -100).sum())
            out[f"{tag}/lr"] = np.asarray(LR / tokens)
            opt = torch.optim.SGD(model.parameters(), lr=LR / tokens)
            gen = torch.Generator(device=dev).manual_seed(7)
            if name == "len":
                step, _ = pt.make_len_steps(model, norm_stats, opt, -1.0, gen, group)
                metrics = step(t(mine[0]), t(mine[1]), t(mine[3]))
            else:
                step, _ = pt.make_pitch_steps(model, t(id2mean), t(id2std), opt, -100.0, gen,
                                              group)
                metrics = step(t(mine[0]), t(mine[2]), t(mine[3]))
            keys = sorted(metrics)
            sums = torch.stack([metrics[k].double() for k in keys])
            if group is not None:
                dist.all_reduce(sums, group=group)
            out.update({f"{tag}/metrics/{k}": np.asarray(v)
                        for k, v in zip(keys, sums.tolist())})
            out.update(_host(model.state_dict(), f"{tag}/final"))
    return out


# ---------------------------------------------------------------------------
# vq
# ---------------------------------------------------------------------------

SMALL_QP = dict(
    f0_encoder_params=dict(input_emb_width=1, output_emb_width=8, levels=1, downs_t=[4],
                           strides_t=[2], width=8, depth=2, m_conv=1.0,
                           dilation_growth_rate=3),
    f0_vq_params=dict(l_bins=6, emb_width=8, mu=0.99, levels=1),
    f0_decoder_params=dict(input_emb_width=1, output_emb_width=8, levels=1, downs_t=[4],
                           strides_t=[2], width=8, depth=2, m_conv=1.0,
                           dilation_growth_rate=3, reverse_decoder_dilation=True),
)


def given_codebook(rows: np.ndarray, k_bins: int, seed: int, counts: float = 5.0) -> Arrays:
    """A codebook near ``rows`` (data rows plus noise), EMA sums to match and
    counts ``counts``, except the last code: far from every row, with count
    1, so after one update (mu 0.9 or 0.99) it falls under the threshold
    and restarts."""
    rng = np.random.default_rng(seed)
    k = rows[rng.choice(len(rows), k_bins, replace=False)] + rng.normal(0, 0.05, (k_bins,
                                                                                  rows.shape[1]))
    k[-1] = 100.0
    elem = np.full(k_bins, counts)
    elem[-1] = 1.0
    return {"k": k.astype(np.float32), "k_sum": (k * elem[:, None]).astype(np.float32),
            "k_elem": elem.astype(np.float32), "initted": np.asarray(True)}


def _load_block(blk, state: Arrays) -> None:
    blk.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})


def run_vq(dev: torch.device, args) -> Arrays:
    from dissc_tpu_torch.models.vq import BottleneckBlock, Quantizer
    from dissc_tpu_torch.parallel.mesh import shard_rows
    from dissc_tpu_torch.train import quantizer_trainer as qt
    from torch.nn.parallel import DistributedDataParallel

    rank, world, group = _rank(), _world(), _group()
    out: Arrays = {}
    # (1) one EMA update of a block, [B, D, T] rows; codes 4, width 6, mu 0.9
    x = np.random.default_rng(1).standard_normal((args.step_batch, 6, 4)).astype(np.float32)
    state = given_codebook(x.transpose(0, 2, 1).reshape(-1, 6), 4, seed=2)
    dtype = getattr(torch, args.dtype)
    blk = BottleneckBlock(4, 6, 0.9, group=group).to(dev, dtype)
    _load_block(blk, state)
    gen = torch.Generator(device=dev).manual_seed(5)
    codes, _, _, metrics = blk(torch.from_numpy(shard_rows(x, rank, world)).to(dev, dtype),
                               generator=gen)
    out.update({"block/x": x, **{f"block/init/{k}": np.asarray(v) for k, v in state.items()}})
    out.update(_host(blk.state_dict(), "block/final"))
    out["block/codes"] = np.concatenate(_gather(codes.cpu().numpy()))
    out.update({f"block/metrics/{k}": np.asarray(float(v)) for k, v in metrics.items()})

    # (2) one train step of the quantizer under DDP, a dead code restarting
    qp = qt.DEFAULT_F0_PARAMS if args.width == "full" else SMALL_QP
    frames = 112 if args.width == "full" else 32
    f0 = np.random.default_rng(3).uniform(-1, 1, (args.step_batch, 1, frames)).astype(np.float32)
    model = Quantizer(**qp, generator=torch.Generator().manual_seed(4),
                      group=group).to(dev, dtype)
    with torch.no_grad():
        enc = model.encoder(torch.from_numpy(f0).to(dev, dtype))[0]  # the global batch
    d = enc.shape[1]
    level = model.vq.level_blocks[0]
    _load_block(level, given_codebook(enc.permute(0, 2, 1).reshape(-1, d).cpu().numpy(),
                                      level.k_bins, seed=6))
    out.update(_host(model.state_dict(), "quantizer/init"))
    net = (None if group is None else
           DistributedDataParallel(model, process_group=group, broadcast_buffers=False))
    qstate = qt.QuantizerState(model, torch.optim.SGD(model.parameters(), lr=LR), 0, net)
    step, _ = qt.make_quantizer_steps(0.02)
    qstate, qm = step(qstate, torch.from_numpy(shard_rows(f0, rank, world)).to(dev, dtype),
                      torch.Generator(device=dev).manual_seed(8))
    out.update(_host(model.state_dict(), "quantizer/final"))
    out["quantizer/f0"] = f0
    out["quantizer/usage"] = np.asarray(float(qm["usage"]))
    _log(f"vq: block usage {float(metrics['usage'])}, quantizer usage {float(qm['usage'])}")
    return out


# ---------------------------------------------------------------------------
# serving (one process)
# ---------------------------------------------------------------------------


def serving_devices(device: str, world: int) -> List[str]:
    if device == "cuda":
        n = torch.cuda.device_count()
        return [f"cuda:{i % n}" for i in range(world)]
    return ["cpu"] * world


def run_serving(args) -> Arrays:
    from dissc_tpu_torch.infer.prosody import ProsodyConverter
    from dissc_tpu_torch.infer.vocoder import VocoderEngine
    from dissc_tpu_torch.models.prosody import LenPredictor
    from dissc_tpu_torch.train.prosody_trainer import build_pitch_model
    from dissc_tpu_torch.train.vocoder_trainer import make_models

    devices = serving_devices(args.device, args.world)
    h = gan_config(args.width, 2)
    state = make_models(h, seed=3)[0].state_dict()
    rng = np.random.default_rng(4)
    lengths = ([100, 300, 700, 64, 2000, 150, 1200, 2600, 500] if args.width == "full"
               else [int(n) for n in rng.integers(4, 40, 7)] + [90])
    items = [{"code": rng.integers(0, h.num_embeddings, n),
              "f0": rng.normal(0, 1, (n, 1)).astype(np.float32),
              "spkr": rng.integers(0, 4, 1)} for n in lengths]
    buckets = (64, 128, 256, 512, 1024, 2048) if args.width == "full" else (8, 16, 32, 64)
    one = VocoderEngine(h, state, frame_buckets=buckets, device=devices[0])
    split = VocoderEngine(h, state, frame_buckets=buckets, devices=devices)
    w1, _ = one.synthesize_utterances(items, batch_size=len(items))
    wn, _ = split.synthesize_utterances(items, batch_size=len(items))
    out: Arrays = {}
    for i, (a, b) in enumerate(zip(w1, wn)):
        out[f"wave_one/{i}"], out[f"wave_split/{i}"] = a, b

    convs = []
    for devs in ([devices[0]], devices):
        conv = ProsodyConverter(devices=devs)
        gen = torch.Generator().manual_seed(5)
        conv.set_models(len_model=LenPredictor(100, N_SPK, generator=gen),
                        len_norm_stats=(4.0, 2.0),
                        pitch_model=build_pitch_model("new", 100, N_SPK, generator=gen))
        conv.id2pitch_mean = np.linspace(100, 200, N_SPK).astype(np.float32)
        conv.id2pitch_std = np.linspace(10, 30, N_SPK).astype(np.float32)
        convs.append(conv)
    records = [{"units": [int(u) for u in rng.integers(0, 100, n)], "f0": [0.0] * n,
                "audio": f"s{i % N_SPK}_{i}.wav"} for i, n in enumerate(rng.integers(5, 60, 8))]
    spk = {f"s{i}": i for i in range(N_SPK)}
    for tag, conv in zip(("one", "split"), convs):
        for i, rec in enumerate(conv.convert_records(records, spk, batch_size=8)):
            out[f"prosody_{tag}/{i}/units"] = np.asarray(rec["units"])
            out[f"prosody_{tag}/{i}/f0"] = np.asarray(rec["f0"], np.float32)
    _log(f"serving over {devices}: {len(items)} utterances, {len(records)} records")
    return out


# ---------------------------------------------------------------------------
# multiproc: ranks started through the environment, as torchrun starts them
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multiproc(args) -> Arrays:
    port = free_port()
    procs = []
    for r in range(args.world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(args.world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dissc_tpu_torch.parallel.dryrun", "--phase",
             "multiproc-worker", "--device", args.device, "--width", args.width,
             "--step-batch", str(args.step_batch)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, text) in enumerate(zip(procs, outs)):
        print("".join(f"  <rank {r}> {line}\n" for line in text.splitlines()), end="")
        if p.returncode:
            raise RuntimeError(f"multiproc rank {r} exited {p.returncode}")
    losses = [line.rsplit("loss=", 1)[1] for text in outs for line in text.splitlines()
              if "OK loss=" in line]
    if len(losses) != args.world or len(set(losses)) != 1:
        raise RuntimeError(f"the ranks disagree on the step's loss: {losses}")
    print(f"multiproc: {args.world} ranks agree, loss={losses[0]}", flush=True)
    return {"loss": np.asarray(float(losses[0]))}


def run_multiproc_worker(args) -> None:
    from dissc_tpu_torch.parallel import distributed

    dev = distributed.initialize(args.device)
    try:
        out = run_prosody(dev, args, models=("len",), maskings=(True,))
        print(f"OK loss={float(out['masked/len/metrics/Loss']):.9g}", flush=True)
    finally:
        distributed.destroy()


# ---------------------------------------------------------------------------


RUNNERS = {"prosody": run_prosody, "vq": run_vq, "gan": run_gan}


def _card_math(deterministic: bool) -> None:
    """Full float32 (TF32 off, as ``resolve_device`` sets it) and, when
    asked, cuDNN's deterministic algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False


def _ranks(dev: torch.device, args) -> None:
    """Every rank: the group phases in order; rank 0 writes the arrays."""
    if dev.type == "cuda":
        _card_math(args.deterministic)  # a spawned rank starts with the defaults
    out: Arrays = {}
    for phase in args.phase:
        if phase in RUNNERS:
            out.update({f"{phase}/{k}": v for k, v in RUNNERS[phase](dev, args).items()})
    if _rank() == 0 and args.out:
        np.savez(args.out, **out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--phase", nargs="+", required=True,
                        choices=[*GROUP_PHASES, "serving", "multiproc", "multiproc-worker"])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--backend", default="gloo", choices=["gloo", "nccl", "none"])
    parser.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    parser.add_argument("--width", default="tiny", choices=["tiny", "full"])
    parser.add_argument("--batch", type=int, default=8,
                        help="the global batch of the gan phase")
    parser.add_argument("--step-batch", type=int, default=8,
                        help="the global batch of the prosody and vq phases")
    parser.add_argument("--steps", type=int, default=1, help="gan: train steps")
    parser.add_argument("--shard", nargs="+", default=["dp"],
                        choices=["dp", "tp", "replicated"],
                        help="gan: data parallel; tensor parallel over a data x --model "
                             "grid; or every rank the whole batch, nothing reduced")
    parser.add_argument("--model", type=int, default=1,
                        help="gan --shard tp: the model extent (it divides --world)")
    parser.add_argument("--save-init", action="store_true",
                        help="gan: write the initial weights too")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                        help="prosody and vq: the models' and batches' float type")
    parser.add_argument("--control", action="store_true",
                        help="gan: train again with cuDNN's heuristic algorithms (the "
                             "device's run-to-run spread)")
    parser.add_argument("--deterministic", action="store_true",
                        help="cuDNN's deterministic algorithms, so that one world's "
                             "steps repeat bit for bit")
    parser.add_argument("--out", default=None, help="npz file for rank 0's arrays")
    args = parser.parse_args(argv)
    if args.model < 1 or args.world % args.model:
        parser.error(f"--model {args.model} does not divide --world {args.world}")
    if args.model > 1 and "tp" not in args.shard:
        parser.error("--model above 1 takes --shard tp")
    if args.device == "cuda":
        _card_math(args.deterministic)
    if args.phase == ["multiproc-worker"]:
        run_multiproc_worker(args)
        return 0
    t0 = time.perf_counter()
    out: Arrays = {}
    for phase in [p for p in args.phase if p not in GROUP_PHASES]:
        runner = run_serving if phase == "serving" else run_multiproc
        out.update({f"{phase}/{k}": v for k, v in runner(args).items()})
    group_phases = [p for p in args.phase if p in GROUP_PHASES]
    if group_phases:
        from dissc_tpu_torch.parallel import distributed

        ranks_out = args.out + ".ranks.npz" if args.out else None
        rank_args = argparse.Namespace(**{**vars(args), "phase": group_phases,
                                          "out": ranks_out})
        if args.backend == "none":
            if args.world != 1:
                parser.error("--backend none runs one process: --world 1")
            _ranks(torch.device(args.device), rank_args)
        else:
            distributed.launch(_ranks, args.world, (rank_args,), device=args.device,
                               backend=args.backend)
        if ranks_out and not out:
            os.replace(ranks_out, args.out)
        elif ranks_out:
            with np.load(ranks_out) as ranks:
                out.update(dict(ranks))
            os.remove(ranks_out)
    if args.out and out:
        np.savez(args.out, **out)
    print(json.dumps({"dryrun": args.phase, "world": args.world, "backend": args.backend,
                      "device": args.device, "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
