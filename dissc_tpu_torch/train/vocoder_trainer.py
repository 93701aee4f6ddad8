"""HiFi-GAN vocoder trainer (``dissc_tpu.train.vocoder_trainer``): the GAN
step (:class:`GANTrainer`) and the file-level loop (:func:`train_vocoder`).

Step semantics follow the reference order (``sr/train.py:140-191``):

1. generator forward on the segment batch, once;
2. D step: MPD + MSD LS-GAN loss on ``(y, y_hat.detach())``, AdamW update;
3. G step against the *updated* discriminators: LS-GAN adversarial +
   feature-match + 45 x mel-L1, AdamW update.  The discriminators'
   parameters do not take gradients in this step (the JAX step
   differentiates with respect to ``y_hat`` only).

The MSD's spectral-norm ``u`` advances on every call in train mode: real
then fake pass in the D step, and again in the G step, as in the JAX
step and the reference.

Both optimizers are ``torch.optim.AdamW(lr, (b1, b2), eps=1e-8,
weight_decay=0.01)``, which is ``optax.adamw(..., weight_decay=0.01)``.
The mel function is picked by config, as ``_pick_mel_fn`` picks: on the
card with ``hop | n_fft`` and ``win <= n_fft`` it is the fused kernel
(:func:`~dissc_tpu_torch.kernels.mel_kernel.mel_spectrogram_grad`, two
launches per step), otherwise the plain chain.  Synthetic or preloaded
batches are dicts of tensors: ``code [B, T]``, ``f0 [B, T, 1]`` (optional),
``spkr [B, 1]``, ``audio [B, T*320]``.

:func:`train_vocoder` is the JAX loop (``dissc_tpu/train/vocoder_trainer.py:244-450``):
a :class:`~dissc_tpu_torch.data.code_dataset.CodeDataset` over the
manifests, batches prefetched on a host thread (:class:`Prefetcher`) and
copied to the card from pinned memory, the learning rate decayed per epoch
as ``optax.exponential_decay(lr, steps_per_epoch, lr_decay,
staircase=True)`` counted in optimizer steps (:func:`lr_at`), ``g_<08d>``
and ``do_<08d>`` checkpoints, resume from the latest by name sort, and
validation with a batch sized to the validation split.  ``g_`` holds the
generator as the JAX package's tree (so either package serves it);
``do_`` holds the discriminators as JAX trees, each torch optimizer's
``state_dict`` as a numpy tree, the step and the epoch.  A JAX ``do_``
(optax states) cannot be resumed here: unpickling it needs ``optax``.

Data parallelism (the reference's NCCL DDP, ``sr/train.py:72-79``; the JAX
loop's mesh, ``dissc_tpu/train/vocoder_trainer.py:380-388``): under a
process group :class:`GANTrainer` runs the generator forward through DDP
and the D step through one DDP wrapper of MPD and MSD; the G step calls
the unwrapped discriminators, whose parameters it freezes, so no reducer
waits on them.  Every loss is a batch mean, so DDP's averaged gradient is
the global batch's.  :func:`train_vocoder` feeds each rank
``batch_size // W`` rows of its strided share of the epoch
(``CodeDataset.batches(process_index, process_count)``), keeps the
one-device ``steps_per_epoch`` and learning-rate schedule, and leaves the
``id_to_spkr.pkl``, checkpoints, logs and validation (over the whole val
split) to rank 0.  Checkpoints hold the unwrapped modules, so their layout
is the same at any W.

Reference behaviour mirrored on purpose: there is no VQ commit loss in
the vocoder trainer (the config refuses the VQ paths).
"""
from __future__ import annotations

import contextlib
import functools
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from dissc_tpu_torch.audio.mel import mel_spectrogram
from dissc_tpu_torch.compat.from_jax import (generator_state_dict, mpd_state_dict,
                                             msd_state_dict)
from dissc_tpu_torch.compat.to_jax import generator_tree, mpd_tree, msd_trees
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.data.code_dataset import CodeDataset, get_dataset_filelist
from dissc_tpu_torch.data.stats import load_f0_stats, save_id_to_spkr
from dissc_tpu_torch.device import DeviceLike, generator_for, resolve_device
from dissc_tpu_torch.kernels.mel_kernel import mel_spectrogram_grad
from dissc_tpu_torch.losses.gan import discriminator_loss, feature_loss, generator_loss
from dissc_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                   MultiScaleDiscriminator)
from dissc_tpu_torch.models.hifigan import CodeGenerator, refuse_f0_vq
from dissc_tpu_torch.parallel import distributed
from dissc_tpu_torch.parallel.collectives import pmean_if
from dissc_tpu_torch.parallel.mesh import local_batch_slice
from dissc_tpu_torch.train.checkpoints import (load_checkpoint, save_checkpoint,
                                               scan_checkpoint, step_checkpoint_name)
from dissc_tpu_torch.train.logging import MetricLogger

Batch = Dict[str, torch.Tensor]
MAX_VAL_BATCHES = 10  # validation batches per validation (the JAX loop's cap)
PREFETCH_DEPTH = 2  # batches the host thread runs ahead of the loop


def make_models(h: VocoderConfig, seed: Optional[int] = None
                ) -> Tuple[CodeGenerator, MultiPeriodDiscriminator, MultiScaleDiscriminator]:
    """Generator, MPD and MSD with weights drawn from one seeded generator."""
    g = generator_for(h.seed if seed is None else seed)
    return (CodeGenerator(h, generator=g),
            MultiPeriodDiscriminator(tuple(h.mpd_periods or (2, 3, 5, 7, 11)), generator=g),
            MultiScaleDiscriminator(int(h.msd_scales or 3), generator=g))


def pick_mel_fn(h: VocoderConfig, device: torch.device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The mel-loss function for ``device``, chosen by config alone, by the
    JAX ``_pick_mel_fn``'s test: the fused kernel on the card when
    ``hop | n_fft`` and ``win <= n_fft``, else the plain chain.  The kernel
    takes each such config up to ``n_fft`` 4096 (``kernel_supports``) and
    raises for a larger one; no config it is sent falls back to the plain
    chain."""
    use_kernel = (device.type == "cuda" and h.n_fft % h.hop_size == 0
                  and h.win_size <= h.n_fft)
    return functools.partial(mel_spectrogram_grad if use_kernel else mel_spectrogram,
                             n_fft=h.n_fft, num_mels=h.num_mels,
                             sampling_rate=h.sampling_rate, hop_size=h.hop_size,
                             win_size=h.win_size, fmin=float(h.fmin), fmax=h.fmax_for_loss)


@contextlib.contextmanager
def _frozen(*modules: nn.Module):
    """Parameters of ``modules`` take no gradient inside the block."""
    params = [p for m in modules for p in m.parameters()]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class Discriminators(nn.Module):
    """MPD and MSD as one module, so the D step runs through one DDP wrapper."""

    def __init__(self, mpd: MultiPeriodDiscriminator, msd: MultiScaleDiscriminator):
        super().__init__()
        self.mpd, self.msd = mpd, msd

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        return self.mpd(y, y_hat), self.msd(y, y_hat)


def lr_at(h: VocoderConfig, step: int, steps_per_epoch: Optional[int]) -> float:
    """The learning rate of optimizer step ``step`` (0-based, optax's
    ``count``): ``lr * lr_decay ** (step // steps_per_epoch)``, which is
    ``optax.exponential_decay(lr, steps_per_epoch, lr_decay, staircase=True)``;
    ``steps_per_epoch=None`` keeps ``lr``."""
    if steps_per_epoch is None:
        return h.learning_rate
    return h.learning_rate * h.lr_decay ** (step // steps_per_epoch)


class GANTrainer:
    """Two-optimizer GAN training state and its step.

    ``device=None`` runs on the CUDA card and raises without one;
    ``device="cpu"`` runs the plain path on the CPU.  ``steps_per_epoch``
    decays the learning rate per epoch (:func:`lr_at`); ``None`` trains at
    the constant ``h.learning_rate``.  Each optimizer always holds the rate
    of its next update.

    Under a process group the step runs DDP over its ranks: ``gen``,
    ``mpd`` and ``msd`` stay the unwrapped modules; ``gen_dp`` and
    ``disc_dp`` are what the step's forwards call (the DDP wrappers, or
    the modules themselves without a group).  The losses it returns are
    then the means over the ranks.
    """

    def __init__(self, h: VocoderConfig, device: DeviceLike = None,
                 seed: Optional[int] = None, steps_per_epoch: Optional[int] = None):
        refuse_f0_vq(h, "GANTrainer")
        self.h = h
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.gen, self.mpd, self.msd = (m.to(self.device) for m in make_models(h, seed))
        self.group = dist.group.WORLD if distributed.is_initialized() else None
        self.gen_dp: nn.Module = self.gen
        self.disc_dp: nn.Module = Discriminators(self.mpd, self.msd)
        if self.group is not None:
            # the spectral-norm vectors agree on every rank by construction
            wrap = functools.partial(DistributedDataParallel, process_group=self.group,
                                     broadcast_buffers=False)
            self.gen_dp, self.disc_dp = wrap(self.gen_dp), wrap(self.disc_dp)
        adamw = lambda params: torch.optim.AdamW(params, lr=h.learning_rate,
                                                 betas=(h.adam_b1, h.adam_b2), eps=1e-8,
                                                 weight_decay=0.01)
        self.opt_g = adamw(self.gen.parameters())
        self.opt_d = adamw(list(self.mpd.parameters()) + list(self.msd.parameters()))
        self.mel_fn = pick_mel_fn(h, self.device)
        self.step = 0
        self._set_lr()

    def _set_lr(self) -> None:
        lr = lr_at(self.h, self.step, self.steps_per_epoch)
        for opt in (self.opt_g, self.opt_d):
            for group in opt.param_groups:
                group["lr"] = lr

    def _inputs(self, batch: Batch):
        get = lambda k: None if batch.get(k) is None else batch[k].to(self.device)
        return get("code"), get("f0") if self.h.f0 else None, get("spkr"), get("audio")

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One D step then one G step; returns detached loss tensors named
        as the JAX step's metrics."""
        code, f0, spkr, y = self._inputs(batch)
        for m in (self.gen_dp, self.disc_dp):
            m.train()
        y_g_hat = self.gen_dp(code, f0, spkr)

        # D step on the detached fake
        y_det = y_g_hat.detach()
        (p_rs, p_gs, _, _), (s_rs, s_gs, _, _) = self.disc_dp(y, y_det)
        d_loss = discriminator_loss(p_rs, p_gs)[0] + discriminator_loss(s_rs, s_gs)[0]
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        self.opt_d.step()

        # G step against the updated discriminators, called unwrapped: their
        # parameters take no gradient here, so no DDP reducer waits on them
        with torch.no_grad():
            y_mel = self.mel_fn(y)
        loss_mel = torch.mean(torch.abs(y_mel - self.mel_fn(y_g_hat))) * 45.0
        with _frozen(self.mpd, self.msd):
            _, p_gs, p_fr, p_fg = self.mpd(y, y_g_hat)
            _, s_gs, s_fr, s_fg = self.msd(y, y_g_hat)
            loss_fm = feature_loss(p_fr, p_fg) + feature_loss(s_fr, s_fg)
            loss_adv = generator_loss(p_gs)[0] + generator_loss(s_gs)[0]
            g_loss = loss_adv + loss_fm + loss_mel
            self.opt_g.zero_grad(set_to_none=True)
            g_loss.backward()
        self.opt_g.step()
        self.step += 1
        self._set_lr()
        losses = {"loss_disc": d_loss.detach(), "loss_gen_total": g_loss.detach(),
                  "loss_mel": loss_mel.detach() / 45.0, "loss_fm": loss_fm.detach(),
                  "loss_adv": loss_adv.detach()}
        if self.group is None:
            return losses
        means = pmean_if(torch.stack(list(losses.values())), self.group)
        return dict(zip(losses, means))

    @torch.no_grad()
    def val_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(per-item mean |mel(y) - mel(y_hat)|, y_hat)."""
        code, f0, spkr, y = self._inputs(batch)
        y_g_hat = self.gen(code, f0, spkr)
        err = torch.mean(torch.abs(self.mel_fn(y) - self.mel_fn(y_g_hat)), dim=(1, 2))
        return err, y_g_hat

    # ---- checkpoints: the JAX package's g_/do_ layout -------------------

    def save(self, checkpoint_path: str, epoch: int) -> None:
        """Write ``g_<step>`` and ``do_<step>``."""
        gen_tree = generator_tree(self.gen.state_dict(), self.h)
        save_checkpoint(os.path.join(checkpoint_path, step_checkpoint_name("g_", self.step)),
                        {"generator": gen_tree})
        msd_params, msd_spectral = msd_trees(self.msd.state_dict())
        save_checkpoint(os.path.join(checkpoint_path, step_checkpoint_name("do_", self.step)),
                        {"mpd": mpd_tree(self.mpd.state_dict()), "msd": msd_params,
                         "msd_spectral": msd_spectral,
                         "optim_g": self.opt_g.state_dict(), "optim_d": self.opt_d.state_dict(),
                         "steps": self.step, "epoch": epoch})

    def restore(self, cp_g: str, cp_do: str) -> int:
        """Load a ``g_``/``do_`` pair this package wrote (parameters in
        place, so the optimizers keep them); returns the saved epoch."""
        g_ckpt, do_ckpt = load_checkpoint(cp_g), load_checkpoint(cp_do)
        self.gen.load_state_dict(generator_state_dict(g_ckpt["generator"], self.h))
        self.mpd.load_state_dict(mpd_state_dict(do_ckpt["mpd"]))
        self.msd.load_state_dict(msd_state_dict(do_ckpt["msd"], do_ckpt["msd_spectral"]))
        for opt, key in ((self.opt_g, "optim_g"), (self.opt_d, "optim_d")):
            if not isinstance(do_ckpt[key], dict) or "param_groups" not in do_ckpt[key]:
                raise ValueError(f"{cp_do}: {key} is not a torch optimizer state (a do_ "
                                 "checkpoint of the JAX package cannot be resumed here)")
            opt.load_state_dict(_from_host(do_ckpt[key]))
        self.step = int(do_ckpt["steps"])
        self._set_lr()
        return int(do_ckpt["epoch"])


def _from_host(tree: Any) -> Any:
    """numpy arrays of a saved optimizer ``state_dict`` -> tensors."""
    if isinstance(tree, dict):
        return {k: _from_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_host(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


class Prefetcher:
    """Runs ``batches`` on a host thread, up to ``PREFETCH_DEPTH`` batches ahead of
    the loop (the reference's DataLoader workers, minus the processes).

    An exception in the worker is raised from the iterator, where the loop
    reads its next batch: it never ends an epoch quietly.  ``pin`` turns
    each batch into pinned CPU tensors, so the loop's ``non_blocking``
    copies to the card overlap the host.  ``wait_s`` sums the time the loop
    waited on the queue.  Use it as a context manager: leaving stops the
    worker."""

    _END = object()

    def __init__(self, batches: Iterable[Dict[str, np.ndarray]], pin: bool = False):
        self._queue: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._pin = pin
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._work, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, batches: Iterator[Dict[str, np.ndarray]]) -> None:
        try:
            for batch in batches:
                if self._pin:
                    batch = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
                if not self._put(batch):
                    return
            self._put(self._END)
        except BaseException as err:  # handed to the loop, which raises it
            self._put(err)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            t0 = time.perf_counter()
            item = self._queue.get()
            self.wait_s += time.perf_counter() - t0
            if item is self._END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=60)


def _device_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def train_vocoder(
    h: VocoderConfig,
    checkpoint_path: str,
    training_steps: int = 400000,
    training_epochs: int = 2000,
    stdout_interval: int = 5,
    checkpoint_interval: int = 10000,
    summary_interval: int = 100,
    validation_interval: int = 1000,
    device: DeviceLike = None,
) -> Tuple[GANTrainer, Dict[str, Any]]:
    """Full training loop with resume, checkpoints and validation; returns
    the trainer and the run's stats.  Defaults mirror the reference CLI
    (``sr/train.py:293-308``).  ``device=None`` trains on the CUDA card and
    raises without one.

    The stats record this call's run on the host clock:
    ``start_step``; ``step_s``, each step from the end of the last one's
    checkpoint and validation, the wait for its batch included (a step
    that prints its losses, every ``stdout_interval``, waits for the card
    there, so at 1 these are step times); ``prefetch_wait_s``, the loop's
    wait on the prefetch queue; ``checkpoint_s`` (each ``g_``/``do_``
    write); ``validation_s``; ``wall_s``, the epoch loop.

    Under a process group each of its W ranks trains on ``h.batch_size //
    W`` rows a step (``batch_size`` is the global batch) and rank 0 alone
    writes and validates; each rank returns its own trainer and stats."""
    refuse_f0_vq(h, "train_vocoder")
    dev = resolve_device(device)
    rank, world = distributed.rank(), distributed.world_size()
    rank_batch = local_batch_slice(h.batch_size, world)
    lead = rank == 0
    os.makedirs(checkpoint_path, exist_ok=True)

    train_files, val_files = get_dataset_filelist(h)
    f0_stats = load_f0_stats(h.f0_stats) if (h.f0_normalize and h.f0_stats) else None
    data_kw = dict(multispkr=h.multispkr, f0=h.f0, f0_stats=f0_stats,
                   f0_normalize=h.f0_normalize, f0_median=h.f0_median, seed=h.seed,
                   f0_device=dev)
    ds_train = CodeDataset(train_files, h.segment_size, h.code_hop_size, h.sampling_rate,
                           **data_kw)
    ds_val = CodeDataset(val_files, h.segment_size, h.code_hop_size, h.sampling_rate,
                         id_to_spkr=getattr(ds_train, "id_to_spkr", None), **data_kw)
    if h.multispkr and lead:
        # the reference's plain list (sr/train.py:107-108), which both
        # packages' load_id_to_spkr read
        save_id_to_spkr(os.path.join(checkpoint_path, "id_to_spkr.pkl"), ds_train.id_to_spkr)

    trainer = GANTrainer(h, device=dev, seed=h.seed,
                         steps_per_epoch=max(1, len(ds_train) // h.batch_size))
    # resume (reference sr/train.py:55-70)
    cp_g, cp_do = scan_checkpoint(checkpoint_path, "g_"), scan_checkpoint(checkpoint_path, "do_")
    last_epoch = -1
    if cp_g and cp_do:
        last_epoch = trainer.restore(cp_g, cp_do)
        if lead:
            print(f"Resumed from {cp_g} at step {trainer.step}")
    stats: Dict[str, Any] = dict(start_step=trainer.step, step_s=[], prefetch_wait_s=0.0,
                                 checkpoint_s=[], validation_s=[], wall_s=0.0)
    logger = MetricLogger(os.path.join(checkpoint_path, "logs")) if lead else None

    def save_all(epoch: int) -> None:
        if not lead:
            return
        t0 = time.perf_counter()
        trainer.save(checkpoint_path, epoch)
        stats["checkpoint_s"].append(time.perf_counter() - t0)

    def validate(steps: int) -> None:
        t0 = time.perf_counter()
        # batch sized to the validation split (the reference validates at
        # batch 1, sr/train.py:104-110): a split smaller than the train
        # batch would otherwise yield no batch and skip validation
        val_bs = max(1, min(h.batch_size, len(ds_val)))
        errs = []
        for i, vbatch in enumerate(ds_val.batches(val_bs, shuffle=False, drop_last=False)):
            if i >= MAX_VAL_BATCHES:
                break
            err, y_hat = trainer.val_step(_device_batch(vbatch, dev))
            errs.extend(err.cpu().tolist())
            if i == 0:  # first-batch audio sample (reference sr/train.py:216-273)
                logger.audio("generated/y_hat_0", y_hat[0].cpu().numpy(), steps,
                             sample_rate=h.sampling_rate)
        if errs:
            # drop the wrap-around duplicates of the padded final batch
            logger.scalars({"mel_spec_error": float(np.mean(errs[: len(ds_val)]))}, steps,
                           prefix="validation/")
        stats["validation_s"].append(time.perf_counter() - t0)

    def run_epochs() -> None:
        steps = trainer.step
        if steps >= training_steps:
            # a finished run: write its checkpoint again and return the state
            save_all(max(0, last_epoch))
            return
        # the epoch loop needs a full batch, else it would spin doing nothing
        if len(ds_train) < h.batch_size:
            raise ValueError(
                f"train split has {len(ds_train)} items < batch_size {h.batch_size}: no "
                "full batch to train on; shrink the batch or repeat manifest records "
                "(each draw crops randomly)")
        for epoch in range(max(0, last_epoch), training_epochs):
            start = time.time()
            batches = ds_train.batches(rank_batch, shuffle=True, seed=h.seed + epoch,
                                       process_index=rank, process_count=world)
            with Prefetcher(batches, pin=dev.type == "cuda") as prefetch:
                try:
                    ready = time.perf_counter()
                    for batch in prefetch:
                        if steps >= training_steps:
                            save_all(epoch)
                            return
                        t0 = time.time()
                        metrics = trainer.train_step(_device_batch(batch, dev))
                        steps += 1
                        if lead and steps % stdout_interval == 0:
                            m = {k: float(v) for k, v in metrics.items()}
                            print(f"step {steps}: gen {m['loss_gen_total']:.3f} "
                                  f"mel {m['loss_mel']:.3f} disc {m['loss_disc']:.3f} "
                                  f"({time.time() - t0:.2f}s/b)")
                        stats["step_s"].append(time.perf_counter() - ready)
                        if lead and steps % summary_interval == 0:
                            logger.scalars({k: float(v) for k, v in metrics.items()}, steps,
                                           prefix="training/")
                        if steps % checkpoint_interval == 0:
                            save_all(epoch)
                        if lead and steps % validation_interval == 0:
                            validate(steps)
                        ready = time.perf_counter()
                finally:
                    stats["prefetch_wait_s"] += prefetch.wait_s
            if lead:
                print(f"epoch {epoch} done in {time.time() - start:.1f}s")
        save_all(training_epochs - 1)

    start = time.perf_counter()
    try:
        run_epochs()
    finally:
        stats["wall_s"] = time.perf_counter() - start
        if logger is not None:
            logger.close()
    return trainer, stats
