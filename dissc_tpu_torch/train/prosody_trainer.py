"""Rhythm and pitch predictor trainers (``dissc_tpu.train.prosody_trainer``;
reference ``train_len_predictor.py`` / ``train_f0_predictor.py``).

One train step (forward, loss, metrics, Adam update) and one eval step per
model, on the entry point's device.  ``torch.optim.Adam(lr)`` is
``optax.adam(lr)``.  Metric accounting matches the reference: masked
*sums* accumulated over the epoch, normalised by the total non-pad count
only at logging time.  The trainers pass no length mask, so BatchNorm's
batch statistics include the pad rows and slots, as in the JAX package.

Model selection: best summed val MSE for rhythm
(``train_len_predictor.py:100-103``), best summed val MAE for pitch
(``train_f0_predictor.py:97-100``) -> ``best_model.pth``, written in the
JAX package's layout through :mod:`~dissc_tpu_torch.compat.to_jax`, so
both packages' ``ProsodyConverter.load`` read it; the rhythm trainer also
writes ``len_norm_stats.pth``.

Randomness: weights from ``torch.Generator`` seeded with ``cfg.seed`` (on
the CPU, so a seed gives the same weights on any device), the token masks
and PE dropout from a generator on the device seeded with ``cfg.seed``,
and the batch order from ``np.random.default_rng(cfg.seed)``, the JAX
trainer's order.

Data parallelism: under a process group (torchrun, or the CLIs' own
launcher) the trainers run DDP over its W ranks, as the JAX trainers shard
each batch over the mesh's ``data`` axis.  ``cfg.batch_size`` stays the
global batch: every rank draws the same global batches and keeps its
contiguous block of rows.  The losses are masked *sums*, and DDP averages
gradients, so each rank's loss is scaled by W: the update is the global
batch's.  BatchNorm statistics and the masks are the global batch's
(:func:`~dissc_tpu_torch.models.prosody.data_parallel`).  Epoch metrics are
summed over the ranks; rank 0 alone writes logs and checkpoints.  Without
a group the trainers run as on one device, with no wrapper and no
collective.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from dissc_tpu_torch.compat.to_jax import len_predictor_variables, pitch_predictor_variables
from dissc_tpu_torch.core.config import ProsodyConfig
from dissc_tpu_torch.data.datasets import LenDataset, PitchDataset, batch_iterator
from dissc_tpu_torch.data.stats import load_f0_stats, load_id_to_spkr, prep_stats_arrays
from dissc_tpu_torch.device import DeviceLike, generator_for, resolve_device
from dissc_tpu_torch.losses.len_loss import (
    len_exact_accuracy,
    len_mae_loss,
    len_mse_loss,
    len_one_off_accuracy,
    len_sum_loss,
)
from dissc_tpu_torch.losses.pitch_loss import pitch_loss, pitch_mae, pitch_mse
from dissc_tpu_torch.models.prosody import (LenPredictor, PitchPredictor, PitchPredictorBase,
                                            calc_freq, data_parallel)
from dissc_tpu_torch.parallel import distributed
from dissc_tpu_torch.parallel.collectives import psum_if
from dissc_tpu_torch.parallel.mesh import local_batch_slice, shard_rows
from dissc_tpu_torch.train.checkpoints import save_checkpoint
from dissc_tpu_torch.train.logging import init_loggers, log_metrics

Metrics = Dict[str, torch.Tensor]
Step = Callable[..., Metrics]


def build_pitch_model(model_type: str, n_tokens: int, n_speakers: int,
                      cfg: Optional[ProsodyConfig] = None,
                      generator: Optional[torch.Generator] = None):
    """``"base"`` -> :class:`PitchPredictorBase`, anything else ->
    :class:`PitchPredictor` (the JAX package's rule)."""
    cfg = cfg or ProsodyConfig()
    cls = PitchPredictorBase if model_type == "base" else PitchPredictor
    return cls(n_tokens=n_tokens, n_speakers=n_speakers, emb_size=cfg.emb_size,
               hidden=cfg.hidden, masking_rate=cfg.pitch_masking_rate, generator=generator)


def _device_batch(arrays, device: torch.device):
    """Host ``(units, targets, speakers)`` -> tensors on ``device``."""
    vals, target, spk = arrays
    return (torch.as_tensor(vals, dtype=torch.long, device=device),
            torch.as_tensor(target, device=device),
            torch.as_tensor(spk, dtype=torch.long, device=device))


def _group():
    """The default process group when one is initialised, else ``None``."""
    return dist.group.WORLD if distributed.is_initialized() else None


def _data_parallel(model: torch.nn.Module, group) -> Tuple[torch.nn.Module, int]:
    """(the module a train step calls, the loss scale): ``model`` itself and
    1 without a group; under one, ``model`` set for a data-parallel step
    and wrapped in DDP, and the world size (DDP averages the gradients of
    losses that are sums)."""
    if group is None:
        return model, 1
    world = dist.get_world_size(group)
    data_parallel(model, group, dist.get_rank(group), world)
    # the BatchNorm running statistics are the global batch's on every rank
    return DistributedDataParallel(model, process_group=group, broadcast_buffers=False), world


def _run_epoch(step: Step, batches, device: torch.device, group=None) -> Dict[str, float]:
    """Sums of ``step``'s metrics over ``batches`` (each read back to the
    host, as the JAX trainer reads them); under a process group each rank
    steps on its rows of every global batch and the sums are over all
    ranks."""
    totals: Dict[str, float] = {}
    for arrays in batches:
        if group is not None:
            arrays = shard_rows(arrays, dist.get_rank(group), dist.get_world_size(group))
        for k, v in step(*_device_batch(arrays, device)).items():
            totals[k] = totals.get(k, 0.0) + float(v)
    if group is not None and totals:
        keys = sorted(totals)
        summed = psum_if(torch.tensor([totals[k] for k in keys], dtype=torch.float64,
                                      device=device), group)
        totals = dict(zip(keys, summed.tolist()))
    return totals


def _log(logger, totals: Dict[str, float], epoch: int, name: str) -> None:
    n = max(totals.pop("n"), 1.0)
    if logger is not None:
        log_metrics(logger, {k: v / n for k, v in totals.items()}, epoch, name)


# ---------------------------------------------------------------------------
# Rhythm (LenPredictor)
# ---------------------------------------------------------------------------


def _len_metrics(preds, lens, pad) -> Metrics:
    return {"MSE": len_mse_loss(preds, lens, pad), "MAE": len_mae_loss(preds, lens, pad),
            "Accuracy": len_exact_accuracy(preds, lens, pad),
            "Accuracy_1": len_one_off_accuracy(preds, lens, pad)}


def make_len_steps(model: LenPredictor, norm_stats: Tuple[float, float],
                   optimizer: torch.optim.Optimizer, pad: float = -1.0,
                   generator: Optional[torch.Generator] = None,
                   group=None) -> Tuple[Step, Step]:
    """(train_step, eval_step) of the rhythm model, each
    ``(vals [B, L], lens [B, L], spk [B, 1]) -> metrics`` (detached sums).
    With a process ``group`` the train step is DDP's over its ranks (each
    passes its rows; the metrics are the rank's sums)."""
    net, scale = _data_parallel(model, group)

    def train_step(vals, lens, spk) -> Metrics:
        net.train()
        preds = net(vals, spk, norm_stats, generator=generator)
        loss = len_sum_loss(preds, lens, pad)
        optimizer.zero_grad(set_to_none=True)
        (loss * scale if scale != 1 else loss).backward()
        optimizer.step()
        preds = preds.detach()
        return {"Loss": loss.detach(), **_len_metrics(preds, lens, pad),
                "n": (vals != model.n_tokens).sum()}

    @torch.no_grad()
    def eval_step(vals, lens, spk) -> Metrics:
        model.eval()
        preds = model(vals, spk, norm_stats)
        return {"Loss": len_sum_loss(preds, lens, pad), **_len_metrics(preds, lens, pad),
                "n": (vals != model.n_tokens).sum()}

    return train_step, eval_step


def train_len_predictor(data_path: str, out_path: str, cfg: Optional[ProsodyConfig] = None,
                        device: DeviceLike = None) -> str:
    """Full rhythm-trainer loop; returns the checkpoint directory.
    ``device=None`` trains on the CUDA card and raises without one; under
    a process group, data-parallel over its ranks."""
    dev = resolve_device(device)
    cfg = cfg or ProsodyConfig()
    group = _group()
    if group is not None:
        local_batch_slice(cfg.batch_size, dist.get_world_size(group))  # refuse an odd split
    lead = distributed.is_coordinator()
    pad = -1.0
    ckpt_dir = os.path.join(out_path, "len")
    os.makedirs(ckpt_dir, exist_ok=True)
    train_logger, val_logger = init_loggers(ckpt_dir) if lead else (None, None)

    spk_id_dict = load_id_to_spkr(os.path.join(data_path, "id_to_spkr.pkl"))
    ds_train = LenDataset.from_file(os.path.join(data_path, "train.txt"), spk_id_dict,
                                    cfg.n_tokens, pad)
    ds_val = LenDataset.from_file(os.path.join(data_path, "val.txt"), spk_id_dict,
                                  cfg.n_tokens, pad)
    norm_stats = ds_train.train_norm_stats()
    if lead:
        save_checkpoint(os.path.join(ckpt_dir, "len_norm_stats.pth"),
                        tuple(np.asarray(v) for v in norm_stats))

    model = LenPredictor(n_tokens=cfg.n_tokens, n_speakers=len(spk_id_dict),
                         emb_size=cfg.emb_size, hidden=cfg.hidden,
                         masking_rate=cfg.len_masking_rate,
                         generator=generator_for(cfg.seed)).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    mask_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    train_step, eval_step = make_len_steps(model, norm_stats, optimizer, pad, mask_gen, group)

    np_rng = np.random.default_rng(cfg.seed)
    best_mse = np.inf
    pad_rows = (cfg.n_tokens, pad, 0)
    for epoch in range(cfg.n_epochs):
        start = time.perf_counter()
        totals = _run_epoch(train_step, batch_iterator(
            (ds_train.vals, ds_train.lens, ds_train.spk_ids), cfg.batch_size,
            shuffle=True, rng=np_rng, pad_row_values=pad_rows), dev, group)
        _log(train_logger, totals, epoch, "train")
        totals = _run_epoch(eval_step, batch_iterator(
            (ds_val.vals, ds_val.lens, ds_val.spk_ids), cfg.batch_size,
            shuffle=False, pad_row_values=pad_rows), dev, group)
        if totals["MSE"] < best_mse:
            best_mse = totals["MSE"]
            if lead:
                save_checkpoint(os.path.join(ckpt_dir, "best_model.pth"),
                                len_predictor_variables(model.state_dict()))
        _log(val_logger, totals, epoch, "val")
        if lead:
            print(f"epoch {epoch} done in {time.perf_counter() - start:.2f}s")
    return ckpt_dir


# ---------------------------------------------------------------------------
# Pitch (PitchPredictor / PitchPredictorBase)
# ---------------------------------------------------------------------------


def make_pitch_steps(model, id2mean: torch.Tensor, id2std: torch.Tensor,
                     optimizer: torch.optim.Optimizer, pad: float = -100.0,
                     generator: Optional[torch.Generator] = None,
                     group=None) -> Tuple[Step, Step]:
    """(train_step, eval_step) of a pitch model, each
    ``(vals [B, T], gts [B, T], spk [B, 1]) -> metrics`` (detached sums).
    With a process ``group`` the train step is DDP's, as in
    :func:`make_len_steps`."""
    net, scale = _data_parallel(model, group)

    def _metrics(cls_p, reg_p, gts, spk) -> Metrics:
        freqs = calc_freq(cls_p, reg_p, spk, id2mean, id2std)
        return {"MAE": pitch_mae(freqs, gts, spk, id2mean, id2std, pad),
                "MSE": pitch_mse(freqs, gts, spk, id2mean, id2std, pad)}

    def train_step(vals, gts, spk) -> Metrics:
        net.train()
        cls_p, reg_p = net(vals, spk, generator=generator)
        loss = pitch_loss(cls_p, reg_p, gts, spk, id2mean, id2std, pad)
        optimizer.zero_grad(set_to_none=True)
        (loss * scale if scale != 1 else loss).backward()
        optimizer.step()
        return {"loss": loss.detach(), **_metrics(cls_p.detach(), reg_p.detach(), gts, spk),
                "n": (gts != pad).sum()}

    @torch.no_grad()
    def eval_step(vals, gts, spk) -> Metrics:
        model.eval()
        cls_p, reg_p = model(vals, spk)
        return {"loss": pitch_loss(cls_p, reg_p, gts, spk, id2mean, id2std, pad),
                **_metrics(cls_p, reg_p, gts, spk), "n": (gts != pad).sum()}

    return train_step, eval_step


def train_f0_predictor(data_path: str, f0_path: str, out_path: str,
                       cfg: Optional[ProsodyConfig] = None, device: DeviceLike = None) -> str:
    """Full pitch-trainer loop; returns the checkpoint directory.
    ``device=None`` trains on the CUDA card and raises without one; under
    a process group, data-parallel over its ranks."""
    dev = resolve_device(device)
    cfg = cfg or ProsodyConfig()
    group = _group()
    if group is not None:
        local_batch_slice(cfg.batch_size, dist.get_world_size(group))  # refuse an odd split
    lead = distributed.is_coordinator()
    pad = -100.0
    ckpt_dir = os.path.join(out_path, "pitch")
    os.makedirs(ckpt_dir, exist_ok=True)
    train_logger, val_logger = init_loggers(ckpt_dir) if lead else (None, None)

    f0_param_dict = load_f0_stats(f0_path)
    spk_id_dict = load_id_to_spkr(os.path.join(data_path, "id_to_spkr.pkl"))
    id2mean, id2std = (torch.from_numpy(a).to(dev)
                       for a in prep_stats_arrays(spk_id_dict, f0_param_dict))
    ds_train = PitchDataset.from_file(os.path.join(data_path, "train.txt"), spk_id_dict,
                                      f0_param_dict, cfg.n_tokens, pad)
    ds_val = PitchDataset.from_file(os.path.join(data_path, "val.txt"), spk_id_dict,
                                    f0_param_dict, cfg.n_tokens, pad)

    model = build_pitch_model(cfg.model_type, cfg.n_tokens, len(spk_id_dict), cfg,
                              generator=generator_for(cfg.seed)).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    mask_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    train_step, eval_step = make_pitch_steps(model, id2mean, id2std, optimizer, pad, mask_gen,
                                             group)

    np_rng = np.random.default_rng(cfg.seed)
    best_mae = np.inf
    pad_rows = (cfg.n_tokens, pad, 0)
    for epoch in range(cfg.n_epochs):
        start = time.perf_counter()
        totals = _run_epoch(train_step, batch_iterator(
            (ds_train.vals, ds_train.fs, ds_train.spk_ids), cfg.batch_size,
            shuffle=True, rng=np_rng, pad_row_values=pad_rows), dev, group)
        _log(train_logger, totals, epoch, "train")
        totals = _run_epoch(eval_step, batch_iterator(
            (ds_val.vals, ds_val.fs, ds_val.spk_ids), cfg.batch_size,
            shuffle=False, pad_row_values=pad_rows), dev, group)
        if totals["MAE"] < best_mae:
            best_mae = totals["MAE"]
            if lead:
                save_checkpoint(os.path.join(ckpt_dir, "best_model.pth"),
                                pitch_predictor_variables(model.state_dict()))
        _log(val_logger, totals, epoch, "val")
        if lead:
            print(f"epoch {epoch} done in {time.perf_counter() - start:.2f}s")
    return ckpt_dir
