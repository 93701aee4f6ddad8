"""F0-VQVAE quantizer trainer (``dissc_tpu.train.quantizer_trainer``).

Trains the jukebox Encoder -> EMA-VQ -> Decoder stack
(:class:`~dissc_tpu_torch.models.vq.Quantizer`, reference
``sr/models.py:336-349``) on the F0 contours of an ``F0Dataset``: L2
reconstruction plus ``lambda_commit`` times the commit losses, AdamW as
``optax.adamw(lr, b1=0.8, b2=0.99)`` builds it (eps 1e-8, weight decay
1e-4).  The ``g_`` checkpoints hold ``{"generator", "vq_state"}`` in the
JAX package's layout, so either package loads the other's.

Under a process group the trainer is data-parallel: each global batch of
the epoch's order is divided into contiguous row blocks, one a rank, the
model runs under DDP (its losses are means, so DDP's averaged gradient is
the global batch's), the codebook statistics reduce over the ranks
(:class:`~dissc_tpu_torch.models.vq.BottleneckBlock`) and rank 0 alone
writes logs and ``g_`` files.  Each rank loads only its rows, so their
crops are drawn per rank.
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from dissc_tpu_torch.compat.to_jax import quantizer_trees
from dissc_tpu_torch.device import DeviceLike, generator_for, resolve_device
from dissc_tpu_torch.models.vq import Quantizer
from dissc_tpu_torch.parallel import distributed
from dissc_tpu_torch.parallel.collectives import pmean_if, pmin_if
from dissc_tpu_torch.parallel.mesh import local_batch_slice
from dissc_tpu_torch.train.checkpoints import save_checkpoint, step_checkpoint_name
from dissc_tpu_torch.train.logging import MetricLogger


class QuantizerState(NamedTuple):
    model: Quantizer  # parameters and the codebook buffers (the JAX vq_state)
    optimizer: torch.optim.Optimizer
    step: int
    net: Optional[torch.nn.Module] = None  # the model's DDP wrapper, data-parallel


DEFAULT_F0_PARAMS = dict(
    f0_encoder_params=dict(input_emb_width=1, output_emb_width=128, levels=1,
                           downs_t=[4], strides_t=[2], width=128, depth=4,
                           m_conv=1.0, dilation_growth_rate=3),
    f0_vq_params=dict(l_bins=20, emb_width=128, mu=0.99, levels=1),
    f0_decoder_params=dict(input_emb_width=1, output_emb_width=128, levels=1,
                           downs_t=[4], strides_t=[2], width=128, depth=4,
                           m_conv=1.0, dilation_growth_rate=3),
)


def make_optimizer(model: Quantizer, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate, b1=0.8, b2=0.99)`` (its eps and weight
    decay are 1e-8 and 1e-4; ``torch.optim.AdamW`` defaults to 1e-2)."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.8, 0.99), eps=1e-8,
                             weight_decay=1e-4)


def make_quantizer_steps(lambda_commit: float = 0.02):
    """``train_step(state, f0, generator) -> (state, metrics)`` and
    ``eval_step(state, f0) -> mse``; ``f0`` is ``[B, 1, T]``."""

    def train_step(state: QuantizerState, f0: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        net = state.model if state.net is None else state.net
        net.train()
        f0_rec, commit_losses, metrics = net(f0, update_k=True, generator=generator)
        rec = torch.mean((f0_rec - f0) ** 2)
        commit = sum(commit_losses)
        loss = rec + lambda_commit * commit
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        out = {"loss": loss.detach(), "recon": rec.detach(), "commit": commit.detach()}
        out.update({k: metrics[0][k] for k in ("entropy", "usage", "used_curr")
                    if k in metrics[0]})
        return state._replace(step=state.step + 1), out

    def eval_step(state: QuantizerState, f0: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        with torch.no_grad():
            f0_rec, _, _ = state.model(f0, update_k=False)
            return torch.mean((f0_rec - f0) ** 2)

    return train_step, eval_step


def train_f0_quantizer(dataset, checkpoint_path: str, batch_size: int = 16,
                       learning_rate: float = 2e-4, training_steps: int = 10000,
                       lambda_commit: float = 0.02, checkpoint_interval: int = 2500,
                       seed: int = 1234, quantizer_params: Optional[Dict] = None,
                       device: DeviceLike = None) -> QuantizerState:
    """Train on an ``F0Dataset``-like sequence of items with ``f0`` arrays
    ``[T, 1]`` on ``device`` (``None``: the CUDA card, raising without one).
    Each epoch's batches follow ``np.random.default_rng(seed + epoch)``, every
    f0 cut to the batch's shortest; metrics go to ``<checkpoint_path>/logs``
    every 100 steps.  ``batch_size`` is the global batch; under a process
    group, data-parallel over its ranks."""
    dev = resolve_device(device)
    group = dist.group.WORLD if distributed.is_initialized() else None
    rank, world = distributed.rank(), distributed.world_size()
    local = local_batch_slice(batch_size, world)
    lead = distributed.is_coordinator()
    os.makedirs(checkpoint_path, exist_ok=True)
    logger = MetricLogger(os.path.join(checkpoint_path, "logs")) if lead else None
    qp = quantizer_params or DEFAULT_F0_PARAMS

    def batches(epoch):
        order = np.random.default_rng(seed + epoch).permutation(len(dataset))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            rows = order[s + rank * local:s + (rank + 1) * local]
            f0s = [dataset[i]["f0"] for i in rows]
            n = min(f.shape[0] for f in f0s)
            if group is not None:  # the global batch's shortest
                n = int(pmin_if(torch.tensor([n], device=dev), group).item())
            yield np.stack([f[:n] for f in f0s])

    # the JAX trainer draws one batch to shape its init; drawing it here too
    # keeps the dataset's crop stream the same
    next(batches(0))
    model = Quantizer(**qp, generator=generator_for(seed), group=group).to(dev)
    # the codebook buffers agree on every rank by construction: no broadcast
    net = None if group is None else DistributedDataParallel(model, process_group=group,
                                                             broadcast_buffers=False)
    state = QuantizerState(model, make_optimizer(model, learning_rate), 0, net)
    train_step, _ = make_quantizer_steps(lambda_commit)
    vq_rng = torch.Generator(device=dev).manual_seed(seed)

    def save(step: int) -> None:  # a g_ in the JAX layout
        if not lead:
            return
        params, vq_state = quantizer_trees(state.model.state_dict(), qp)
        save_checkpoint(os.path.join(checkpoint_path, step_checkpoint_name("g_", step)),
                        {"generator": params, "vq_state": vq_state})

    epoch = 0
    while state.step < training_steps:
        for f0 in batches(epoch):
            if state.step >= training_steps:
                break
            f0 = torch.as_tensor(f0, device=dev).transpose(1, 2)
            state, metrics = train_step(state, f0, vq_rng)
            if state.step % 100 == 0:
                # the losses are this rank's means: average them over the ranks
                values = {k: float(pmean_if(v.float(), group)) for k, v in metrics.items()}
                if logger is not None:
                    logger.scalars(values, state.step, prefix="f0_vq/")
            if state.step % checkpoint_interval == 0:
                save(state.step)
        epoch += 1
    save(state.step)
    if logger is not None:
        logger.close()
    return state
