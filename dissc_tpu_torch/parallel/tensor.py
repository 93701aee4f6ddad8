"""Tensor parallelism over the ``model`` axis (``dissc_tpu.parallel.dryrun --shard tp``).

The JAX dry run shards over ``model`` every generator leaf of rank 2 or
more whose last dimension (flax layout) is at least
``upsample_initial_channel`` and divides by ``n_model`` (``gen_param_spec``,
``dissc_tpu/parallel/dryrun.py:127-157``); the rest stays replicated and
XLA inserts the collectives.  At the dry run's tiny width and at
``VocoderConfig()`` that rule picks ``conv_pre``'s kernel and gain (split by
output channel) and ``ups.0``'s (split by *input* channel: a transposed
conv's flax kernel is ``(k, out, in)``).  That is Megatron's pair around the
generator's first leaky ReLU (``conv_pre``, then ``up(leaky_relu(x))``):

* :class:`ColumnParallelConv1d` holds its rank's output channels of the
  weight-norm ``v`` and ``g`` and the whole bias (replicated, as JAX keeps a
  1-D leaf), of which it adds its slice;
* the leaky ReLU acts on each rank's shard;
* :class:`RowParallelConvTranspose1d` holds its rank's input channels; its
  partial outputs are summed over the model group, then the replicated
  bias is added once.

Each weight-norm gain is taken over the split dimension, so every rank
folds its own shard with no communication.  The two conjugate operators sit
at the pair's edges: :func:`enter_model` (identity forward, all-reduce of
the gradient backward: the whole input gradient, on to the replicated
embeddings, and the whole bias gradient) and :func:`exit_model` (all-reduce
forward, identity backward).

Every rank of a model group holds the same rows, so the replicated
parameters see the same inputs and take the same gradients; a card's
non-deterministic algorithms can still part them by rounding, so the
trainer averages their gradients over the model group
(:func:`average_grads`), which keeps them bit-identical.

A group of ``None`` is a one-rank group: the shards are whole and no
collective runs, so :func:`shard_generator` is exact there.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from dissc_tpu_torch.compat.to_jax import generator_flax_shape
from dissc_tpu_torch.models.layers import Conv1d, ConvTranspose1d, conv_with

Spans = Optional[List[float]]


def sharded_names(named_shapes: Iterable[Tuple[str, Sequence[int]]], width: int,
                  n_model: int) -> List[str]:
    """The JAX ``gen_param_spec`` rule on the port's generator parameters,
    each read in the flax layout ``compat.to_jax`` writes: the names whose
    flax shape has rank 2 or more and a last dimension of at least
    ``width`` (``upsample_initial_channel``) that divides by ``n_model``."""
    out = []
    for name, shape in named_shapes:
        flax = generator_flax_shape(shape)
        if len(flax) >= 2 and flax[-1] >= width and flax[-1] % n_model == 0:
            out.append(name)
    return out


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, spans: Spans) -> None:
    """Sum ``x`` in place over ``group``; with ``spans``, record the call's ms
    with the device synchronised before and after it."""
    if spans is None:
        dist.all_reduce(x, group=group)
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    dist.all_reduce(x, group=group)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    spans.append(1e3 * (time.perf_counter() - t0))


class _Enter(torch.autograd.Function):
    """Identity forward; all-reduce sum of the gradient over the group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, spans: Spans) -> torch.Tensor:
        ctx.group, ctx.spans = group, spans
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        _all_reduce(grad, ctx.group, ctx.spans)
        return grad, None, None


class _Exit(torch.autograd.Function):
    """All-reduce sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, spans: Spans) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(out, group, spans)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None, None


def enter_model(x: torch.Tensor, group, spans: Spans = None) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model ``group``."""
    return x if group is None else _Enter.apply(x, group, spans)


def exit_model(x: torch.Tensor, group, spans: Spans = None) -> torch.Tensor:
    """``x`` summed over the model ``group``; its gradient passed as it is."""
    return x if group is None else _Exit.apply(x, group, spans)


def _shard(t: torch.Tensor, index: int, size: int) -> torch.Tensor:
    if t.shape[0] % size:
        raise ValueError(f"{t.shape[0]} channels do not divide over {size} model ranks")
    return t.detach().chunk(size, 0)[index].clone()


class _ParallelConv:
    """What both sharded layers share: the group, the rank's index in it,
    and which of their tensors are split (dimension 0 of each)."""

    group = None
    index, size = 0, 1
    comm_ms: Spans = None  # each model-group collective's ms, when set

    def _take(self, full: nn.Module, group, index: int, size: int) -> None:
        if full.norm == "spectral":
            raise NotImplementedError("a spectral-norm conv cannot be split by channel")
        self.group, self.index, self.size = group, index, size
        self.norm, self.dtype = full.norm, full.dtype
        for name in self.split_names():
            setattr(self, name, nn.Parameter(_shard(getattr(full, name), index, size)))
        self.bias = (None if full.bias is None
                     else nn.Parameter(full.bias.detach().clone()))

    def split_names(self) -> Tuple[str, ...]:
        return ("weight_v", "weight_g") if self.norm == "weight" else ("weight",)


class ColumnParallelConv1d(_ParallelConv, Conv1d):
    """``full``'s output channels ``index`` of ``size``: its rank's slice of
    the output, from the whole input; the bias stays whole."""

    def __init__(self, full: Conv1d, group, index: int, size: int):
        nn.Module.__init__(self)
        if full.groups != 1:
            raise NotImplementedError("a grouped conv is not split by output channel")
        self.stride, self.dilation, self.groups = full.stride, full.dilation, full.groups
        self.padding = full.padding
        self._take(full, group, index, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = enter_model(x, self.group, self.comm_ms)
        bias = self.bias
        if bias is not None:
            n = bias.shape[0] // self.size
            bias = enter_model(bias, self.group, self.comm_ms)[self.index * n:(self.index + 1) * n]
        return conv_with(F.conv1d, x, self.kernel(), bias, self.dtype, self.stride,
                         self.padding, self.dilation, self.groups)


class RowParallelConvTranspose1d(_ParallelConv, ConvTranspose1d):
    """``full``'s input channels ``index`` of ``size``: from its rank's slice
    of the input, partial outputs summed over the group, then the bias."""

    def __init__(self, full: ConvTranspose1d, group, index: int, size: int):
        nn.Module.__init__(self)
        self.stride, self.padding = full.stride, full.padding
        self._take(full, group, index, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_with(F.conv_transpose1d, x, self.kernel(), None, self.dtype, self.stride,
                      self.padding)
        y = exit_model(y, self.group, self.comm_ms)
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).reshape(-1, 1)


def _parallel_layers(module: nn.Module) -> List[Tuple[str, _ParallelConv]]:
    """``(name, layer)`` of each sharded layer in ``module``."""
    return [(n, m) for n, m in module.named_modules() if isinstance(m, _ParallelConv)]


def _split_keys(module: nn.Module) -> Dict[str, _ParallelConv]:
    return {f"{n}.{t}": m for n, m in _parallel_layers(module) for t in m.split_names()}


def shard_generator(gen: nn.Module, group) -> List[str]:
    """Keep this rank's slices of a full ``CodeGenerator``, in place, as the
    rule (:func:`sharded_names`) picks them over the model ``group``;
    returns the split tensors' names.  The rule must pick the weights of a
    column-parallel ``conv_pre`` and a row-parallel ``ups.0`` (the
    generator's one conv pair around an activation), or nothing."""
    size = _group_size(group)
    index = 0 if group is None else dist.get_rank(group)
    names = sharded_names(((n, p.shape) for n, p in gen.named_parameters()),
                          gen.h.upsample_initial_channel, size)
    if not names:
        return []
    pair = {"conv_pre": gen.conv_pre, "ups.0": gen.ups[0]}
    owners = {n.rsplit(".", 1)[0] for n in names}
    weights = {f"{o}.{t}" for o, m in pair.items()
               for t in ("weight_v", "weight_g", "weight") if hasattr(m, t)}
    if owners != set(pair) or set(names) != weights:
        raise NotImplementedError(f"the model-axis rule picked {names}; the generator splits "
                                  "only conv_pre (by output) and ups.0 (by input) together")
    gen.conv_pre = ColumnParallelConv1d(gen.conv_pre, group, index, size)
    gen.ups[0] = RowParallelConvTranspose1d(gen.ups[0], group, index, size)
    return names


def record_comm(module: nn.Module, spans: Spans) -> None:
    """Have every sharded layer in ``module`` record its collectives' ms
    into ``spans`` (``None``: stop recording)."""
    for _, layer in _parallel_layers(module):
        layer.comm_ms = spans


def replicated_parameters(module: nn.Module) -> List[nn.Parameter]:
    """``module``'s parameters that every rank of a model group holds whole."""
    split = {id(getattr(m, k.rsplit(".", 1)[1])) for k, m in _split_keys(module).items()}
    return [p for p in module.parameters() if id(p) not in split]


@torch.no_grad()
def gather_generator_state(gen: nn.Module) -> Dict[str, torch.Tensor]:
    """The full generator's state dict, each split tensor all-gathered over
    its layer's model group (a collective: every rank of the group calls it);
    the same keys and shapes as an unsharded ``CodeGenerator``'s, so
    ``compat.to_jax`` and the checkpoints see one device's tree."""
    state = gen.state_dict()
    for key, layer in _split_keys(gen).items():
        if layer.group is None:
            continue
        shard = state[key].contiguous()
        parts = [torch.empty_like(shard) for _ in range(layer.size)]
        dist.all_gather(parts, shard, group=layer.group)
        state[key] = torch.cat(parts)
    return state


@torch.no_grad()
def average_grads(params: Sequence[nn.Parameter], group, spans: Spans = None) -> None:
    """Replace each gradient of ``params`` by its mean over ``group``, in one
    all-reduce: every rank then holds the same bits."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    _all_reduce(flat, group, spans)
    flat /= _group_size(group)
    for g, mean in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(mean)
