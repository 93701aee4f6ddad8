"""Conv primitives of the port (``dissc_tpu.models.layers``).

PyTorch modules in NCW / NCHW layout that carry their normalisation
reparameterisations as parameters, named as the reference
``sr/models.py`` state dicts name them:

* **weight norm** ``weight = g * v / sqrt(sum(v^2) + 1e-12)`` (the JAX
  package's eps) with the norm over every dim but 0: per output channel
  for ``Conv1d``/``Conv2d``, per *input* channel for ``ConvTranspose1d``
  (torch ``weight_norm(dim=0)`` on an ``[in, out, k]`` weight).  Params
  ``weight_v``, ``weight_g``; :func:`fold_weight_norm` folds a state dict
  into plain ``weight`` tensors (``remove_weight_norm``).
* **spectral norm** as in ``dissc_tpu`` (not ``torch.nn.utils``): only
  ``u`` is kept (buffer ``weight_u``), ``v`` is recomputed from ``u`` on
  every call, and in train mode ``u`` advances one power-iteration step
  on every call.  Param ``weight_orig``.

Initialisers take an explicit ``torch.Generator``: HiFi-GAN convs are
``normal(0, 0.01)`` (reference ``sr/utils.py:32-35``); other weights and
all biases the torch conv default ``U(+-1/sqrt(fan_in))``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1  # vocoder/discriminator slope (sr/models.py:13)

Init = Callable[[Tuple[int, ...], Optional[torch.Generator]], torch.Tensor]


@functools.lru_cache(maxsize=None)
def rounded_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp`` rounds a Python scalar that
    meets an array of that dtype (torch computes with the float32 value)."""
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    """Leaky ReLU; on a bfloat16 ``x`` the slope is first rounded to
    bfloat16 (:func:`rounded_scalar`), as in the JAX package."""
    return F.leaky_relu(x, rounded_scalar(slope, x.dtype))


def torch_conv_init(fan_in: int) -> Init:
    """torch conv default: kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)

    def init(shape, generator=None):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    return init


def hifigan_init(std: float = 0.01) -> Init:
    """HiFi-GAN conv init: normal(0, 0.01) (reference sr/utils.py:32-35)."""

    def init(shape, generator=None):
        return torch.randn(shape, generator=generator) * std

    return init


def same_padding(kernel_size: int, dilation: int = 1) -> int:
    """'same' padding for odd kernels (reference sr/utils.py:44-45)."""
    return (kernel_size * dilation - dilation) // 2


def conv_in_dtype(fn: Callable[..., torch.Tensor], x: torch.Tensor, weight: torch.Tensor,
                  dtype: torch.dtype, *args) -> torch.Tensor:
    """``fn(x, weight, None, *args)`` with both operands and the result in
    ``dtype``.  On the card the conv runs in ``dtype`` (cuDNN accumulates in
    float32).  On the CPU it is the float32 conv of the ``dtype``-rounded
    operands, rounded once, which is what XLA's CPU backend computes:
    oneDNN's own bfloat16 grouped convs return wrong sums on the CPU for
    some group widths (12 or 4 channels a group at kernels of 8 and more,
    PyTorch 2.13)."""
    x, weight = x.to(dtype), weight.to(dtype)
    if x.device.type == "cpu":
        return fn(x.float(), weight.float(), None, *args).to(dtype)
    return fn(x, weight, None, *args)


def conv_with(fn: Callable[..., torch.Tensor], x: torch.Tensor, kernel: torch.Tensor,
              bias: Optional[torch.Tensor], dtype: Optional[torch.dtype], *args) -> torch.Tensor:
    """``fn(x, kernel, bias, *args)``; with a compute ``dtype``, the conv in
    that dtype (:func:`conv_in_dtype`) and then the bias in it."""
    if dtype is None:
        return fn(x, kernel, bias, *args)
    y = conv_in_dtype(fn, x, kernel, dtype, *args)
    if bias is None:
        return y
    return y + bias.to(dtype).reshape(-1, *([1] * (y.dim() - 2)))


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||`` with the norm over every dim but 0."""
    dims = tuple(range(1, v.dim()))
    return g * (v / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12))


class _NormedWeight(nn.Module):
    """Holds a conv weight as plain, weight-normed or spectral-normed params."""

    def __init__(self, shape: Sequence[int], fan_in: int, norm: Optional[str],
                 kernel_init: Optional[Init], bias: bool, bias_size: int,
                 generator: Optional[torch.Generator], dtype: Optional[torch.dtype] = None):
        super().__init__()
        if norm not in (None, "weight", "spectral"):
            raise ValueError(f"norm must be None, 'weight' or 'spectral', got {norm!r}")
        self.norm = norm
        self.dtype = dtype
        w = (kernel_init or torch_conv_init(fan_in))(tuple(shape), generator)
        if norm == "weight":
            self.weight_v = nn.Parameter(w)
            dims = tuple(range(1, w.dim()))
            self.weight_g = nn.Parameter(torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True)))
        elif norm == "spectral":
            self.weight_orig = nn.Parameter(w)
            self.register_buffer("weight_u", torch.randn(shape[0], generator=generator))
        else:
            self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch_conv_init(fan_in)((bias_size,), generator))
                     if bias else None)

    def _conv(self, fn: Callable[..., torch.Tensor], x: torch.Tensor, *args) -> torch.Tensor:
        """``fn(x, kernel, bias, *args)``, in the compute dtype when there is one."""
        return conv_with(fn, x, self.kernel(), self.bias, self.dtype, *args)

    def kernel(self) -> torch.Tensor:
        if self.norm == "weight":
            return weight_norm(self.weight_v, self.weight_g)
        if self.norm == "spectral":
            return self._spectral_normalize()
        return self.weight

    def _spectral_normalize(self, train: Optional[bool] = None) -> torch.Tensor:
        """One power-iteration step on W reshaped to [out, in*k] (train mode,
        or ``train=True``, only); always divides by the current sigma
        estimate."""
        w_orig = self.weight_orig
        w = w_orig.reshape(w_orig.shape[0], -1)
        if self.training if train is None else train:
            with torch.no_grad():
                v = w.t() @ self.weight_u
                v = v / (torch.linalg.vector_norm(v) + 1e-12)
                u = w @ v
                u = u / (torch.linalg.vector_norm(u) + 1e-12)
                self.weight_u.copy_(u)
        else:
            u = self.weight_u
            v = w.t() @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
        sigma = u @ (w @ v)
        return w_orig / sigma


class Conv1d(_NormedWeight):
    """1D convolution, NCW, optional weight or spectral norm.

    ``padding=None`` is 'same' for the (kernel, dilation); ``dtype`` is
    the compute dtype (``None``: float32).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 padding: Optional[int] = None, bias: bool = True,
                 norm: Optional[str] = None, kernel_init: Optional[Init] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        fan_in = (in_channels // groups) * kernel_size
        super().__init__((out_channels, in_channels // groups, kernel_size), fan_in,
                         norm, kernel_init, bias, out_channels, generator, dtype)
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = same_padding(kernel_size, dilation) if padding is None else padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(F.conv1d, x, self.stride, self.padding, self.dilation, self.groups)


class ConvTranspose1d(_NormedWeight):
    """1D transposed convolution with torch semantics, NCW.

    Output length ``(T-1)*stride - 2*padding + kernel_size``.  The weight
    is ``[in, out, k]``, so weight norm is per input channel.  The JAX
    package's polyphase lowering gives the same numbers and is not ported.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True,
                 norm: Optional[str] = None, kernel_init: Optional[Init] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        fan_in = in_channels * kernel_size
        super().__init__((in_channels, out_channels, kernel_size), fan_in, norm,
                         kernel_init, bias, out_channels, generator, dtype)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(F.conv_transpose1d, x, self.stride, self.padding)


class Conv2d(_NormedWeight):
    """2D convolution, NCHW, optional weight or spectral norm (the MPD's
    ``(k, 1)`` convs)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0), bias: bool = True,
                 norm: Optional[str] = None, kernel_init: Optional[Init] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        kh, kw = kernel_size
        fan_in = in_channels * kh * kw
        super().__init__((out_channels, in_channels, kh, kw), fan_in, norm,
                         kernel_init, bias, out_channels, generator, dtype)
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(F.conv2d, x, self.stride, self.padding)


def fold_weight_norm(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every ``X.weight_v``/``X.weight_g`` pair into ``X.weight``.

    The reference's inference-time ``remove_weight_norm``
    (``sr/models.py:116-122``) as a function over a state dict: the result
    loads into modules built with ``norm=None`` (``VocoderConfig.folded_weights``).
    """
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            prefix = key[: -len(".weight_v")]
            out[prefix + ".weight"] = weight_norm(value, state[prefix + ".weight_g"]).detach()
            continue
        out[key] = value
    return out


class Embed(nn.Module):
    """Embedding table, torch default init N(0, 1) (param ``weight``).

    ``padding_idx`` zeroes the *output* for that id, as the JAX ``Embed``
    does (``dissc_tpu/models/layers.py:540-542``): a table carried from JAX
    may hold a non-zero pad row, which ``nn.Embedding(padding_idx=...)``
    would return as it is.
    """

    def __init__(self, num_embeddings: int, features: int,
                 padding_idx: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.randn((num_embeddings, features), generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.weight)
        if self.padding_idx is not None:
            out = out.masked_fill((ids == self.padding_idx)[..., None], 0.0)
        return out
