"""Fused MSD G step (``dissc_tpu.models.msd_fused``): one autograd function
around the whole multi-scale stack, for the G step only.

The G step differentiates the MSD with respect to the generated waveform
alone.  :func:`msd_g_apply` runs the stack's forward from weights folded
outside it (:func:`fold_msd_weights`: weight norm, and spectral norm with
the train-mode power-iteration step on scale 0, advancing ``weight_u`` as
the plain forward does) and a hand-written backward that

* gives the gradient for ``y_hat`` alone (no weight, bias or ``y``
  gradient);
* saves nothing beyond the folded weights and the generated side's
  post-activation feature maps, which the feature-match loss needs anyway:
  each leaky ReLU's mask is the sign of its output, where autograd would
  keep every pre-activation map as well;
* takes each conv's input gradient with ``torch.nn.grad.conv1d_input`` at
  the conv's stride and groups (cuDNN's data gradient on the card: no
  polyphase split, which the JAX package needs to avoid XLA's dilated
  form, and no dilation zeros) and the average pool's through its own
  backward.

Its forward is the plain ``MultiScaleDiscriminator``'s op for op, in the
config's ``disc_compute_dtype`` (the folded weights carry it), and its
backward is autograd's: on the CPU a bfloat16 conv's data gradient is the
float32 one of the rounded operands, rounded once, as
``layers.conv_in_dtype`` computes the forward.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dissc_tpu_torch.models.discriminators import (MSD_POST, MSD_SPECS,
                                                   MultiScaleDiscriminator)
from dissc_tpu_torch.models.layers import LRELU_SLOPE, conv_with, leaky_relu, rounded_scalar

# (real-side kernel, generated-side kernel, bias) of one conv
Folded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Weights = Tuple[Tuple[Folded, ...], ...]
_SPECS = tuple(MSD_SPECS) + (MSD_POST,)


@torch.no_grad()
def fold_msd_weights(msd: MultiScaleDiscriminator, train: bool = True,
                     dtype: Optional[torch.dtype] = None) -> Weights:
    """Per scale, per conv, ``(W_r, W_g, b)``: the kernels the real-side and
    the generated-side passes of ``msd(y, y_hat)`` use, and the bias, cast
    to ``dtype`` when given.

    A spectral-norm conv (scale 0) takes one power-iteration step for each
    side with ``train``, as the module's two calls do, so ``W_g`` sees the
    second step's sigma and ``weight_u`` ends advanced twice; a weight-norm
    conv uses one kernel for both sides."""
    weights = []
    for d in msd.discriminators:
        scale = []
        for conv in (*d.convs, d.conv_post):
            if conv.norm == "spectral":
                w_r = conv._spectral_normalize(train)
                w_g = conv._spectral_normalize(train)
            else:
                w_r = w_g = conv.kernel()
            b = conv.bias
            if dtype is not None:
                w_r, w_g, b = w_r.to(dtype), w_g.to(dtype), b.to(dtype)
            scale.append((w_r, w_g, b))
        weights.append(tuple(scale))
    return tuple(weights)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool1d(x[:, None], 4, 2, padding=2)[:, 0]


def _pool_grad(d: torch.Tensor, in_len: int) -> torch.Tensor:
    """The gradient of :func:`_pool` at an input of ``in_len`` samples."""
    with torch.enable_grad():
        x = torch.zeros(d.shape[0], in_len, dtype=d.dtype, device=d.device,
                        requires_grad=True)
        return torch.autograd.grad(_pool(x), x, d)[0]


def _compute_dtype(w: torch.Tensor) -> Optional[torch.dtype]:
    return None if w.dtype == torch.float32 else w.dtype


def _scale_forward(scale: Sequence[Folded], x: torch.Tensor, side: int) -> List[torch.Tensor]:
    """One ``DiscriminatorS`` forward on ``x [B, T]`` from folded weights
    (``side`` 0: the real-side kernels, 1: the generated side's): its
    feature maps, the last of which is the score map."""
    dtype = _compute_dtype(scale[0][side])
    h = x[:, None]
    fmap = []
    for i, ((*kernels, b), (_, _, _, stride, groups, pad)) in enumerate(zip(scale, _SPECS)):
        h = conv_with(F.conv1d, h, kernels[side], b, dtype, stride, pad, 1, groups)
        if i < len(MSD_SPECS):  # every conv but conv_post
            h = leaky_relu(h)
        fmap.append(h)
    return fmap


def _input_grad(d: torch.Tensor, w: torch.Tensor, x_shape: torch.Size, stride: int,
                pad: int, groups: int) -> torch.Tensor:
    """The gradient for a conv's input (autograd's, in the compute dtype)."""
    grad = torch.nn.grad.conv1d_input
    if _compute_dtype(w) is not None and d.device.type == "cpu":
        return grad(x_shape, w.float(), d.float(), stride, pad, 1, groups).to(w.dtype)
    return grad(x_shape, w, d, stride, pad, 1, groups)


def _scale_backward(kernels: Sequence[torch.Tensor], fmap: Sequence[torch.Tensor],
                    d_fmap: Sequence[Optional[torch.Tensor]], in_len: int) -> torch.Tensor:
    """The gradient for one scale's input ``[B, in_len]`` from its feature
    maps' gradients (``None``: zero)."""
    d = None
    for i in range(len(_SPECS) - 1, -1, -1):
        if d_fmap[i] is not None:
            d = d_fmap[i] if d is None else d + d_fmap[i]
        if d is None:
            continue
        if i < len(MSD_SPECS):  # the leaky ReLU's mask, from its output's sign
            d = torch.where(fmap[i] > 0, d, d * rounded_scalar(LRELU_SLOPE, d.dtype))
        _, _, _, stride, groups, pad = _SPECS[i]
        x_shape = fmap[i - 1].shape if i else torch.Size((fmap[0].shape[0], 1, in_len))
        d = _input_grad(d, kernels[i], x_shape, stride, pad, groups)
    if d is None:
        return torch.zeros(fmap[0].shape[0], in_len, device=fmap[0].device)
    return d[:, 0].float()


class _MSDGStep(torch.autograd.Function):
    """Forward: the folded stack on ``y`` and ``y_hat``; its outputs are
    every scale's real-side then generated-side feature maps.  Backward:
    the gradient for ``y_hat`` only."""

    @staticmethod
    def forward(ctx, n_scales: int, y: torch.Tensor, y_hat: torch.Tensor, *flat: torch.Tensor):
        per = len(_SPECS)
        scales = [[tuple(flat[3 * (s * per + c):3 * (s * per + c) + 3]) for c in range(per)]
                  for s in range(n_scales)]
        real, fake, lens = [], [], []
        for i, scale in enumerate(scales):
            if i:
                y, y_hat = _pool(y), _pool(y_hat)
            lens.append(y_hat.shape[1])
            real.extend(_scale_forward(scale, y, 0))
            fake.extend(_scale_forward(scale, y_hat, 1))
        ctx.mark_non_differentiable(*real)
        ctx.set_materialize_grads(False)
        ctx.lens, ctx.n_scales = lens, n_scales
        ctx.save_for_backward(*(w_g for scale in scales for _, w_g, _ in scale), *fake)
        return (*real, *fake)

    @staticmethod
    def backward(ctx, *grads: Optional[torch.Tensor]):
        per, n = len(_SPECS), ctx.n_scales
        saved = ctx.saved_tensors
        kernels, fake = saved[:n * per], saved[n * per:]
        d_fake = grads[n * per:]
        d = None
        for i in range(n - 1, -1, -1):
            sl = slice(i * per, (i + 1) * per)
            g_i = _scale_backward(kernels[sl], fake[sl], d_fake[sl], ctx.lens[i])
            d = g_i if d is None else g_i + _pool_grad(d, ctx.lens[i])
        return (None, None, d) + (None,) * (3 * n * per)


def msd_g_apply(weights: Weights, y: torch.Tensor, y_hat: torch.Tensor):
    """``MultiScaleDiscriminator``'s forward from folded weights:
    ``(y_d_rs, y_d_gs, fmap_rs, fmap_gs)`` as the module returns them, so
    the GAN losses are unchanged; differentiable with respect to ``y_hat``
    only (the G step's contract)."""
    flat = [t for scale in weights for conv in scale for t in conv]
    outs = _MSDGStep.apply(len(weights), y, y_hat, *flat)
    per, n = len(_SPECS), len(weights)
    fmap_rs = [list(outs[i * per:(i + 1) * per]) for i in range(n)]
    fmap_gs = [list(outs[(n + i) * per:(n + i + 1) * per]) for i in range(n)]
    return ([f[-1].flatten(1) for f in fmap_rs], [f[-1].flatten(1) for f in fmap_gs],
            fmap_rs, fmap_gs)
