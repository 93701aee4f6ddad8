"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.
With no card and no explicit request they raise: the port never carries
on silently on the CPU.

On the card the port computes in full float32: :func:`resolve_device`
turns TF32 off for cuBLAS and cuDNN (PyTorch's cuDNN default is TF32,
which keeps about three decimal digits; the JAX reference runs its DFT
at ``Precision.HIGHEST``).  It also keeps cuBLAS's bfloat16 products
accumulating in float32 (no bfloat16 reduction of split-K partial
sums), as XLA accumulates them, for the opt-in bfloat16 compute paths.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def generator_for(seed: Optional[int]) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded for parameter init (weights are made
    on the CPU and moved, so a seed gives the same weights on any device)."""
    g = torch.Generator()
    g.manual_seed(0 if seed is None else int(seed))
    return g
