"""Seeded inputs: weights made on the device from a seed in a few large
calls, and the sub-seeds every other input is drawn from.

A spec maps a parameter name to ``(shape, init)``, where ``init`` is
``("normal", std)``, ``("uniform", bound)``, ``("const", value)`` or
``("norm_of", name)`` (a weight-norm gain equal to the norm of that
``weight_v`` over every dim but 0, so the weight is ``v`` itself).  All
normal draws of a spec come from one ``randn`` call and all uniform ones
from one ``rand`` call, on the device, in float32.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the input named ``tag`` of run ``seed`` (any whole
    number, negative or past 64 bits included)."""
    words = [int(w) for w in np.frombuffer(int(seed).to_bytes(16, "little", signed=True),
                                           np.uint32)]
    state = np.random.SeedSequence(words + [zlib.crc32(tag.encode())]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def materialize(spec: Dict[str, tuple], seed: int, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """The tensors of ``spec`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kinds = {"normal": [], "uniform": []}
    for name, (shape, init) in spec.items():
        if init[0] in kinds:
            kinds[init[0]].append((name, shape, init[1]))
    out: Dict[str, torch.Tensor] = {}
    for kind, items in kinds.items():
        total = sum(math.prod(shape) for _, shape, _ in items)
        if not total:
            continue
        if kind == "normal":
            buf = torch.randn(total, generator=gen, device=device)
        else:
            buf = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
        offset = 0
        for name, shape, scale in items:
            n = math.prod(shape)
            out[name] = buf[offset:offset + n].view(shape).mul_(scale)
            offset += n
    for name, (shape, init) in spec.items():
        if init[0] == "const":
            dtype = torch.int64 if name.endswith("num_batches_tracked") else torch.float32
            out[name] = torch.full(shape, init[1], dtype=dtype, device=device)
        elif init[0] == "norm_of":
            v = out[init[1]]
            out[name] = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return {name: out[name] for name in spec}
