"""Process groups for data-parallel training (``dissc_tpu.parallel.distributed``).

The reference joins NCCL through ``torch.distributed.launch`` and
``init_process_group("nccl", "env://")`` (``sr/train.py:23-24,36-41``) and
leaves checkpoints and logs to rank 0; the JAX package calls
``jax.distributed.initialize`` and asks ``is_coordinator``.  Here:

* :func:`initialize` joins a group, from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from
  explicit arguments: NCCL for the CUDA card, gloo for the CPU.  A CUDA
  rank is bound to ``cuda:LOCAL_RANK``; NCCL needs one card a rank and
  raises otherwise, gloo lets ranks share a card.  It raises if the
  group cannot start: a first all-reduce runs before it returns;
* :func:`launch` starts W ranks itself when the caller is not under
  torchrun, with a ``file://`` rendezvous in a fresh temporary directory
  (or ``tcp://127.0.0.1:<port>`` when a port is given), never a fixed port;
  :func:`run` picks between torchrun's rank, one process and
  :func:`launch` for the training CLIs;
* :func:`is_coordinator`, :func:`rank`, :func:`world_size`,
  :func:`global_device_count` and :func:`local_device_count` answer as the
  JAX functions do, and as one process on one device without a group.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from dissc_tpu_torch.device import DeviceLike, resolve_device

TIMEOUT = datetime.timedelta(minutes=10)  # a rank that waits longer raises


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def under_launcher() -> bool:
    """True when torchrun (or ``torch.distributed.launch``) started this
    process: its environment names the rank and the world."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and logs (the
    reference's ``rank == 0``)."""
    return rank() == 0


def local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def global_device_count() -> int:
    """Devices the job trains on: one a rank under a group, else the
    cards of this host."""
    return world_size() if is_initialized() else local_device_count()


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize(device: DeviceLike = None, backend: Optional[str] = None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, local_rank: Optional[int] = None
               ) -> torch.device:
    """Join the process group; returns this rank's device.

    Arguments left ``None`` come from the environment (``init_method``
    ``env://``).  ``device``: ``None`` or ``"cuda"`` binds the rank to
    ``cuda:LOCAL_RANK`` (modulo the cards, for gloo); ``"cpu"`` stays on
    the CPU.  ``backend``: NCCL for a card, gloo for the CPU, unless given."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    backend = backend or backend_for(dev)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= cards:
            raise RuntimeError(f"NCCL needs one card a rank: local rank {local_rank} of "
                               f"{cards} card(s)")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"the group's first all-reduce gave {probe.item()}, not {world_size}")
    return dev


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def run(fn: Callable[..., Any], args: tuple, world: int, device: DeviceLike,
        port: Optional[int] = None, local_rank: Optional[int] = None) -> Any:
    """A CLI's training run over its ranks: under torchrun, this process's
    rank (joined from the environment; ``local_rank`` where the launcher
    passed it as a flag); else ``fn(device, *args)`` in this process when
    ``world`` is 1; else ``world`` ranks started by :func:`launch`.  Returns
    ``fn``'s result, or ``None`` after :func:`launch`."""
    if under_launcher():
        dev = initialize(device, local_rank=local_rank)
        try:
            return fn(dev, *args)
        finally:
            destroy()
    if world == 1:
        return fn(resolve_device(device), *args)
    launch(fn, world, args, device=device, port=port)
    return None


def _rank_main(local_rank: int, fn: Callable[..., Any], world: int, device: str,
               backend: Optional[str], init_method: str, args: tuple) -> None:
    dev = initialize(device, backend, init_method=init_method, rank=local_rank,
                     world_size=world, local_rank=local_rank)
    try:
        fn(dev, *args)
    finally:
        destroy()


def launch(fn: Callable[..., Any], world: int, args: tuple = (), device: DeviceLike = "cuda",
           backend: Optional[str] = None, port: Optional[int] = None) -> None:
    """Run ``fn(rank_device, *args)`` on ``world`` new processes, one a rank,
    joined by :func:`initialize`; returns when all have ended, and raises
    (after stopping the others) if one fails.

    ``fn`` and ``args`` must pickle: the ranks are spawned, so each imports
    ``fn``'s module afresh (and the caller's ``__main__`` module, which must
    guard its entry point).  The rendezvous is a file in a fresh temporary
    directory, or ``tcp://127.0.0.1:port`` when ``port`` is given."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dissc_rendezvous_") as tmp:
        init = (f"tcp://127.0.0.1:{port}" if port
                else "file://" + os.path.join(tmp, "rendezvous"))
        mp.start_processes(_rank_main, args=(fn, world, str(resolve_device(device).type),
                                             backend, init, args),
                           nprocs=world, join=True, start_method="spawn")
