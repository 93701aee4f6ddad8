"""Vocoder training CLI (reference ``sr/train.py:290-330`` flag surface;
``dissc_tpu.cli.sr_train``).

    python -m dissc_tpu_torch.cli.sr_train --config config.json --checkpoint_path ckpt/

``--device`` (default: the CUDA card) picks where the model trains;
``--device cpu`` runs the plain path on the CPU.

Data parallelism (the reference's DDP, ``sr/train.py:23-24,36-41``):

* under ``torchrun`` (or ``torch.distributed.launch``, which passes
  ``--local_rank``) each process joins the group its environment names;
* otherwise the CLI launches the ranks itself: W =
  ``--distributed-world-size``, or by default the largest count of cards up
  to those present that divides the config's (global) ``batch_size``; one
  process on ``--device cpu`` unless W is given.  ``--distributed-port``
  makes the rendezvous ``tcp://127.0.0.1:<port>`` (default: a file in a
  temporary directory).  At W = 1 it trains in this process with no group.

Rank 0 alone copies the config and writes checkpoints and logs.  ``main``
returns :func:`train_vocoder`'s ``(trainer, stats)``, or rank 0's under
torchrun, and ``None`` after launching several ranks itself.
"""
import argparse
import os

import torch

from dissc_tpu_torch.core.config import VocoderConfig, build_env
from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.parallel import distributed
from dissc_tpu_torch.parallel.mesh import world_for_batch
from dissc_tpu_torch.train.vocoder_trainer import train_vocoder


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", default="checkpoints/vctk_vocoder")
    parser.add_argument("--config", default="configs/VCTK/hubert100_lut.json")
    parser.add_argument("--training_epochs", default=2000, type=int)
    parser.add_argument("--training_steps", default=400000, type=int)
    parser.add_argument("--stdout_interval", default=5, type=int)
    parser.add_argument("--checkpoint_interval", default=10000, type=int)
    parser.add_argument("--summary_interval", default=100, type=int)
    parser.add_argument("--validation_interval", default=1000, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the CUDA card; 'cpu' for the CPU)")
    # Reference-compat no-ops (sr/train.py:295,304-307): --group_name and
    # --fine_tuning are parsed and never read by the reference trainer.
    parser.add_argument("--group_name", default=None,
                        help="kept for CLI compat; unused (as in the reference)")
    parser.add_argument("--fine_tuning", default=False, type=bool,
                        help="kept for CLI compat; unused (as in the reference)")
    parser.add_argument("--local_rank", default=0, type=int,
                        help="this process's card under torch.distributed.launch "
                             "(torchrun sets LOCAL_RANK instead)")
    parser.add_argument("--distributed-world-size", type=int,
                        help="ranks to launch (default: the cards that divide the batch)")
    parser.add_argument("--distributed-port", type=int,
                        help="rendezvous port on 127.0.0.1 for the launched ranks "
                             "(default: a file rendezvous)")
    return parser


def main(argv=None):
    """Train (see the module docstring for the ranks)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if distributed.under_launcher():
        local = None if "LOCAL_RANK" in os.environ else args.local_rank
        return distributed.run(_train, (args,), 1, args.device, local_rank=local)
    device = resolve_device(args.device)  # refuse before touching a file
    h = VocoderConfig.from_json(args.config)
    world = args.distributed_world_size
    if world is None:
        world = (world_for_batch(h.batch_size, torch.cuda.device_count())
                 if device.type == "cuda" else 1)
    if world < 1 or h.batch_size % world:
        parser.error(f"--distributed-world-size {world} must divide batch_size {h.batch_size}")
    if device.type == "cuda" and world > torch.cuda.device_count():
        parser.error(f"--distributed-world-size {world} but "
                     f"{torch.cuda.device_count()} CUDA card(s) present")
    print(f"sr_train: {world} rank(s) on {device.type}, {h.batch_size // world} of the "
          f"batch of {h.batch_size} each", flush=True)
    return distributed.run(_train, (args,), world, device, port=args.distributed_port)


def _train(device: torch.device, args):
    """One rank's (or the one process's) training run."""
    h = VocoderConfig.from_json(args.config)
    seed_everything(h.seed)
    if distributed.is_coordinator():
        build_env(args.config, "config.json", args.checkpoint_path)
    return train_vocoder(
        h, args.checkpoint_path,
        training_steps=args.training_steps,
        training_epochs=args.training_epochs,
        stdout_interval=args.stdout_interval,
        checkpoint_interval=args.checkpoint_interval,
        summary_interval=args.summary_interval,
        validation_interval=args.validation_interval,
        device=device,
    )


if __name__ == "__main__":
    main()
