"""Rhythm-predictor training CLI (reference ``train_len_predictor.py:117-133``;
``dissc_tpu.cli.train_len``).  ``--device`` (default: the CUDA card) picks
where the model trains; ``--device cpu`` trains on the CPU.

Data parallelism: under ``torchrun`` each process joins the group its
environment names; otherwise the CLI launches one rank a card over the
largest count of cards up to those present that divides ``--batch_size``
(the global batch), and trains in this process when that is 1 or on
``--device cpu``.  Rank 0 alone writes the logs and checkpoints."""
import argparse
import os

import torch

from dissc_tpu_torch.core.config import ProsodyConfig
from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.parallel import distributed
from dissc_tpu_torch.parallel.mesh import world_for_batch
from dissc_tpu_torch.train.prosody_trainer import train_len_predictor


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out_path", default="checkpoints/esd")
    parser.add_argument("--data_path", default="data/ESD/hubert100")
    parser.add_argument("--n_tokens", default=100, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the CUDA card; 'cpu' for the CPU)")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--learning_rate", default=3e-4, type=float)
    parser.add_argument("--n_epochs", default=30, type=int)
    return parser


def main(argv=None) -> str:
    """Train; returns the checkpoint directory."""
    args = build_parser().parse_args(argv)
    if distributed.under_launcher():
        return distributed.run(_train, (args,), 1, args.device)
    device = resolve_device(args.device)  # refuse before touching a file
    world = (world_for_batch(args.batch_size, torch.cuda.device_count())
             if device.type == "cuda" else 1)
    if world > 1:
        print(f"train_len: {world} ranks, {args.batch_size // world} of the batch each",
              flush=True)
    return (distributed.run(_train, (args,), world, device)
            or os.path.join(args.out_path, "len"))


def _train(device: torch.device, args) -> str:
    """One rank's (or the one process's) training run."""
    seed_everything(args.seed)
    os.makedirs(args.out_path, exist_ok=True)
    cfg = ProsodyConfig(n_tokens=args.n_tokens, batch_size=args.batch_size,
                        learning_rate=args.learning_rate, n_epochs=args.n_epochs, seed=args.seed)
    return train_len_predictor(args.data_path, args.out_path, cfg, device=device)


if __name__ == "__main__":
    main()
