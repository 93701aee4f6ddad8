"""Pitch-predictor training CLI (reference ``train_f0_predictor.py:110-128``;
``dissc_tpu.cli.train_f0``).  ``--device`` (default: the CUDA card) picks
where the model trains; ``--device cpu`` trains on the CPU."""
import argparse
import os

from dissc_tpu_torch.core.config import ProsodyConfig
from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.train.prosody_trainer import train_f0_predictor


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out_path", default="checkpoints/vctk")
    parser.add_argument("--data_path", default="data/VCTK/hubert100/")
    parser.add_argument("--n_tokens", default=100, type=int)
    parser.add_argument("--f0_path", default="data/VCTK/hubert100/f0_stats.pkl")
    parser.add_argument("--model_type", default="base",
                        help='type of model from ["base", "new"]')
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the CUDA card; 'cpu' for the CPU)")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--learning_rate", default=3e-4, type=float)
    parser.add_argument("--n_epochs", default=30, type=int)
    return parser


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # refuse before touching a file
    seed_everything(args.seed)
    os.makedirs(args.out_path, exist_ok=True)
    cfg = ProsodyConfig(n_tokens=args.n_tokens, batch_size=args.batch_size,
                        learning_rate=args.learning_rate, n_epochs=args.n_epochs, seed=args.seed,
                        model_type=args.model_type)
    return train_f0_predictor(args.data_path, args.f0_path, args.out_path, cfg,
                              device=device)


if __name__ == "__main__":
    main()
