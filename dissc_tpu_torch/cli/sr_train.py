"""Vocoder training CLI (reference ``sr/train.py:290-330`` flag surface;
``dissc_tpu.cli.sr_train``).

    python -m dissc_tpu_torch.cli.sr_train --config config.json --checkpoint_path ckpt/

``--device`` (default: the CUDA card) picks where the model trains;
``--device cpu`` runs the plain path on the CPU.
"""
import argparse

from dissc_tpu_torch.core.config import VocoderConfig, build_env
from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.device import resolve_device
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
    # --fine_tuning are parsed and never read by the reference trainer; the
    # --local_rank/--distributed-* trio is torch.distributed launcher
    # plumbing.  They are accepted so reference launch lines run, and ignored.
    parser.add_argument("--group_name", default=None,
                        help="kept for CLI compat; unused (as in the reference)")
    parser.add_argument("--fine_tuning", default=False, type=bool,
                        help="kept for CLI compat; unused (as in the reference)")
    parser.add_argument("--local_rank", default=0, type=int,
                        help="kept for CLI compat; one process trains on one device")
    parser.add_argument("--distributed-world-size", type=int,
                        help="kept for CLI compat; one process trains on one device")
    parser.add_argument("--distributed-port", type=int,
                        help="kept for CLI compat; one process trains on one device")
    return parser


def main(argv=None):
    """Train; returns :func:`train_vocoder`'s ``(trainer, stats)``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # refuse before touching a file
    h = VocoderConfig.from_json(args.config)
    seed_everything(h.seed)
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
