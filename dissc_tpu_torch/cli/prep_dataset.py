"""Dataset split + f0-stats CLI (reference ``data/prep_dataset.py``;
``dissc_tpu.cli.prep_dataset``).

    python -m dissc_tpu_torch.cli.prep_dataset --encoded_path hubert100/all.txt \
        --stats_path hubert100/f0_stats.pkl --split_method paired_val

Host-only (JSONL and pickles).  ``--device`` is checked as every CLI of
the port checks it (the card by default, raising without one; ``cpu`` to
run with no card).
"""
import argparse

from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.data.stats import calculate_pitch_stats, data_split
from dissc_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--encoded_path", default="ESD/hubert100/train.txt")
    parser.add_argument("--stats_path", default="ESD/hubert100/f0_stats.pkl")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--split_method", default=None,
                        help="random | paired_val | None (no split)")
    parser.add_argument("--device", default=None,
                        help="checked only: the work runs on the host (default: the CUDA "
                             "card; 'cpu' to run without one)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.seed is not None:
        seed_everything(args.seed)
    if args.split_method:
        train_path, _ = data_split(args.encoded_path, split_method=args.split_method)
    else:
        train_path = args.encoded_path
    calculate_pitch_stats(str(train_path), args.stats_path)


if __name__ == "__main__":
    main()
