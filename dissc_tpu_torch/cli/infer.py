"""Prosody-conversion CLI (reference ``infer.py:174-206`` flag surface;
``dissc_tpu.cli.infer``).

    python -m dissc_tpu_torch.cli.infer --input_path val.txt --pred_len --pred_pitch --vc

``--device`` (default: the CUDA card) picks where the models run;
``--device cpu`` runs them on the CPU.  ``--data_devices`` above 1 (a
multi-card split) waits for the multi-GPU slice and raises; a negative
count is a usage error (exit 2).
"""
import argparse
import os

from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.infer.prosody import infer_file


def one_card(parser: argparse.ArgumentParser, data_devices: int) -> None:
    """``--data_devices`` 0 or 1 is the one card; a negative count is a
    usage error (exit 2), as the JAX CLIs refuse it; a split over more
    cards is not ported yet (ROADMAP Queue 1, slice I) and raises."""
    if data_devices < 0:
        parser.error(f"--data_devices must be 0 or more, got {data_devices}")
    if data_devices > 1:
        raise NotImplementedError(
            f"--data_devices {data_devices}: splitting batches over several cards comes "
            "with the multi-GPU slice (ROADMAP Queue 1, slice I); use 0 or 1")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_path", default="data/VCTK/hubert100/val.txt",
                        help="Path to txt file of encoded HuBERT data")
    parser.add_argument("-n", default=10, type=int,
                        help="number of samples to perform inference on")
    parser.add_argument("--out_path", default="data/VCTK/pred_hubert",
                        help="Path to save predicted sequence")
    parser.add_argument("--pred_len", action="store_true",
                        help="If true we predict the output length as well")
    parser.add_argument("--pred_pitch", action="store_true",
                        help="If true we predict the output pitch as well")
    parser.add_argument("--len_model", default="checkpoints/vctk/len/",
                        help="Path of len prediction model")
    parser.add_argument("--f0_model", default="checkpoints/vctk/pitch/",
                        help="Path of pitch prediction model & stats")
    parser.add_argument("--f0_model_type", default="new",
                        help='type of model from ["base", "new"]')
    parser.add_argument("--n_tokens", default=100, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--f0_path", default="data/VCTK/hubert100/f0_stats.pkl")
    parser.add_argument("--vc", action="store_true",
                        help="If true we convert speakers and not only reconstruct")
    # store_false like the reference: default True, the flag turns de-whitening off
    parser.add_argument("--norm_pitch", action="store_false",
                        help="If true we output a per-speaker normalised pitch")
    parser.add_argument("--target_speakers", nargs="+", default=None)
    parser.add_argument("--sample_df", default=None,
                        help="Path for specific conversions for each sample")
    parser.add_argument("--wild_sample", action="store_true")
    parser.add_argument("--id_to_spkr", default=None)
    parser.add_argument("--data_devices", type=int, default=0,
                        help="cards to split conversion batches over (0 or 1: the one card)")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    assert args.pred_len | args.pred_pitch, \
        "Inference must at least convert pitch or rhythm (or both)"
    assert (args.wild_sample & args.pred_len & args.pred_pitch) | (not args.wild_sample), \
        "If we use an unknown speaker we must convert both pitch and rhythm"
    one_card(parser, args.data_devices)
    device = resolve_device(args.device)  # refuse before touching a file
    seed_everything(args.seed)
    os.makedirs(args.out_path, exist_ok=True)
    infer_file(
        input_path=args.input_path,
        out_path=args.out_path,
        len_model_dir=args.len_model if args.pred_len else None,
        f0_model_dir=args.f0_model if args.pred_pitch else None,
        f0_model_type=args.f0_model_type,
        f0_stats_path=args.f0_path,
        id_to_spkr_path=args.id_to_spkr,
        n=args.n if not args.wild_sample else None,
        vc=args.vc,
        target_speakers=args.target_speakers,
        norm_pitch=args.norm_pitch,
        n_tokens=args.n_tokens,
        wild=args.wild_sample,
        sample_df=args.sample_df,
        device=device,
    )


if __name__ == "__main__":
    main()
