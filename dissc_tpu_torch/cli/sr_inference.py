"""Vocoder inference CLI (reference ``sr/inference.py:263-281`` flag surface;
``dissc_tpu.cli.sr_inference``).

    python -m dissc_tpu_torch.cli.sr_inference --input_code_file val.txt --vc

The reference's 8-process GPU pool is replaced by batching on one card
(:class:`~dissc_tpu_torch.infer.vocoder.VocoderEngine`).  ``--device``
(default: the CUDA card) picks where the generator runs; ``--device cpu``
runs it on the CPU.  ``--data_devices`` above 1 raises (multi-GPU slice);
a negative count is a usage error (exit 2).
"""
import argparse
from pathlib import Path

from dissc_tpu_torch.cli.infer import one_card
from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.infer.vocoder import run_inference


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--code_file", default=None)
    parser.add_argument("--input_code_file", default="data/wild/pred_hubert/p239_encoded.txt")
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--output_dir", default="debug")
    parser.add_argument("--checkpoint_file", default="checkpoints/vctk_hubert/")
    parser.add_argument("--f0-stats", dest="f0_stats", type=Path, default=None)
    parser.add_argument("--vc", action="store_true")
    parser.add_argument("--target-speakers", dest="target_speakers", default=None, nargs="+")
    parser.add_argument("--pad", default=None, type=int)
    parser.add_argument("--debug", action="store_true", help="kept for CLI compat")
    # store_false and never read, as in the reference: inference is always eval mode
    parser.add_argument("--eval_mode", action="store_false", help="kept for CLI compat")
    parser.add_argument("--parts", action="store_true")
    parser.add_argument("--unseen-f0", dest="unseen_f0", type=Path, default=None)
    parser.add_argument("--unseen_speaker", action="store_true")
    parser.add_argument("--id_to_spkr", default=None, type=Path)
    parser.add_argument("--sample_df", default=None, type=Path)
    parser.add_argument("-n", type=int, default=-1)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--data_devices", type=int, default=0,
                        help="cards to split synthesis batches over (0 or 1: the one card)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)")
    return parser


def main(argv=None) -> float:
    """Synthesise; returns the mean RTF."""
    parser = build_parser()
    args = parser.parse_args(argv)
    one_card(parser, args.data_devices)
    device = resolve_device(args.device)  # refuse before touching a file
    seed_everything(52)
    rtf = run_inference(
        checkpoint_file=args.checkpoint_file,
        input_code_file=args.input_code_file,
        output_dir=args.output_dir,
        data_path=args.data_path,
        vc=args.vc,
        target_speakers=args.target_speakers,
        f0_stats_path=str(args.f0_stats) if args.f0_stats else None,
        unseen_speaker=args.unseen_speaker,
        id_to_spkr_path=str(args.id_to_spkr) if args.id_to_spkr else None,
        pad=args.pad,
        n=args.n,
        batch_size=args.batch_size,
        code_file=args.code_file,
        unseen_f0_path=str(args.unseen_f0) if args.unseen_f0 else None,
        sample_df_path=str(args.sample_df) if args.sample_df else None,
        parts=args.parts,
        device=device,
    )
    print(f"\nmean RTF: {rtf:.4f}")
    return rtf


if __name__ == "__main__":
    main()
