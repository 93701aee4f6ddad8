"""Conversion-metrics CLI (reference ``eval.py:148-161`` surface;
``dissc_tpu.cli.eval``).

    python -m dissc_tpu_torch.cli.eval --base_path results/vctk --method dissc_b \
        --whisper_model /path/to/whisper-medium.en --dtw_align

``--device`` (default: the CUDA card) picks where YAAPT, the DTW log-mels
and Whisper run; ``--device cpu`` runs them on the CPU.  The JAX CLI
defaults to the CPU because its TPU matmuls run in bf16; the port computes
in float32 with TF32 off on the card, so that reason does not carry over.
"""
import argparse

from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.eval.align import write_dtw_textgrids
from dissc_tpu_torch.eval.asr import load_whisper
from dissc_tpu_torch.eval.metrics import calc_errors, log_results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_path", default="../results/vctk/")
    parser.add_argument("--method", default="sr")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)")
    parser.add_argument("--target_speakers", nargs="+",
                        default=["p231", "p239", "p245", "p270"])
    parser.add_argument("--whisper_model", default=None,
                        help="Local Whisper checkpoint dir; omit to skip WER/CER")
    parser.add_argument("--dtw_align", action="store_true",
                        help="Synthesize TextGrids by DTW boundary transfer from the reference "
                             "recordings (when mfa is absent; the default keeps the "
                             "reference's uniform-grid behaviour)")
    return parser


def main(argv=None) -> dict:
    """Score the results tree; returns ``log_results``' summary."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    transcribe = load_whisper(args.whisper_model, device) if args.whisper_model else None
    if args.dtw_align:
        n = write_dtw_textgrids(args.base_path, args.method, args.target_speakers,
                                device=device)
        print(f"dtw_align: wrote {n} synthetic TextGrids")
    errs = calc_errors(args.base_path, args.method, args.target_speakers, transcribe,
                       device=device)
    return log_results(errs, args.base_path, args.method)


if __name__ == "__main__":
    main()
