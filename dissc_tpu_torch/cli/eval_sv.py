"""Speaker-verification EER CLI (reference ``eval_sv.py:28-58`` surface;
``dissc_tpu.cli.eval_sv``).

    python -m dissc_tpu_torch.cli.eval_sv --base_path results/vctk --method dissc_b \
        --speechbrain_ckpt embedding_model.ckpt

Scores the (ground truth, converted) pairs of
``<base_path>/speaker_verification.csv`` with an ECAPA-TDNN cosine scorer
and prints the EER.  The embedder is either the JAX layout's pickle of
``(params, batch_stats)`` (``--embedder``, as
``dissc_tpu.train.checkpoints.save_checkpoint`` writes the JAX converter's
output: numpy arrays and dicts only) or speechbrain's
``embedding_model.ckpt`` (``--speechbrain_ckpt``, read with
``torch.load(weights_only=True)``).  ``--device`` (default: the CUDA
card) is where ECAPA runs; ``--device cpu`` runs it on the CPU.
"""
import argparse

import torch

from dissc_tpu_torch.compat.from_jax import ecapa_state_dict
from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.eval.sv import cosine_scorer, run_sv_eval
from dissc_tpu_torch.models.ecapa import EcapaEmbedder, convert_speechbrain_state_dict
from dissc_tpu_torch.train.checkpoints import load_checkpoint

NO_EMBEDDER = (
    "Provide --embedder (converted pickle) or --speechbrain_ckpt "
    "(embedding_model.ckpt). Pretrained ECAPA weights are not bundled with "
    "the port; alternatively call dissc_tpu_torch.eval.sv.run_sv_eval with "
    "any injected score_fn.")


def load_embedder(args, device) -> EcapaEmbedder:
    """The ``EcapaEmbedder`` the flags name, on ``device``."""
    if args.embedder:
        params, batch_stats = load_checkpoint(args.embedder)
        return EcapaEmbedder(ecapa_state_dict(params, batch_stats), device=device)
    if args.speechbrain_ckpt:
        sd = torch.load(args.speechbrain_ckpt, map_location="cpu", weights_only=True)
        return EcapaEmbedder(convert_speechbrain_state_dict(sd), device=device)
    raise SystemExit(NO_EMBEDDER)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_path", default="../results/vctk/")
    parser.add_argument("--gt_path", default="data/vctk/wav16_trimmed_padded/")
    parser.add_argument("--file_suffix", default="_mic2.flac")
    parser.add_argument("--method", default="sr")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)")
    parser.add_argument("--embedder", default=None,
                        help="converted ECAPA checkpoint pickle (params, batch_stats)")
    parser.add_argument("--speechbrain_ckpt", default=None,
                        help="raw speechbrain embedding_model.ckpt")
    return parser


def main(argv=None) -> float:
    """Score every pair; returns the EER."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # refuse before touching a file
    embedder = load_embedder(args, device)
    return run_sv_eval(
        sample_csv=f"{args.base_path}/speaker_verification.csv",
        gt_path=args.gt_path,
        syn_path=f"{args.base_path}/sv/{args.method}/",
        score_fn=cosine_scorer(embedder),
        file_suffix=args.file_suffix,
    )


if __name__ == "__main__":
    main()
