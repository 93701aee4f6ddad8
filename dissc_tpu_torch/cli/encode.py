"""HuBERT unit-encoding CLI (reference ``data/encode.py`` surface;
``dissc_tpu.cli.encode``).

    python -m dissc_tpu_torch.cli.encode --base_dir wav16/ --out_file hubert100/all.txt \
        --hubert_weights hubert.pkl --kmeans_codebook km100.npy

Reads the JAX package's HuBERT parameter pickle and a ``[vocab, width]``
k-means codebook (``.npy`` or pickle) and appends one JSONL record
(``units``, ``f0``, ``audio``) per file.  ``--device`` (default: the CUDA
card) picks where HuBERT and YAAPT run.

One deliberate difference from the JAX CLI, which catches every exception
of a file and goes on: here only a file the readers refuse is skipped
(``ValueError``, ``OSError``, ``EOFError`` and ``wave.Error``, around
the read).  An error of
the encoder, a CUDA or build error among them, propagates.
"""
import argparse
import json
import os
import wave
from pathlib import Path

from dissc_tpu_torch.core.wav import read_wav
from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.models.hubert import load_encoder


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="hubert-base-ls960",
                        help="dense model name (informational)")
    parser.add_argument("--quantizer_name", default="kmeans")
    parser.add_argument("--vocab_size", default=100, type=int)
    parser.add_argument("--base_dir", required=True, help="Input audio dir")
    parser.add_argument("--out_file", required=True, help="Output JSONL path")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)")
    parser.add_argument("--hubert_weights", required=True,
                        help="HuBERT params (the JAX package's pickle)")
    parser.add_argument("--kmeans_codebook", required=True,
                        help="[vocab, width] k-means centroids (.npy or pickle)")
    return parser


def main(argv=None) -> int:
    """Encode every file of ``--base_dir`` (sorted); returns the count written."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # refuse before touching a file
    encoder = load_encoder(args.hubert_weights, args.kmeans_codebook, device=device)
    os.makedirs(Path(args.out_file).parent.absolute(), exist_ok=True)

    input_files = sorted(os.listdir(args.base_dir))
    n_done = 0
    for file in input_files:
        try:
            wav, sr = read_wav(os.path.join(args.base_dir, file), dtype="float32")
        except (ValueError, OSError, EOFError, wave.Error) as e:  # not a readable recording
            print(f"\nProblem encoding sample {file}: {e}")
            continue
        encoded = encoder(wav, sr)
        encoded["audio"] = file
        with open(args.out_file, "a+") as f:
            f.write(f"{json.dumps(encoded)}\n")
        n_done += 1
    print(f"encoded {n_done}/{len(input_files)} files -> {args.out_file}")
    return n_done


if __name__ == "__main__":
    main()
