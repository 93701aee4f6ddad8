"""Audio preprocessing CLI (reference ``data/preprocess.py``;
``dissc_tpu.cli.preprocess``).

    python -m dissc_tpu_torch.cli.preprocess --srcdir raw/ --outdir wav16/ --trim --pad

Resample to 16 kHz (scipy), optionally trim silence (top_db 20) and
zero-pad to a multiple of 1280 samples, over a process pool.  The work is
host numpy and scipy; ``--device`` is checked as every CLI of the port
checks it (the card by default, raising without one; ``cpu`` to run with
no card) and nothing here touches CUDA.  The pool is started with
``spawn``: a forked child of a process that holds a CUDA context, or
threads, is unsafe.
"""
import argparse
import multiprocessing
from functools import partial
from pathlib import Path

import numpy as np

from dissc_tpu_torch.audio.resample import resample_poly_np, trim_silence
from dissc_tpu_torch.core.wav import read_wav, write_wav
from dissc_tpu_torch.device import resolve_device


def pad_data(p: Path, out_dir: Path, trim: bool = False, pad: bool = False) -> None:
    data, sr = read_wav(str(p), dtype="float32")
    if sr != 16000:
        data = resample_poly_np(data, sr, 16000)
        sr = 16000
    if trim:
        data, _ = trim_silence(data, top_db=20)
    if pad and data.shape[0] % 1280 != 0:
        data = np.pad(data, (0, 1280 - data.shape[0] % 1280), mode="constant")
    outpath = out_dir / p.name
    outpath.parent.mkdir(exist_ok=True, parents=True)
    write_wav(str(outpath), data, sr)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--srcdir", type=Path, required=True)
    parser.add_argument("--outdir", type=Path, required=True)
    parser.add_argument("--trim", action="store_true")
    parser.add_argument("--pad", action="store_true")
    parser.add_argument("--postfix", type=str, default="wav")
    parser.add_argument("--workers", type=int, default=40)
    parser.add_argument("--device", default=None,
                        help="checked only: the work runs on the host (default: the CUDA "
                             "card; 'cpu' to run without one)")
    return parser


def main(argv=None) -> int:
    """Process every ``*<postfix>`` file under ``--srcdir``; returns the count."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    files = list(Path(args.srcdir).glob(f"**/*{args.postfix}"))
    fn = partial(pad_data, out_dir=Path(args.outdir), trim=args.trim, pad=args.pad)
    if args.workers <= 1:
        for f in files:
            fn(f)
    else:
        with multiprocessing.get_context("spawn").Pool(args.workers) as p:
            list(p.imap(fn, files))
    print(f"processed {len(files)} files -> {args.outdir}")
    return len(files)


if __name__ == "__main__":
    main()
