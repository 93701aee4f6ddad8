"""All-in-one convert + evaluate pipeline (reference ``scripts/convert_eval.py``;
``dissc_tpu.cli.convert_eval``).

    python -m dissc_tpu_torch.cli.convert_eval --data vctk --dissc_type dissc_b --sort_gt \
        --whisper_model /path/to/whisper-medium.en --dtw_align

Run from the directory that holds ``data/``, ``checkpoints/`` (inputs)
and where ``outputs/`` and ``results/`` are written: every path is
relative, as in the reference.  Where the reference chains five
subprocesses through the filesystem (``:55-57``), the stages run in this
process, calling the port's ``infer`` and ``sr_inference`` ``main(argv)``
with ``--device`` passed through; only the external MFA aligner is a
subprocess, run when ``mfa`` is on the ``PATH``.  Without it the metrics
use the reference's uniform fallback grids, or DTW grids with
``--dtw_align``.  ``--device`` (default: the CUDA card) picks where every
stage runs.
"""
import argparse
import json
import os
import shutil
import subprocess

from dissc_tpu_torch.cli import infer, sr_inference
from dissc_tpu_torch.core.wav import read_audio, write_wav
from dissc_tpu_torch.device import resolve_device
from dissc_tpu_torch.eval import align, asr, metrics


def _init_params(args):
    """Per-dataset constants (reference ``scripts/convert_eval.py:10-52``)."""
    if args.data == "vctk":
        c = dict(src_spk=["p231", "p239", "p245", "p270"],
                 trgt_spk=["p231", "p239", "p245", "p270"],
                 spk_dict={"p231": "6", "p239": "13", "p245": "18", "p270": "43"},
                 wanted_seq=list(range(1, 25)), data_path="data/VCTK/",
                 gt_suf="_mic2.flac", pred_suf="_mic2", tf_name="val", gt_pre="")
    elif args.data == "syn_vctk":
        c = dict(src_spk=["p231", "p232", "p233", "p239", "p245", "p270"],
                 trgt_spk=["p231", "p239", "p245", "p270"],
                 spk_dict={"p231": "6", "p239": "13", "p245": "18", "p270": "43"},
                 wanted_seq=list(range(1, 25)), data_path="data/Syn_VCTK/",
                 gt_suf=".wav", pred_suf="", tf_name="val", gt_pre="")
    elif args.data == "esd":
        c = dict(src_spk=["0014Sad", "0015Surprise", "0017Happy", "0019Sad"],
                 trgt_spk=["0014Sad", "0015Surprise", "0017Happy", "0019Sad"],
                 spk_dict={"0014Sad": "3", "0015Surprise": "4", "0017Happy": "6",
                           "0019Sad": "8"},
                 wanted_seq=list(range(1, 35)), data_path="data/ESD/",
                 gt_suf=".wav", pred_suf="", tf_name="test", gt_pre="paired_test/")
    else:
        raise SystemExit(f"unsupported dataset: {args.data} !")
    c["gen_path"] = f"outputs/{args.data}/{args.dissc_type}/"
    c["out_path"] = f"results/{args.data}/{args.dissc_type}/"
    return c


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="vctk", help="[vctk, esd, syn_vctk]")
    parser.add_argument("--dissc_type", default="dissc_b", help="[dissc_p, dissc_l, dissc_b]")
    parser.add_argument("--sort_gt", action="store_true")
    parser.add_argument("--whisper_model", default=None)
    parser.add_argument("--dtw_align", action="store_true",
                        help="DTW-transfer TextGrids from the reference recordings instead "
                             "of uniform fallback grids")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)")
    return parser


def filter_split(c) -> str:
    """The split's records of the wanted source speakers -> ``<tf_name>_sf.txt``."""
    path = f"{c['data_path']}/hubert100/"
    sf = path + f"{c['tf_name']}_sf.txt"
    with open(path + f"{c['tf_name']}.txt") as f_in, open(sf, "w+") as f_out:
        for line in f_in:
            if json.loads(line)["audio"].split("/")[-1].split("_")[0] in c["src_spk"]:
                f_out.write(line)
    return sf


def restructure(c) -> None:
    """Converted outputs -> ``results/<data>/<type>/<trg>/<src>_<seq>.wav``
    with each source transcript beside it (reference ``:96-122``)."""
    os.makedirs(c["out_path"], exist_ok=True)
    for t_spk in c["trgt_spk"]:
        os.makedirs(f"{c['out_path']}/{t_spk}", exist_ok=True)
        for spk in c["src_spk"]:
            for seq in c["wanted_seq"]:
                try:
                    shutil.copy(
                        f"{c['gen_path']}/{t_spk}/{spk}_{seq:03}{c['pred_suf']}_"
                        f"{c['spk_dict'][t_spk]}_gen.wav",
                        f"{c['out_path']}/{t_spk}/{spk}_{seq:03}.wav",
                    )
                    shutil.copy(f"{c['data_path']}/txt/{spk}/{spk}_{seq:03}.txt",
                                f"{c['out_path']}/{t_spk}/{spk}_{seq:03}.txt")
                except FileNotFoundError:
                    print(f"No sample: {spk}_{seq:03}, this is ok if it only happens "
                          "for few of the samples")


def sort_ground_truth(c, gt_path: str) -> None:
    """The ground truth -> ``results/<data>/orig/`` (reference ``:112-136``):
    each recording's first channel as a 16 kHz WAV, as the reference's
    torchaudio.load + scipy write, and its transcript."""
    os.makedirs(gt_path, exist_ok=True)
    for spk in c["src_spk"]:
        for seq in c["wanted_seq"]:
            src = f"{c['data_path']}/wav/{c['gt_pre']}/{spk}_{seq:03}{c['gt_suf']}"
            if os.path.exists(src):
                data, _ = read_audio(src, dtype="float32")
                if data.ndim > 1:
                    data = data[..., 0]
                write_wav(f"{gt_path}/{spk}_{seq:03}.wav", data, 16000)
                shutil.copy(f"{c['data_path']}/txt/{spk}/{spk}_{seq:03}.txt",
                            f"{gt_path}/{spk}_{seq:03}.txt")
            else:
                print(f"No sample: {spk}_{seq:03}")


def mfa_align(c, gt_path: str, sort_gt: bool) -> None:
    for t_spk in c["trgt_spk"]:
        os.makedirs(f"{c['out_path']}/{t_spk}/txtgrid", exist_ok=True)
        subprocess.run(["mfa", "align", "-s", "4", "--clean", f"{c['out_path']}/{t_spk}/",
                        "english_us_arpa", "english_us_arpa",
                        f"{c['out_path']}/{t_spk}/txtgrid/"], check=False)
    if sort_gt:
        os.makedirs(f"{gt_path}/txtgrid/", exist_ok=True)
        subprocess.run(["mfa", "align", "-s", "4", "--clean", gt_path, "english_us_arpa",
                        "english_us_arpa", f"{gt_path}/txtgrid/"], check=False)


def main(argv=None) -> dict:
    """Run every stage; returns ``calc_errors``' raw errors (also pickled to
    ``results/<data>/<type>_results.pkl``)."""
    args = build_parser().parse_args(argv)
    c = _init_params(args)
    device = resolve_device(args.device)  # refuse before touching a file
    dev = ["--device", str(device)]

    # 1. the split, cut to the wanted source speakers
    sf = filter_split(c)

    # 2. prosody conversion
    infer_args = [
        "--input_path", sf,
        "--out_path", f"{c['data_path']}/pred_hubert_{args.dissc_type}/",
        "--len_model", f"checkpoints/{args.data}/len/",
        "--f0_model", f"checkpoints/{args.data}/pitch/",
        "--f0_path", f"{c['data_path']}/hubert100/f0_stats.pkl",
        "--vc", "--target_speakers", *c["trgt_spk"], "-n", "1000",
        "--f0_model_type", "base" if args.data in ("vctk", "esd") else "new",
    ] + dev
    if args.dissc_type in ("dissc_l", "dissc_b"):
        infer_args.append("--pred_len")
    if args.dissc_type in ("dissc_p", "dissc_b"):
        infer_args.append("--pred_pitch")
    infer.main(infer_args)

    # 3. vocoder synthesis per target speaker
    os.makedirs(c["gen_path"], exist_ok=True)
    for t_spk in c["trgt_spk"]:
        sr_inference.main([
            "--input_code_file",
            f"{c['data_path']}/pred_hubert_{args.dissc_type}/{t_spk}_{c['tf_name']}_sf.txt",
            "--data_path", f"{c['data_path']}/wav/{c['gt_pre']}",
            "--output_dir", f"{c['gen_path']}/{t_spk}",
            "--checkpoint_file", f"checkpoints/{args.data.split('_')[-1]}_vocoder",
            "--vc", "--target-speakers", t_spk, "-n", "1000",
        ] + dev)

    # 4. the results tree, and the ground truth beside it
    restructure(c)
    gt_path = f"results/{args.data}/orig/"
    if args.sort_gt:
        sort_ground_truth(c, gt_path)

    # 5. alignment: MFA (external) when installed, DTW grids on request
    if shutil.which("mfa"):
        mfa_align(c, gt_path, args.sort_gt)
    else:
        print("mfa binary not found — FFE/duration metrics will use uniform fallback grids"
              + (" (dtw_align overrides below)" if args.dtw_align else ""))
    if args.dtw_align:
        n = align.write_dtw_textgrids(f"results/{args.data}", args.dissc_type, c["trgt_spk"],
                                      device=device)
        print(f"dtw_align: wrote {n} synthetic TextGrids")

    # 6. metrics
    transcribe = (asr.load_whisper(args.whisper_model, device) if args.whisper_model
                  else None)
    errs = metrics.calc_errors(f"results/{args.data}", args.dissc_type, c["trgt_spk"],
                               transcribe, device=device)
    metrics.log_results(errs, f"results/{args.data}", args.dissc_type)
    return errs


if __name__ == "__main__":
    main()
