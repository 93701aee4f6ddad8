"""Speaker-verification convert + evaluate pipeline (reference
``scripts/convert_eval_sv.py``; ``dissc_tpu.cli.convert_eval_sv``).

    python -m dissc_tpu_torch.cli.convert_eval_sv --data vctk --dissc_type dissc_b \
        --speechbrain_ckpt embedding_model.ckpt

Run from the directory that holds ``data/`` and ``checkpoints/``; every
path is relative, as in the reference.  Prosody-converts the pairs of
``<data>/speaker_verification.csv`` (``infer --vc --sample_df``), vocodes
each target speaker's pairs (``sr_inference --sample_df -n 1000``),
copies them to ``results/<data>/sv/<type>/<target>/<sample>.wav`` and,
given ECAPA weights, scores the EER (``eval_sv``).  The stages run in this
process through the port's CLIs' ``main(argv)``, ``--device`` passed on
(default: the CUDA card).
"""
import argparse
import os
import shutil
from pathlib import Path

from dissc_tpu_torch.cli import eval_sv, infer, sr_inference
from dissc_tpu_torch.data.stats import load_id_to_spkr, read_sv_pairs
from dissc_tpu_torch.device import resolve_device

VCTK_SPEAKERS = [
    'p244', 'p236', 'p300', 'p265', 'p288', 'p304', 'p302', 'p334', 'p232', 'p253', 'p286',
    'p284', 'p227', 'p228', 'p317', 'p258', 'p261', 'p329', 'p339', 'p347', 'p272', 'p271',
    'p293', 'p308', 'p249', 'p237', 'p361', 'p252', 'p273', 'p305', 'p274', 'p364', 'p263',
    'p298', 'p276', 'p241', 'p260', 'p341', 'p299', 'p330', 'p256', 'p264', 'p259', 'p374',
    'p239', 'p351', 'p311', 's5', 'p282', 'p257', 'p313', 'p307', 'p310', 'p323', 'p360',
    'p363', 'p312', 'p306', 'p343', 'p247', 'p314', 'p292', 'p266', 'p255', 'p230', 'p287',
    'p234', 'p238', 'p250', 'p275', 'p233', 'p262', 'p326', 'p279', 'p345', 'p333', 'p246',
    'p254', 'p243', 'p295', 'p240', 'p248', 'p229', 'p245', 'p376', 'p318', 'p316', 'p268',
    'p231', 'p226', 'p285', 'p294', 'p283', 'p362', 'p251', 'p269', 'p270', 'p297', 'p278',
    'p336', 'p281', 'p225', 'p267', 'p303', 'p340', 'p301', 'p277', 'p335']
ESD_SPEAKERS = ['0019Sad', '0012Happy', '0013Neutral', '0016Angry', '0011Angry',
                '0018Neutral', '0017Happy', '0020Surprise', '0015Surprise', '0014Sad']


def _init_params(args):
    """Per-dataset constants (reference ``scripts/convert_eval_sv.py``)."""
    if args.data == "vctk":
        c = dict(spk=VCTK_SPEAKERS, data_path="data/VCTK/", gt_suf="_mic2.flac",
                 pred_suf="_mic2", tf_name="val", gt_pre="")
    elif args.data == "esd":
        c = dict(spk=ESD_SPEAKERS, data_path="data/ESD/", gt_suf=".wav", pred_suf="",
                 tf_name="test", gt_pre="paired_test/")
    else:
        raise SystemExit(f"unsupported dataset: {args.data} !")
    c["gen_path"] = f"outputs/{args.data}/sv/{args.dissc_type}/"
    c["out_path"] = f"results/{args.data}/sv/{args.dissc_type}/"
    return c


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="vctk", help="[vctk, esd]")
    parser.add_argument("--dissc_type", default="dissc_b", help="[dissc_p, dissc_l, dissc_b]")
    parser.add_argument("--embedder", default=None,
                        help="converted ECAPA checkpoint pickle for EER scoring")
    parser.add_argument("--speechbrain_ckpt", default=None,
                        help="raw speechbrain embedding_model.ckpt for EER scoring")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)")
    return parser


def restructure(c, rows) -> None:
    """Each pair's synthesis -> ``results/<data>/sv/<type>/<target>/<sample>.wav``,
    and the pair CSV to ``results/<data>/`` (reference ``:84-93``); a
    missing synthesis is printed."""
    spkr2id = {n: i for i, n in enumerate(load_id_to_spkr(f"{c['data_path']}/hubert100/"
                                                          "id_to_spkr.pkl"))}
    os.makedirs(c["out_path"], exist_ok=True)
    shutil.copy(f"{c['data_path']}/speaker_verification.csv",
                f"{Path(c['out_path']).parent.parent}")
    for row in rows:
        os.makedirs(c["out_path"] + row["syn_trgt"], exist_ok=True)
        try:
            shutil.copy(f"{c['gen_path']}/{row['syn_trgt']}/{row['syn_sample']}{c['pred_suf']}_"
                        f"{spkr2id[row['syn_trgt']]}_gen.wav",
                        f"{c['out_path']}/{row['syn_trgt']}/{row['syn_sample']}.wav")
        except FileNotFoundError:
            print(row["syn_sample"])


def main(argv=None):
    """Run every stage; returns the EER, or ``None`` without ECAPA weights."""
    args = build_parser().parse_args(argv)
    c = _init_params(args)
    device = resolve_device(args.device)  # refuse before touching a file
    dev = ["--device", str(device)]
    sample_csv = f"{c['data_path']}/speaker_verification.csv"
    rows = read_sv_pairs(sample_csv)

    infer_args = [
        "--input_path", f"{c['data_path']}/hubert100/{c['tf_name']}.txt",
        "--out_path", f"{c['data_path']}/pred_hubert_sv_{args.dissc_type}/",
        "--len_model", f"checkpoints/{args.data}/len/",
        "--f0_model", f"checkpoints/{args.data}/pitch/",
        "--f0_path", f"{c['data_path']}/hubert100/f0_stats.pkl",
        "--vc", "--sample_df", sample_csv, "-n", "100000",
        "--f0_model_type", "base" if args.data in ("vctk", "esd") else "new",
    ] + dev
    if args.dissc_type in ("dissc_l", "dissc_b"):
        infer_args.append("--pred_len")
    if args.dissc_type in ("dissc_p", "dissc_b"):
        infer_args.append("--pred_pitch")
    infer.main(infer_args)

    os.makedirs(c["gen_path"], exist_ok=True)
    for t_spk in c["spk"]:
        code_file = (f"{c['data_path']}/pred_hubert_sv_{args.dissc_type}/"
                     f"{t_spk}_{c['tf_name']}.txt")
        if not os.path.exists(code_file):
            continue
        sr_inference.main([
            "--input_code_file", code_file,
            "--data_path", f"{c['data_path']}/wav/{c['gt_pre']}",
            "--output_dir", f"{c['gen_path']}/{t_spk}",
            "--checkpoint_file", f"checkpoints/{args.data.split('_')[-1]}_vocoder",
            "--vc", "--target-speakers", t_spk,
            # only the CSV's (sample, target) pairs, not the whole split per speaker
            "--sample_df", sample_csv, "-n", "1000",
        ] + dev)

    restructure(c, rows)

    if not (args.embedder or args.speechbrain_ckpt):
        print("Conversions done. Pass --embedder/--speechbrain_ckpt to score EER "
              "(speechbrain ECAPA weights are not bundled with the port), or call "
              "dissc_tpu_torch.eval.sv.run_sv_eval with any injected score_fn.")
        return None
    sv_args = ["--base_path", f"results/{args.data}", "--method", args.dissc_type,
               "--gt_path", f"{c['data_path']}/wav/{c['gt_pre']}", "--file_suffix", c["gt_suf"]]
    if args.embedder:
        sv_args += ["--embedder", args.embedder]
    if args.speechbrain_ckpt:
        sv_args += ["--speechbrain_ckpt", args.speechbrain_ckpt]
    return eval_sv.main(sv_args + dev)


if __name__ == "__main__":
    main()
