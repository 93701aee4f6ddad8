"""``cli.convert_eval`` end to end on the CPU, through the port alone.

The run of ``chip_smoke.py``'s phase 7 at tiny widths, with ``--device
cpu``: a VCTK-shaped corpus (48 and 22.05 kHz recordings, transcripts, FLAC
ground truth) goes through ``cli.preprocess --trim --pad``, ``cli.encode``
and ``cli.prep_dataset``; the port writes every checkpoint (HuBERT in the
JAX layout, the rhythm and pitch models, the generator, a Whisper
directory with its tokenizer files); then ``cli.convert_eval --data vctk
--dissc_type dissc_b --sort_gt --dtw_align --whisper_model`` converts,
vocodes, restructures, aligns and scores.  No JAX runs here: each module
is held against the JAX package in its own file.
"""
import functools
import os

import numpy as np
import torch

import chip_smoke
from dissc_tpu_torch.cli import encode
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.models.hubert import HubertConfig, load_encoder
from dissc_tpu_torch.models.whisper import WhisperConfig
from test_torch_hifigan import SMALL
from test_torch_pipeline import HUBERT_320X

torch.set_num_threads(2)


def test_convert_eval_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    hub_cfg = HubertConfig(**HUBERT_320X)
    monkeypatch.setattr(encode, "load_encoder", functools.partial(load_encoder, cfg=hub_cfg))
    wcfg = WhisperConfig(vocab_size=2000, d_model=16, encoder_layers=1, decoder_layers=1,
                         num_heads=2, ffn_dim=32, max_target_positions=240)
    run = chip_smoke.convert_eval_run(str(tmp_path), VocoderConfig(**SMALL), hub_cfg, wcfg,
                                      torch.device("cpu"), seconds=(0.4, 0.7), workers=1)
    errs, log = run["errs"], run["log"]
    assert run["pairs"] == 12  # 4 targets x 3 other speakers x one val utterance
    assert len(errs["len"]) == len(errs["p_ffe"]) == len(errs["w_ffe"]) == 12
    assert all(np.isfinite(v) for k in ("emd", "w_len", "p_len") for v in errs[k])
    assert len(log["yaapt_per_file"]) == 24 and len(log["dtw_per_file"]) == 12
    orig = sorted(os.listdir(tmp_path / "results" / "vctk" / "orig"))
    assert orig == sorted(["txtgrid"] + [f"{s}_001.{e}" for s in chip_smoke.CE_SPEAKERS
                                         for e in ("txt", "wav")])
