"""The port stands alone: no JAX, no ``dissc_tpu``, nothing beyond torch,
numpy and scipy (no ``transformers``, ``pandas``, ``safetensors``,
``tensorboardX`` or ``matplotlib``: the card's machine has none of them),
no silent CPU run, and no silent switch away from the native loaders."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dissc_tpu_torch
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package(tmp_path):
    modules = [m.name for m in pkgutil.walk_packages(dissc_tpu_torch.__path__,
                                                     "dissc_tpu_torch.")]
    for name in ("kernels.mel_kernel", "pipeline", "models.hubert", "models.prosody",
                 "audio.yaapt", "audio.resample", "infer.prosody", "data.jsonl", "data.stats",
                 "core.wav", "core.seed", "data.native_build", "data.native_loader",
                 "data.flac_native", "data.code_dataset", "data.datasets", "losses.len_loss",
                 "losses.pitch_loss", "train.logging", "train.prosody_trainer",
                 "train.vocoder_trainer", "compat.to_jax", "cli.sr_train", "cli.train_len",
                 "cli.train_f0", "cli.preprocess", "cli.encode", "cli.prep_dataset", "cli.infer",
                 "cli.sr_inference", "cli.eval", "cli.convert_eval", "eval.textgrid",
                 "eval.align", "eval.metrics", "eval.asr", "models.whisper",
                 "models.whisper_files", "models.ecapa", "models.jukebox", "models.vq",
                 "models.kmeans", "eval.sv", "cli.eval_sv", "cli.convert_eval_sv",
                 "train.quantizer_trainer", "compat.torch_import", "compat.from_jax",
                 "parallel.distributed", "parallel.collectives", "parallel.mesh",
                 "parallel.dryrun"):
        assert f"dissc_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r} + ['chip_smoke', 'chip_profile']:\n"
        "    importlib.import_module(name)\n"
        "from dissc_tpu_torch import ConversionPipeline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'dissc_tpu', 'transformers', 'pandas', "
        "'safetensors', 'tensorboardX', 'matplotlib'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120,
                   env={"PYTHONPATH": str(REPO), "HOME": str(tmp_path)})


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    import pickle

    from dissc_tpu_torch.audio.yaapt import yaapt_f0
    from dissc_tpu_torch.infer.prosody import ProsodyConverter
    from dissc_tpu_torch.infer.vocoder import VocoderEngine
    from dissc_tpu_torch.models.hubert import HubertConfig, SpeechUnitEncoder, init_state_dict
    from dissc_tpu_torch.pipeline import ConversionPipeline
    from dissc_tpu_torch.train.vocoder_trainer import GANTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = VocoderConfig(upsample_initial_channel=16, embedding_dim=8, model_in_dim=17)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        GANTrainer(h)
    with pytest.raises(RuntimeError, match="CUDA"):
        VocoderEngine(h, {})
    assert resolve_device("cpu").type == "cpu"

    with pytest.raises(RuntimeError, match="CUDA"):
        ProsodyConverter.load(n_speakers=3)
    assert ProsodyConverter.load(n_speakers=3, device="cpu").device.type == "cpu"
    cfg = HubertConfig(conv_dim=(8,), conv_kernel=(10,), conv_stride=(5,), hidden_size=8,
                       num_layers=1, num_heads=2, intermediate_size=8, conv_pos_kernel=4,
                       conv_pos_groups=2, output_layer=1)
    sd, codebook = init_state_dict(cfg, torch.Generator().manual_seed(0)), np.zeros((3, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeechUnitEncoder(sd, codebook, cfg)
    assert SpeechUnitEncoder(sd, codebook, cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        yaapt_f0(np.zeros(1600, np.float32))
    # the pipeline refuses before it opens a file
    with open(tmp_path / "id_to_spkr.pkl", "wb") as f:
        pickle.dump(["a"], f)
    with pytest.raises(RuntimeError, match="CUDA"):
        ConversionPipeline.load(str(tmp_path / "vocoder"), str(tmp_path / "id_to_spkr.pkl"))
    with pytest.raises(FileNotFoundError):  # with the CPU asked for, it goes on to read
        ConversionPipeline.load(str(tmp_path / "vocoder"), str(tmp_path / "id_to_spkr.pkl"),
                                device="cpu")


def test_training_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from dissc_tpu_torch.cli import sr_train, train_f0, train_len
    from dissc_tpu_torch.core.config import ProsodyConfig
    from dissc_tpu_torch.train.prosody_trainer import train_f0_predictor, train_len_predictor
    from dissc_tpu_torch.train.vocoder_trainer import train_vocoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    h = VocoderConfig(input_training_file=missing, input_validation_file=missing)
    calls = [lambda **kw: train_vocoder(h, str(tmp_path / "ckpt"), **kw),
             lambda **kw: train_len_predictor(missing, str(tmp_path / "out"), ProsodyConfig(),
                                              **kw),
             lambda **kw: train_f0_predictor(missing, missing, str(tmp_path / "out"), **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        with pytest.raises(FileNotFoundError):  # with the CPU asked for, it goes on to read
            call(device="cpu")
    argv = {sr_train: ["--config", missing, "--checkpoint_path", str(tmp_path / "c")],
            train_len: ["--data_path", missing, "--out_path", str(tmp_path / "l")],
            train_f0: ["--data_path", missing, "--f0_path", missing,
                       "--out_path", str(tmp_path / "f")]}
    for cli, args in argv.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)
        with pytest.raises(FileNotFoundError):
            cli.main(args + ["--device", "cpu"])
    assert not (tmp_path / "c").exists()  # refused before it wrote anything


@pytest.mark.parametrize("name", ["preprocess", "prep_dataset", "encode", "infer",
                                  "sr_inference", "eval", "convert_eval", "eval_sv",
                                  "convert_eval_sv"])
def test_conversion_and_eval_clis_raise_without_cuda_unless_cpu_is_asked(name, monkeypatch,
                                                                          tmp_path):
    import importlib

    cli = importlib.import_module(f"dissc_tpu_torch.cli.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)  # convert_eval reads and writes relative paths
    missing, out = str(tmp_path / "missing"), str(tmp_path / "out")
    argv = {"preprocess": ["--srcdir", missing, "--outdir", out],
            "prep_dataset": ["--encoded_path", missing, "--stats_path", out],
            "encode": ["--base_dir", missing, "--out_file", out, "--hubert_weights", missing,
                       "--kmeans_codebook", missing],
            "infer": ["--input_path", missing, "--out_path", out, "--pred_len"],
            "sr_inference": ["--checkpoint_file", missing, "--output_dir", out],
            "eval": ["--base_path", missing, "--method", "m"],
            "convert_eval": [],
            "eval_sv": ["--base_path", missing, "--speechbrain_ckpt", missing],
            "convert_eval_sv": []}[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    assert not os.path.exists(out)  # refused before it wrote anything
    if name == "preprocess":  # no input files: nothing to do, on the host
        assert cli.main(argv + ["--device", "cpu"]) == 0
    else:  # with the CPU asked for, it goes on to read
        with pytest.raises(FileNotFoundError):
            cli.main(argv + ["--device", "cpu"])
    if name in ("infer", "sr_inference"):  # no silent CPU run of a split over cards
        with pytest.raises(SystemExit) as exit_info:
            cli.main(argv + ["--data_devices", "2", "--device", "cpu"])
        assert exit_info.value.code == 2


@pytest.mark.parametrize("name", ["infer", "sr_inference"])
def test_a_negative_data_devices_is_a_usage_error(name, capsys):
    import importlib

    cli = importlib.import_module(f"dissc_tpu_torch.cli.{name}")
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--pred_len", "--data_devices", "-1", "--device", "cpu"] if name == "infer"
                 else ["--data_devices", "-1", "--device", "cpu"])
    assert exit_info.value.code == 2
    assert "--data_devices must be 0 or more, got -1" in capsys.readouterr().err


@pytest.mark.parametrize("binding", ["native_loader", "flac_native"])
def test_native_binding_raises_when_its_build_fails(binding, monkeypatch, tmp_path):
    """No silent switch to a numpy path: a missing compiler is an error."""
    import importlib

    from dissc_tpu_torch.data import native_build

    module = importlib.import_module(f"dissc_tpu_torch.data.{binding}")
    monkeypatch.setattr(native_build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "_loaded", {})
    path = str(tmp_path / "x.wav")
    with pytest.raises(RuntimeError, match="no-such-g"):
        if binding == "native_loader":
            module.load_crops([path], [0], 16)
        else:
            module.read_flac(path)
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").iterdir())


@pytest.mark.parametrize("knob", [dict(compute_dtype="bfloat16"),
                                  dict(disc_compute_dtype="bfloat16"),
                                  dict(param_dtype="bfloat16"),
                                  dict(lambda_commit_code=0.02)])
def test_config_refuses_knobs_that_change_the_numbers(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VocoderConfig(**knob)


def test_config_accepts_tpu_lowering_knobs_and_reads_reference_json(tmp_path):
    from dissc_tpu_torch.core.config import load_config

    h = VocoderConfig(mrf_pack_max_ch=0, disc_s2d=True, msd_fused_gstep=True, dp_axis="x")
    assert h.disc_s2d and h.mrf_pack_max_ch == 0
    path = tmp_path / "config.json"
    path.write_text('{"upsample_initial_channel": 256, "f0_feats": true, "unknown": 1}')
    assert load_config(str(path)).upsample_initial_channel == 256
    assert VocoderConfig.from_json(str(path)).upsample_initial_channel == 256
