"""The port stands alone: no JAX, no ``dissc_tpu``, nothing the card's
machine lacks (``transformers``, ``pandas``), and no silent CPU run."""
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
                 "audio.yaapt", "audio.resample", "infer.prosody", "data.jsonl", "data.stats"):
        assert f"dissc_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r} + ['chip_smoke', 'chip_profile']:\n"
        "    importlib.import_module(name)\n"
        "from dissc_tpu_torch import ConversionPipeline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'dissc_tpu', 'transformers', 'pandas'))\n"
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


@pytest.mark.parametrize("knob", [dict(compute_dtype="bfloat16"),
                                  dict(disc_compute_dtype="bfloat16"),
                                  dict(param_dtype="bfloat16"),
                                  dict(lambda_commit=0.02),
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
