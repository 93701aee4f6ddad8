"""The port stands alone: no JAX, no ``dissc_tpu``, and no silent CPU run."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dissc_tpu_torch
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package(tmp_path):
    modules = [m.name for m in pkgutil.walk_packages(dissc_tpu_torch.__path__,
                                                     "dissc_tpu_torch.")]
    assert "dissc_tpu_torch.kernels.mel_kernel" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r} + ['chip_smoke', 'chip_profile']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'dissc_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120,
                   env={"PYTHONPATH": str(REPO), "HOME": str(tmp_path)})


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from dissc_tpu_torch.infer.vocoder import VocoderEngine
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
