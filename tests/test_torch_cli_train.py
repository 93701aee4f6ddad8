"""The port's training CLIs (``dissc_tpu_torch.cli.{sr_train,train_len,train_f0}``).

Every option string of the JAX package's parsers is accepted, found by a
source scan on both sides as ``tests/test_cli_flag_parity.py`` scans the
reference.  Each ``main(argv)`` runs end to end with ``--device cpu`` on a
toy corpus and writes the artifacts its JAX counterpart writes.
"""
import os
import re
from pathlib import Path

import pytest
import torch

from dissc_tpu_torch.cli import sr_train, train_f0, train_len
from test_torch_data import write_code_corpus
from test_torch_prosody_train import write_unit_corpus
from test_torch_vocoder_train import write_config

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
_FLAG_RE = re.compile(r"add_argument\(\s*[\"']([^\"']+)[\"']")


def _flags(path: Path) -> set:
    return set(_FLAG_RE.findall(path.read_text()))


@pytest.mark.parametrize("name", ["sr_train", "train_len", "train_f0"])
def test_port_parsers_accept_every_jax_flag(name):
    jax_flags = _flags(REPO / "dissc_tpu" / "cli" / f"{name}.py")
    port_flags = _flags(REPO / "dissc_tpu_torch" / "cli" / f"{name}.py")
    assert len(jax_flags) >= 8
    assert jax_flags <= port_flags, sorted(jax_flags - port_flags)
    assert "--device" in port_flags


def test_sr_train_reference_launch_line_parses():
    args = sr_train.build_parser().parse_args([
        "--checkpoint_path", "/tmp/ckpt", "--config", "cfg.json", "--group_name", "g",
        "--fine_tuning", "True", "--local_rank", "1", "--distributed-world-size", "2",
        "--distributed-port", "54321"])
    assert (args.local_rank, args.distributed_world_size, args.distributed_port) == (1, 2, 54321)
    assert args.device is None  # the card
    assert train_len.build_parser().parse_args([]).device is None
    assert train_f0.build_parser().parse_args([]).device is None


def test_prosody_clis_train_on_the_cpu(tmp_path):
    data = tmp_path / "data"
    os.makedirs(data)
    write_unit_corpus(data, n_train=8, n_val=4)
    common = ["--data_path", str(data), "--out_path", str(tmp_path / "out"), "--device", "cpu",
              "--n_epochs", "1", "--batch_size", "4", "--seed", "3"]
    len_dir = train_len.main(common)
    assert sorted(os.listdir(len_dir)) == ["best_model.pth", "len_norm_stats.pth", "train", "val"]
    for model_type in ("base", "new"):
        f0_dir = train_f0.main(common + ["--f0_path", str(data / "f0_stats.pkl"),
                                         "--model_type", model_type])
        assert os.path.exists(os.path.join(f0_dir, "best_model.pth"))


def test_sr_train_cli_trains_on_the_cpu(tmp_path):
    root = tmp_path / "corpus"
    os.makedirs(root)
    config = write_config(root, write_code_corpus(root, n_files=2, seconds=(0.05, 0.1), n_val=1))
    trainer, _ = sr_train.main(["--config", config, "--checkpoint_path",
                                str(tmp_path / "ckpt"), "--training_steps", "1",
                                "--device", "cpu"])
    assert trainer.step == 1 and trainer.device.type == "cpu"
    assert {"config.json", "g_00000001", "do_00000001", "id_to_spkr.pkl"} <= set(
        os.listdir(tmp_path / "ckpt"))
