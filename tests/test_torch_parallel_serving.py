"""The serving split over devices (``devices=``, ``--data_devices``) vs one
device and vs the JAX package's mesh engines.

``VocoderEngine`` and ``ProsodyConverter`` split each batch over
``["cpu", "cpu", "cpu"]``: 8 items of one bucket, so the batch is padded by
one repeated row, and two utterances past the last bucket, dealt to two
devices and streamed there.  Waveforms equal the one-device engine's within
2e-5 and come back in input order; units and durations exactly, f0 within
2e-5.  Against the JAX engines on a ``create_mesh(n_data=3)`` of the
virtual CPU devices: waveforms and f0 within 1e-4, units exactly (f32 convs
in another order).  ``ConversionPipeline`` with split engines converts as
with one device.  ``--data_devices`` above the cards present, or with
``--device cpu``, is a usage error (exit 2).
"""
import jax
import numpy as np
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.infer.prosody import ProsodyConverter as JaxConverter
from dissc_tpu.infer.vocoder import VocoderEngine as JaxEngine
from dissc_tpu.models.prosody import LenPredictor as JaxLen
from dissc_tpu.parallel.mesh import create_mesh
from dissc_tpu.train.prosody_trainer import build_pitch_model as jax_build_pitch
from dissc_tpu_torch.cli import infer, sr_inference
from dissc_tpu_torch.compat import to_jax
from dissc_tpu_torch.compat.from_jax import generator_state_dict
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.infer.prosody import ProsodyConverter
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.models.prosody import LenPredictor
from dissc_tpu_torch.pipeline import ConversionPipeline
from dissc_tpu_torch.train.prosody_trainer import build_pitch_model
from test_torch_hifigan import SMALL, random_generator_params

torch.set_num_threads(2)
SPLIT = ["cpu", "cpu", "cpu"]
N_SPK = 4


def _items(seed=0):
    """8 items in the 16-frame bucket, then two that stream (past 16)."""
    rng = np.random.default_rng(seed)
    items = []
    for i, T in enumerate([9, 16, 12, 10, 15, 11, 13, 14, 80, 60]):
        items.append({"code": rng.integers(0, 100, T).astype(np.int32),
                      "f0": rng.normal(0, 1, (T, 1)).astype(np.float32),
                      "spkr": np.array([i % N_SPK], np.int32)})
    return items


@pytest.fixture(scope="module")
def vocoders():
    jh, th = JaxConfig(**SMALL), VocoderConfig(**SMALL)
    params = random_generator_params(jh, seed=2)
    kw = dict(frame_buckets=(8, 16), stream_chunk=24)
    state = generator_state_dict(params, th)
    return (VocoderEngine(th, state, device="cpu", **kw),
            VocoderEngine(th, state, devices=SPLIT, **kw),
            JaxEngine(jh, params, mesh=create_mesh(n_data=3, devices=jax.devices()[:3]), **kw))


def test_vocoder_split_equals_one_device_and_the_jax_mesh_engine(vocoders, monkeypatch):
    one, split, jax_engine = vocoders
    assert [str(d) for d in split.devices] == SPLIT and len(set(map(id, split.replicas))) == 1
    parts = []
    launch = VocoderEngine._launch
    monkeypatch.setattr(VocoderEngine, "_launch", lambda self, part, code, f0, spkr: (
        parts.append((part, code.shape[0])), launch(self, part, code, f0, spkr))[1])
    items = _items()
    w_one, _ = one.synthesize_utterances(items, batch_size=8)
    parts.clear()
    w_split, _ = split.synthesize_utterances(items, batch_size=8)
    assert parts == [(0, 3), (1, 3), (2, 3)]  # 8 rows padded to 9, one block a device
    w_jax, _ = jax_engine.synthesize_utterances(items, batch_size=8)
    assert [len(w) for w in w_split] == [len(it["code"]) * 320 for it in items]
    for i, (a, b, c) in enumerate(zip(w_one, w_split, w_jax)):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-5, err_msg=f"item {i}")
        np.testing.assert_allclose(b, c, rtol=0, atol=1e-4, err_msg=f"item {i}")


def test_long_utterances_stream_on_different_devices(vocoders):
    _, split, _ = vocoders
    split.synthesize_utterances(_items()[-2:], batch_size=8)
    assert sorted(split._streamers) == [0, 1]  # one streamed on each of two devices


def _prosody_models(seed=5):
    g = torch.Generator().manual_seed(seed)
    return (LenPredictor(100, N_SPK, generator=g), build_pitch_model("new", 100, N_SPK,
                                                                     generator=g))


def _records(seed=6):
    rng = np.random.default_rng(seed)
    return [{"units": [int(u) for u in np.repeat(rng.integers(0, 100, n), 2)[:n]],
             "f0": [0.0] * n, "audio": f"s{i % N_SPK}_{i}.wav"}
            for i, n in enumerate([30, 60, 45, 100, 20, 75, 90, 55])]


STATS = (np.linspace(100, 200, N_SPK).astype(np.float32),
         np.linspace(10, 30, N_SPK).astype(np.float32))
SPK = {f"s{i}": i for i in range(N_SPK)}


def _port_converter(devices):
    len_model, pitch_model = _prosody_models()
    conv = ProsodyConverter(devices=devices)
    conv.set_models(len_model=len_model, len_norm_stats=(4.0, 2.0), pitch_model=pitch_model)
    conv.id2pitch_mean, conv.id2pitch_std = STATS
    return conv


def test_prosody_split_equals_one_device_and_the_jax_mesh_converter():
    records = _records()
    one = _port_converter(["cpu"]).convert_records(records, SPK, batch_size=8)
    split = _port_converter(SPLIT).convert_records(records, SPK, batch_size=8)
    len_model, pitch_model = _prosody_models()
    jconv = JaxConverter(mesh=create_mesh(n_data=3, devices=jax.devices()[:3]))
    jconv.len_model = JaxLen(n_tokens=100, n_speakers=N_SPK)
    jconv.len_variables = to_jax.len_predictor_variables(len_model.state_dict())
    jconv.len_norm_stats = (np.float32(4.0), np.float32(2.0))
    jconv.pitch_model = jax_build_pitch("new", 100, N_SPK)
    jconv.pitch_variables = to_jax.pitch_predictor_variables(pitch_model.state_dict())
    jconv.id2pitch_mean, jconv.id2pitch_std = STATS
    ref = jconv.convert_records(records, SPK, batch_size=8)
    for i, (a, b, c) in enumerate(zip(one, split, ref)):
        assert b["audio"] == a["audio"] == records[i]["audio"]
        assert b["units"] == a["units"] == c["units"], i
        np.testing.assert_allclose(b["f0"], a["f0"], rtol=0, atol=2e-5, err_msg=f"record {i}")
        np.testing.assert_allclose(b["f0"], c["f0"], rtol=0, atol=1e-4, err_msg=f"record {i}")


def test_pipeline_with_split_engines_converts_as_with_one_device(vocoders):
    one, split, _ = vocoders
    records = _records()[:5]
    out = []
    for engine, devices in ((one, ["cpu"]), (split, SPLIT)):
        pipe = ConversionPipeline(engine, _port_converter(devices), SPK)
        out.append(pipe.convert_batch(records, "s2", batch_size=8)[0])
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)


def test_pipeline_load_passes_the_devices_to_both_engines(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(ProsodyConverter, "load", classmethod(
        lambda cls, **kw: seen.setdefault("prosody", kw["devices"])))
    monkeypatch.setattr(VocoderEngine, "from_checkpoint", classmethod(
        lambda cls, path, **kw: seen.setdefault("vocoder", kw["devices"])))
    ids = tmp_path / "id_to_spkr.pkl"
    ids.write_bytes(__import__("pickle").dumps(["s0", "s1"]))
    ConversionPipeline.load(str(tmp_path), str(ids), devices=SPLIT)
    assert seen == {"prosody": SPLIT, "vocoder": SPLIT}


@pytest.mark.parametrize("cli", [infer, sr_inference])
def test_data_devices_names_cards_or_is_a_usage_error(cli, monkeypatch, capsys):
    argv = ["--pred_len"] if cli is infer else []
    with pytest.raises(SystemExit) as exit_info:  # a split of a CPU run
        cli.main(argv + ["--data_devices", "2", "--device", "cpu"])
    assert exit_info.value.code == 2
    assert "--data_devices 2 splits batches over CUDA cards" in capsys.readouterr().err
    parser, card = cli.build_parser(), torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert infer.split_devices(parser, 2, card) == ["cuda:0", "cuda:1"]
    assert infer.split_devices(parser, 1, card) is None
    assert infer.split_devices(parser, 0, card) is None
    with pytest.raises(SystemExit) as exit_info:  # more cards than are present
        infer.split_devices(parser, 3, card)
    assert exit_info.value.code == 2
    assert "--data_devices 3 but 2 CUDA card(s) present" in capsys.readouterr().err
