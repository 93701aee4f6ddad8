"""A run with its timed path broken underneath comes out not correct: a
step that leaves the state unchanged, half of a batch left out (the mean
taken over the rest), and an answer altered where it is produced."""
import numpy as np
import pytest
import torch

from portbench.tests.small import small_run


def test_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    out = small_run("f32_train")
    assert out["correct"] is False
    assert out["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_half_batch(monkeypatch):
    from dissc_tpu_torch.train.vocoder_trainer import GANTrainer

    inputs = GANTrainer._inputs

    def half(self, batch):
        return tuple(None if x is None else x[: len(x) // 2] for x in inputs(self, batch))

    monkeypatch.setattr(GANTrainer, "_inputs", half)
    out = small_run("f32_train")
    assert out["correct"] is False


@pytest.mark.parametrize("cell", ["f32_convert_batch", "bf16_convert_batch", "f32_convert_call"])
def test_unit_altered_in_the_rhythm(monkeypatch, cell):
    from dissc_tpu_torch.infer.prosody import ProsodyConverter

    convert = ProsodyConverter.convert_records

    def altered(self, *a, **kw):
        out = convert(self, *a, **kw)
        for rec in out:
            rec["units"][len(rec["units"]) // 2] = (rec["units"][len(rec["units"]) // 2] + 1) % 100
        return out

    monkeypatch.setattr(ProsodyConverter, "convert_records", altered)
    out = small_run(cell)
    assert out["correct"] is False
    assert out["checks"]["rhythm_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", ["f32_convert_batch", "bf16_convert_batch", "f32_convert_call"])
def test_waveform_altered(monkeypatch, cell):
    from dissc_tpu_torch.infer.vocoder import VocoderEngine

    synth = VocoderEngine.synthesize_utterances

    def altered(self, *a, **kw):
        wavs, rtf = synth(self, *a, **kw)
        return [w * np.float32(1.2) for w in wavs], rtf

    monkeypatch.setattr(VocoderEngine, "synthesize_utterances", altered)
    out = small_run(cell)
    assert out["correct"] is False
    assert out["checks"]["wave_gap"]["value"] > out["checks"]["wave_gap"]["limit"]


def test_unit_altered_in_the_encoder(monkeypatch):
    from dissc_tpu_torch.models.hubert import SpeechUnitEncoder

    encode = SpeechUnitEncoder.encode_units

    def altered(self, wav):
        units = encode(self, wav).copy()
        units[len(units) // 2] = (units[len(units) // 2] + 1) % 100
        return units

    monkeypatch.setattr(SpeechUnitEncoder, "encode_units", altered)
    out = small_run("f32_convert_call")
    assert out["correct"] is False
    assert out["checks"]["unit_gap"]["value"] > out["checks"]["unit_gap"]["limit"]


def test_f0_altered_in_the_encoder(monkeypatch):
    from dissc_tpu_torch.models.hubert import SpeechUnitEncoder

    call = SpeechUnitEncoder.__call__

    def altered(self, wav, sr=16000):
        rec = call(self, wav, sr)
        rec["f0"] = [f * 1.01 for f in rec["f0"]]
        return rec

    monkeypatch.setattr(SpeechUnitEncoder, "__call__", altered)
    out = small_run("f32_convert_call")
    assert out["correct"] is False
    assert out["checks"]["f0_mismatch"]["value"] > 0
