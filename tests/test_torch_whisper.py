"""Port's Whisper (``dissc_tpu_torch.models.whisper``) vs the JAX package's,
and the port's reader of a Hugging Face checkpoint directory.

Tiny configs (2 + 2 layers, d 16).  Weights: seeded numpy draws in the
JAX parameter tree, carried by ``compat.from_jax.whisper_state_dict``.
Tolerances: log-mel, encoder states and teacher-forced logits within 1e-4
(float32 in another summation order); greedy tokens identical.  The file
reader is held against transformers: a tiny ``WhisperForConditionalGeneration``
and a tiny byte-level tokenizer saved with ``save_pretrained`` must
transcribe a WAV to the same string through the port's ``load_whisper``
(no transformers) as through the JAX ``load_whisper_native`` (which reads
them with transformers).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.models import whisper as jw
from dissc_tpu_torch.compat.from_jax import whisper_state_dict
from dissc_tpu_torch.core.wav import read_wav, write_wav
from dissc_tpu_torch.eval.asr import load_whisper
from dissc_tpu_torch.models import whisper as tw
from dissc_tpu_torch.models import whisper_files

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

TINY = dict(vocab_size=50, num_mel_bins=8, d_model=16, encoder_layers=2, decoder_layers=2,
            num_heads=4, ffn_dim=32, max_source_positions=32, max_target_positions=16)


def random_params(cfg, seed=0):
    """Seeded draws into the JAX tree: kernels N(0, 9/in), embeddings N(0, 1),
    position tables N(0, 4), biases N(0, 0.1), norms 1 + N(0, 0.1).  Wide
    enough that greedy decoding varies its tokens (at N(0, 1/in) and
    N(0, 0.25) it repeats one)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "scale":
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if name == "bias":
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if name in ("embed", "pos"):
            return (rng.standard_normal(a.shape) * (1.0 if name == "embed" else 2.0)
                    ).astype(np.float32)
        return (rng.standard_normal(a.shape) * 3.0 / np.sqrt(a.shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jw.init_params(cfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jw.WhisperConfig(**TINY), tw.WhisperConfig(**TINY)
    params = random_params(jcfg)
    model = tw.build(whisper_state_dict(params, tcfg), tcfg, torch.device("cpu"))
    mel = np.random.default_rng(1).standard_normal((2, 64, 8)).astype(np.float32)
    return jcfg, params, model, mel


def test_log_mel_matches_jax():
    rng = np.random.default_rng(2)
    wavs = np.stack([tw.pad_or_trim((rng.standard_normal(n) * 0.1).astype(np.float32))
                     for n in (24000, 480000 + 37)])
    ref = np.asarray(jax.jit(jw.log_mel_spectrogram)(jnp.asarray(wavs)))
    out = tw.log_mel_spectrogram(torch.from_numpy(wavs)).numpy()
    assert out.shape == ref.shape == (2, 3000, 80)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_encoder_states_and_teacher_forced_logits_match_jax(tiny):
    jcfg, params, model, mel = tiny
    enc_ref = jax.jit(jw.encode, static_argnums=1)(params, jcfg, jnp.asarray(mel))
    toks = np.random.default_rng(3).integers(0, 50, (2, 7)).astype(np.int32)
    logits_ref = jax.jit(jw.decode_full, static_argnums=1)(params, jcfg, jnp.asarray(toks),
                                                            enc_ref)
    with torch.no_grad():
        enc = tw.encode(model, torch.from_numpy(mel))
        logits = tw.decode_full(model, torch.from_numpy(toks).long(), enc)
    assert enc.shape == (2, 32, 16) and logits.shape == (2, 7, 50)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("suppress", [None, (5, 11)])
def test_greedy_tokens_equal_jax_and_the_cache_equals_teacher_forcing(tiny, suppress):
    jcfg, params, model, mel = tiny
    init, eos, max_len = [3, 7], 32, 12  # 32 comes up in both rows
    ref = np.asarray(jw.greedy_decode(
        params, jcfg, jnp.asarray(mel), jnp.asarray(init, jnp.int32), eos, max_len,
        None if suppress is None else jnp.asarray(suppress)))
    out = tw.greedy_decode(model, torch.from_numpy(mel), init, eos, max_len, suppress).numpy()
    np.testing.assert_array_equal(out, ref)
    with torch.no_grad():
        enc = tw.encode(model, torch.from_numpy(mel))
        for b in range(2):
            seq = list(init)
            for i in range(max_len):
                logits = tw.decode_full(model, torch.tensor([seq]), enc[b:b + 1])[0, -1]
                if suppress is not None:
                    logits[list(suppress)] = -np.inf
                assert int(torch.argmax(logits)) == out[b, i], (b, i)
                if out[b, i] == eos:
                    assert (out[b, i:] == eos).all()
                    break
                seq.append(int(out[b, i]))
    assert len(set(out.ravel().tolist())) > 3  # the draw decodes more than a constant
    assert (out == eos).any(axis=1).all()  # and each row reaches EOS


# ---- the checkpoint directory: config, weights, tokenizer ------------------


def _tokenizer_files(path):
    """A byte-level tokenizer: the 256 byte symbols, one merge (" h"),
    ``<|endoftext|>``, the prompt and task specials and two timestamps."""
    from transformers.models.whisper.tokenization_whisper import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    vocab[b2u[ord(" ")] + "h"] = 256
    vocab["<|endoftext|>"] = 257
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + b2u[ord(" ")] + " h\n")
    tok = transformers.WhisperTokenizer(
        os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"),
        unk_token="<|endoftext|>", bos_token="<|endoftext|>", eos_token="<|endoftext|>",
        additional_special_tokens=["<|startoftranscript|>", "<|en|>", "<|transcribe|>",
                                   "<|startofprev|>", "<|notimestamps|>"])
    tok.add_tokens(["<|0.00|>", "<|0.02|>"])
    tok.save_pretrained(path)
    return tok


def _tiny_hf(vocab_size, seed=4):
    cfg = transformers.WhisperConfig(
        vocab_size=vocab_size, num_mel_bins=80, d_model=16, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=32,
        decoder_ffn_dim=32, max_source_positions=1500, max_target_positions=240,
        pad_token_id=257, bos_token_id=257, eos_token_id=257, decoder_start_token_id=258)
    model = transformers.WhisperForConditionalGeneration(cfg).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():  # wider than HF's init, so the greedy path has clear winners
        for name, p in model.named_parameters():
            scale = 1.0 if "embed_tokens" in name else 0.3 if p.ndim > 1 else 0.1
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * scale))
    return model


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("whisper")
    tok = _tokenizer_files(str(root / "st"))
    model = _tiny_hf(len(tok) + 5)  # 5 ids the tokenizer does not know
    model.save_pretrained(str(root / "st"), safe_serialization=True)
    _tokenizer_files(str(root / "bin"))
    model.save_pretrained(str(root / "bin"), safe_serialization=False)
    rng = np.random.default_rng(5)
    wav = str(root / "x.wav")
    write_wav(wav, (rng.standard_normal(12000) * 0.2).astype(np.float32), 16000)
    return root, tok, model, wav


@pytest.mark.parametrize("fmt", ["st", "bin"])
def test_port_reader_transcribes_as_the_jax_loader(hf_dir, fmt):
    from dissc_tpu.eval.asr import load_whisper_native as jax_load

    root, _, model, wav = hf_dir
    files = os.listdir(root / fmt)
    assert ("model.safetensors" in files) == (fmt == "st")
    assert ("pytorch_model.bin" in files) == (fmt == "bin")
    transcribe = load_whisper(str(root / fmt), device="cpu")
    sd = whisper_files.load_state_dict(str(root / fmt))
    for k, v in model.state_dict().items():
        assert k not in sd or torch.equal(sd[k], v), k
    text = transcribe(wav)
    assert text == jax_load(str(root / fmt))(wav)
    assert len(text) > 0
    batch = transcribe.transcribe_batch([np.zeros(3000, np.float32),
                                         read_wav(wav, dtype="float32")[0]])
    assert batch[1] == text


def test_detokenizer_matches_the_slow_tokenizer(hf_dir, tmp_path):
    root, tok, _, _ = hf_dir
    ours = whisper_files.WhisperDetokenizer.from_dir(str(root / "st"))
    # the same table from a fast tokenizer's tokenizer.json alone
    transformers.WhisperTokenizerFast.from_pretrained(str(root / "st")).save_pretrained(
        str(tmp_path))
    for name in ("vocab.json", "added_tokens.json", "special_tokens_map.json",
                 "tokenizer_config.json", "merges.txt"):
        if os.path.exists(tmp_path / name):
            os.remove(tmp_path / name)
    fast_only = whisper_files.WhisperDetokenizer.from_dir(str(tmp_path))
    for t in ("<|startoftranscript|>", "<|notimestamps|>"):
        assert ours.convert_tokens_to_ids(t) == fast_only.convert_tokens_to_ids(t) \
            == tok.convert_tokens_to_ids(t)
    assert ours.eos_token_id == fast_only.eos_token_id == tok.eos_token_id == 257
    rng = np.random.default_rng(6)
    prompt, sot = tok.convert_tokens_to_ids("<|startofprev|>"), 258
    cases = [rng.integers(0, len(tok) + 5, n).tolist() for n in (0, 1, 5, 40, 40, 40)]
    cases += [[prompt, 72, 105, sot, 72, 105], [prompt, 72, 105], [72, 0xC3, 0xA9, 263, 256]]
    for ids in cases:
        want = tok.decode(ids, skip_special_tokens=True)
        assert ours.decode(ids) == fast_only.decode(ids) == want, ids


def test_safetensors_reader_reads_every_dtype_and_refuses_a_bad_header(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 4, generator=g), "f16": torch.randn(5, generator=g).half(),
               "bf16": torch.randn(2, 3, generator=g).bfloat16(),
               "i64": torch.arange(6).reshape(2, 3), "b": torch.tensor([True, False]),
               "scalar": torch.tensor(2.5)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    back = whisper_files.read_safetensors(path)
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[:8] = (len(raw) * 2).to_bytes(8, "little")
    bad = str(tmp_path / "bad.safetensors")
    with open(bad, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="header length"):
        whisper_files.read_safetensors(bad)


def test_load_whisper_errors(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="Whisper weights not found"):
        load_whisper(str(tmp_path / "missing"), device="cpu")
    with pytest.raises(NotImplementedError, match="transformers"):
        load_whisper(str(tmp_path), device="cpu", native=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_whisper(str(tmp_path / "missing"))
