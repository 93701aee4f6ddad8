"""Port's data path vs the JAX package's on the same temp-dir files.

``core/wav.py``, ``core/seed.py``, the native WAV/crop and FLAC bindings
(built with the host's ``g++`` into ``build/native/``),
``CodeDataset`` on its native and its Python path, ``data/stats.py`` and the
prosody datasets.  Arrays must be equal, not close: crops, codes, speaker
ids and manifest f0 (whitened, median-filled) bit for bit.  Where a crop has
no manifest pitch both packages compute it with their YAAPT, which agree on
voicing exactly and on f0 to float32 rounding (``test_torch_yaapt.py``), so
that f0 is held to rtol 1e-4 after the port pools it to the code rate.
"""
import json
import os
import random
import wave

import numpy as np
import pytest
import torch

from dissc_tpu.core import wav as jwav
from dissc_tpu.data import code_dataset as jcd
from dissc_tpu.data import datasets as jdatasets
from dissc_tpu.data import flac_native as jflac
from dissc_tpu.data import native_loader as jnative
from dissc_tpu.data import stats as jstats
from dissc_tpu_torch.audio.yaapt import f0_per_unit
from dissc_tpu_torch.core import wav as twav
from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.data import code_dataset as tcd
from dissc_tpu_torch.data import datasets as tdatasets
from dissc_tpu_torch.data import flac_native as tflac
from dissc_tpu_torch.data import native_loader as tnative
from dissc_tpu_torch.data import stats as tstats
from flac_ref_encoder import encode_flac

torch.set_num_threads(2)
SR = 16000


def write_pcm16(path, data, sr=SR, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(data, np.int16).tobytes())


def write_code_corpus(root, n_files=10, seconds=(0.1, 0.5), n_spk=3, f0="train", n_val=4,
                      seed=0, sr=SR):
    """Seeded 16-bit wavs ``pNNN_xxxx.wav`` of ``seconds`` (some shorter
    than a segment, so they tile), a JSONL train manifest with ``units`` and
    per-frame ``f0`` when ``f0`` is ``"train"`` or ``"both"``, and a val
    manifest of ``n_val`` of them (``f0`` when ``"both"``).  Returns the
    manifest paths."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_files):
        n = int(rng.uniform(*seconds) * sr)
        t = np.arange(n) / sr
        voice = np.sin(2 * np.pi * rng.uniform(100, 220) * t) * (rng.random() * 0.5 + 0.3)
        data = (voice + 0.05 * rng.standard_normal(n)) * 12000
        name = f"p{225 + i % n_spk}_{i:04d}.wav"
        write_pcm16(root / name, data)
        frames = n // 320 + int(rng.integers(-1, 3))  # codes a frame short or long
        rec = {"audio": f"wavs/{name}", "units": rng.integers(0, 100, frames).tolist()}
        f0s = np.where(rng.random(frames) < 0.3, 0.0, rng.uniform(90, 250, frames))
        lines.append((rec, f0s.round(2).tolist()))

    def manifest(path, items, with_f0):
        with open(path, "w") as f:
            for rec, f0s in items:
                f.write(json.dumps(dict(rec, **({"f0": f0s} if with_f0 else {}))) + "\n")
        return str(path)

    return (manifest(root / "train.jsonl", lines, f0 in ("train", "both")),
            manifest(root / "val.jsonl", lines[:n_val], f0 == "both"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    train, val = write_code_corpus(root)
    return root, train, val


# ---- core/wav.py, core/seed.py --------------------------------------------


def test_wav_readers_match_jax(tmp_path):
    import scipy.io.wavfile as sw

    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal(3000) * 6000).astype(np.int16)
    write_pcm16(tmp_path / "pcm.wav", pcm)
    write_pcm16(tmp_path / "stereo.wav", np.stack([pcm, pcm[::-1]], -1), channels=2)
    sw.write(str(tmp_path / "f32.wav"), SR, (pcm / 40000).astype(np.float32))
    sw.write(str(tmp_path / "i32.wav"), SR, pcm.astype(np.int32) << 12)
    with open(tmp_path / "x.flac", "wb") as f:
        f.write(encode_flac(pcm.astype(np.int64), SR))
    for name in ("pcm.wav", "stereo.wav", "f32.wav", "i32.wav", "x.flac"):
        for dtype in ("int16", "float32"):
            ref, ref_sr = jwav.read_audio(str(tmp_path / name), dtype=dtype)
            got, got_sr = twav.read_audio(str(tmp_path / name), dtype=dtype)
            assert got_sr == ref_sr and got.dtype == ref.dtype, name
            np.testing.assert_array_equal(got, ref, err_msg=f"{name} {dtype}")
    for fn, arg in (("normalize_audio_int16", pcm), ("peak_normalize", np.zeros(4))):
        np.testing.assert_array_equal(getattr(twav, fn)(arg), getattr(jwav, fn)(arg))
    y = np.sin(np.linspace(0, 50, 999)) * 1.2
    twav.write_wav(str(tmp_path / "t.wav"), y, SR)
    jwav.write_wav(str(tmp_path / "j.wav"), y, SR)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_seed_everything_seeds_random_numpy_and_torch():
    draws = []
    for _ in range(2):
        seed_everything(11)
        draws.append((random.random(), np.random.rand(), float(torch.rand(()))))
    assert draws[0] == draws[1]


# ---- the native bindings ---------------------------------------------------


def test_native_wav_binding_matches_jax(corpus):
    root, _, _ = corpus
    paths = sorted(str(p) for p in root.glob("*.wav"))
    assert "/build/native/libwavloader-" in tnative._lib()._name  # never written into native/
    for p in paths:
        assert tnative.wav_info(p) == jnative.wav_info(p)
        got, ref = tnative.load_normalized(p), jnative.load_normalized(p)
        assert got[1] == ref[1] and got[0].tobytes() == ref[0].tobytes()
    starts = [0, 9000, 17, 4321]
    eff = [-1, 3200, 1600, 9999999]
    before = tnative.call_counts["load_crops"]
    got = tnative.load_crops(paths[:4], starts, 2560, eff)
    assert got.tobytes() == jnative.load_crops(paths[:4], starts, 2560, eff).tobytes()
    assert tnative.call_counts["load_crops"] == before + 1
    with pytest.raises(IOError, match="failed to decode"):
        tnative.load_crops([str(root / "missing.wav")], [0], 16)


@pytest.mark.parametrize("kw", [dict(kind="fixed2"), dict(kind="lpc2", block_size=1024),
                                dict(kind="verbatim", stereo="mid_side"),
                                dict(bits=24), dict(escape=True), dict(wasted=3)])
def test_native_flac_binding_matches_jax(tmp_path, kw):
    rng = np.random.default_rng(2)
    n = 1024 * 3 + 321
    x = np.round(8000 * np.sin(np.arange(n) * 0.06) + 1500 * rng.standard_normal(n))
    x = x.astype(np.int64)
    if kw.get("wasted"):
        x = (x >> 3) << 3
    if kw.get("bits") == 24:
        x = x << 8
    if kw.get("stereo"):
        x = np.stack([x, x[::-1] // 2], axis=1)
    path = str(tmp_path / "t.flac")
    with open(path, "wb") as f:
        f.write(encode_flac(x, 22050, **kw))
    assert tflac.flac_info(path) == jflac.flac_info(path)
    for dtype in ("int32", "int16", "float32"):
        got, ref = tflac.read_flac(path, dtype=dtype), jflac.read_flac(path, dtype=dtype)
        assert got[1] == ref[1] and got[0].dtype == ref[0].dtype
        np.testing.assert_array_equal(got[0], ref[0])


# ---- CodeDataset -------------------------------------------------------------


def _datasets(files, **kw):
    kw = dict(dict(segment_size=2560, code_hop_size=320, sampling_rate=SR, seed=7), **kw)
    return jcd.CodeDataset(files, **kw), tcd.CodeDataset(files, f0_device="cpu", **kw)


def _same_batches(ref, got, f0_rtol=0.0):
    assert len(ref) == len(got) > 0
    for rb, gb in zip(ref, got):
        assert set(rb) == set(gb)
        for k in rb:
            assert gb[k].dtype == rb[k].dtype and gb[k].shape == rb[k].shape, k
            if k == "f0" and f0_rtol:
                np.testing.assert_array_equal(gb[k] == 0, rb[k] == 0)
                np.testing.assert_allclose(gb[k], rb[k], rtol=f0_rtol)
            else:
                np.testing.assert_array_equal(gb[k], rb[k], err_msg=k)


def test_parse_manifest_and_speakers_match_jax(corpus):
    root, train, val = corpus
    ref, got = jcd.parse_manifest(train, str(root)), tcd.parse_manifest(train, str(root))
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        assert len(g) == len(r) and all(np.array_equal(a, b) and a.dtype == b.dtype
                                        for a, b in zip(g, r))
    for method in ("_", "parent_name", "parent_parent_name", "single"):
        assert tcd.parse_speaker(ref[0][0], method) == jcd.parse_speaker(ref[0][0], method)
    h = dict(input_training_file=train, input_validation_file=val, train_base_path=str(root),
             val_base_path=str(root))

    class H:
        pass

    cfg = H()
    cfg.__dict__.update(h)
    assert tcd.get_dataset_filelist(cfg)[1][0] == jcd.get_dataset_filelist(cfg)[1][0]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("norm", [dict(), dict(f0_normalize=True, f0_median=True),
                                  dict(f0_normalize=True, f0_median=False)])
def test_code_dataset_batches_match_jax(corpus, native, norm):
    root, train, _ = corpus
    files = jcd.parse_manifest(train, str(root))
    stats = {"p225": {"mean": 150.0, "std": 30.0}, "p226": {"mean": 120.0, "std": 20.0},
             "f0_mean": 140.0, "f0_std": 25.0}
    jds, tds = _datasets(files, f0_stats=stats if norm else None, **norm)
    assert tds.id_to_spkr == jds.id_to_spkr == ["p225", "p226", "p227"]
    before = tnative.call_counts["load_crops"]
    got = list(tds.batches(4, shuffle=True, seed=3, use_native=native))
    assert (tnative.call_counts["load_crops"] - before == len(got)) == native
    _same_batches(list(jds.batches(4, shuffle=True, seed=3, use_native=native)), got)
    # the next epoch continues the crop draws
    _same_batches(list(jds.batches(4, shuffle=True, seed=4, use_native=native)),
                  list(tds.batches(4, shuffle=True, seed=4, use_native=native)))


def test_code_dataset_yaapt_fallback_is_jax_pooled_to_the_code_rate(corpus):
    """Val manifest without f0, a padded final batch: crops, codes and
    speakers as the JAX package's; f0 is JAX's YAAPT track of the same crop
    pooled per code frame as the unit encoder pools it (the port's one
    change: the JAX track, 4 values a code frame, makes the LUT generator
    answer with 4 times the segment).  The reference f0 is taken from the
    JAX ``yaapt_f0`` directly, not through the JAX dataset's catch-all,
    which would turn a failure into zeros."""
    from dissc_tpu.audio.yaapt import yaapt_f0 as jax_yaapt_f0

    root, _, val = corpus
    files = jcd.parse_manifest(val, str(root))
    for native in (True, False):
        jds, tds = _datasets(files)
        ref = list(jds.batches(3, shuffle=False, use_native=native, drop_last=False))
        got = list(tds.batches(3, shuffle=False, use_native=native, drop_last=False))
        assert len(got) == 2 and ref[0]["f0"].shape == (3, 2560 // 80, 1)
        for rb in ref:
            rb["f0"] = np.stack([f0_per_unit(jax_yaapt_f0(a, SR), 8)[:, None]
                                 for a in rb["audio"]])
        _same_batches(ref, got, f0_rtol=1e-4)
        assert got[0]["f0"].shape == (3, 8, 1)
        assert (np.concatenate([b["f0"] for b in got]) > 0).any()


def test_yaapt_fallback_catches_only_what_the_tracker_raises(corpus, monkeypatch):
    root, _, val = corpus
    files = tcd.parse_manifest(val, str(root))
    crop = np.random.default_rng(0).standard_normal(2560).astype(np.float32)
    from dissc_tpu_torch.audio import yaapt

    # 2 kHz: the JAX tracker's 50-1500 Hz band-pass cannot be designed
    # (scipy raises ValueError), so the dataset gives zeros without calling it
    with pytest.raises(ValueError):
        yaapt._bandpass_fir(2000)
    yaapt._bandpass_fir(3001)
    ds = tcd.CodeDataset(files, 2560, 320, 2000, f0_device="cpu")
    np.testing.assert_array_equal(ds._yaapt(crop), np.zeros((8, 1), np.float32))

    ds = tcd.CodeDataset(files, 2560, 320, SR, f0_device="cpu")
    for err in (RuntimeError("CUDA error: an illegal memory access was encountered"),
                ValueError("operands could not be broadcast together")):
        def broken(*a, err=err, **k):
            raise err

        monkeypatch.setattr(yaapt, "yaapt_f0", broken)
        with pytest.raises(type(err), match=str(err)[:10]):
            ds._yaapt(crop)
        with pytest.raises(type(err), match=str(err)[:10]):
            next(tcd.CodeDataset(files, 2560, 320, SR, f0_device="cpu").batches(2, shuffle=False))


# ---- stats and the prosody datasets -----------------------------------------------


def _unit_jsonl(path, n=9, seed=5):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            k = int(rng.integers(5, 30))
            units = np.repeat(rng.integers(0, 100, k), rng.integers(1, 4, k))[:k]
            f0 = np.where(rng.random(k) < 0.3, 0.0, rng.uniform(80, 260, k))
            f.write(json.dumps({"units": units.tolist(), "f0": f0.round(2).tolist(),
                                "audio": f"s{i % 3}_{i + 1:03d}.wav"}) + "\n")
    return str(path)


def test_stats_match_jax_and_pickles_cross(tmp_path):
    path = _unit_jsonl(tmp_path / "all.jsonl")
    spk = tstats.get_spkrs_dict(path)
    assert spk == jstats.get_spkrs_dict(path)
    tstats.save_id_to_spkr(str(tmp_path / "t_ids.pkl"), sorted(spk))
    jstats.save_id_to_spkr(str(tmp_path / "j_ids.pkl"), sorted(spk))
    assert (tmp_path / "t_ids.pkl").read_bytes() == (tmp_path / "j_ids.pkl").read_bytes()
    assert jstats.load_id_to_spkr(str(tmp_path / "t_ids.pkl")) == spk
    tstats.calculate_pitch_stats(path, str(tmp_path / "t" / "f0.pkl"))
    jstats.calculate_pitch_stats(path, str(tmp_path / "j" / "f0.pkl"))
    # each package reads the other's pickle
    port_written = jstats.load_f0_stats(str(tmp_path / "t" / "f0.pkl"))
    jax_written = tstats.load_f0_stats(str(tmp_path / "j" / "f0.pkl"))
    assert port_written == jax_written
    for a, b in zip(tstats.prep_stats_arrays(spk, port_written),
                    jstats.prep_stats_arrays(spk, jax_written)):
        np.testing.assert_array_equal(a, b)
    for method in ("random", "paired_val"):
        outs = []
        for mod, sub in ((tstats, "t"), (jstats, "j")):
            os.makedirs(tmp_path / method / sub, exist_ok=True)
            src = tmp_path / method / sub / "all.jsonl"
            src.write_text(open(path).read())
            np.random.seed(3)
            outs.append([open(p).read() for p in mod.data_split(str(src), method, 0.6)])
        assert outs[0] == outs[1] and outs[0][1]


def test_prosody_datasets_and_batch_order_match_jax(tmp_path):
    path = _unit_jsonl(tmp_path / "train.txt")
    spk = jstats.get_spkrs_dict(path)
    stats = {n: {"mean": 150.0 + i, "std": 25.0} for n, i in spk.items()}
    pairs = [(jdatasets.LenDataset.from_file(path, spk), tdatasets.LenDataset.from_file(path, spk)),
             (jdatasets.PitchDataset.from_file(path, spk, stats),
              tdatasets.PitchDataset.from_file(path, spk, stats))]
    for ref, got in pairs:
        for field in ("vals", "spk_ids", "lens" if hasattr(ref, "lens") else "fs"):
            a, b = getattr(got, field), getattr(ref, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got.names == ref.names
    ref_len, got_len = pairs[0]
    assert got_len.train_norm_stats() == ref_len.train_norm_stats()
    arrays = (ref_len.vals, ref_len.lens, ref_len.spk_ids)
    ref_b = list(jdatasets.batch_iterator(arrays, 4, True, np.random.default_rng(9), (100, -1, 0)))
    got_b = list(tdatasets.batch_iterator(arrays, 4, True, np.random.default_rng(9), (100, -1, 0)))
    assert len(got_b) == len(ref_b) == 3
    for rb, gb in zip(ref_b, got_b):
        for a, b in zip(gb, rb):
            np.testing.assert_array_equal(a, b)
