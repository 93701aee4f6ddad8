"""One-call conversion pipeline: waveform (or unit record) in, converted
waveform out (``dissc_tpu.pipeline``).

The reference chains CLI scripts through the filesystem
(``scripts/convert_eval.py:55-139``: encode -> infer.py ->
sr/inference.py).  :class:`ConversionPipeline` runs the same flow on one
device and loads the artifact layout the JAX package's CLIs write:
``id_to_spkr.pkl``, ``f0_stats.pkl``, prosody checkpoint dirs
(``best_model.pth`` + ``len_norm_stats.pth``), a vocoder checkpoint dir
(``config.json`` + ``g_*``) and, for wav input, a HuBERT param pickle and
a k-means codebook.

    pipe = ConversionPipeline.load(
        vocoder_ckpt="checkpoints/vctk_vocoder",
        len_model_dir="checkpoints/vctk/len",
        f0_model_dir="checkpoints/vctk/pitch",
        id_to_spkr="data/VCTK/hubert100/id_to_spkr.pkl",
        f0_stats="data/VCTK/hubert100/f0_stats.pkl",
        hubert_weights="hubert_params.pkl",       # optional: enables wav input
        kmeans_codebook="km100.npy",
    )
    wav, sr = pipe.convert(wav=src_wav, sr=sr, source_speaker="p231",
                           target_speaker="p245")

Without ``len_model_dir`` the rhythm is kept; without ``f0_model_dir`` the
pitch follows the reference's nearest-interpolation heuristic
(``utils.py:47-52``), as ``infer.py``'s --pred_len/--pred_pitch switches.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from dissc_tpu_torch.data.stats import load_f0_stats, load_id_to_spkr, prep_stats_arrays
from dissc_tpu_torch.device import DeviceLike, resolve_device
from dissc_tpu_torch.infer.prosody import ProsodyConverter
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from dissc_tpu_torch.infer.vocoder import renorm_f0 as _renorm_f0
from dissc_tpu_torch.models.hubert import SpeechUnitEncoder, load_encoder


class ConversionPipeline:
    def __init__(self, vocoder: VocoderEngine, prosody: ProsodyConverter,
                 spk_dict: Dict[str, int], f0_stats: Optional[Dict] = None,
                 encoder: Optional[SpeechUnitEncoder] = None, norm_pitch: bool = True):
        self.vocoder = vocoder
        self.prosody = prosody
        self.spk_dict = spk_dict
        self.f0_stats = f0_stats
        self.encoder = encoder
        # reference --norm_pitch is store_false/default-True (infer.py:189):
        # the pitch predictor de-whitens to the TARGET speaker's stats
        self.norm_pitch = norm_pitch

    @classmethod
    def load(cls, vocoder_ckpt: str, id_to_spkr: str, len_model_dir: Optional[str] = None,
             f0_model_dir: Optional[str] = None, f0_model_type: str = "new",
             f0_stats: Optional[str] = None, hubert_weights: Optional[str] = None,
             kmeans_codebook: Optional[str] = None, n_tokens: int = 100,
             norm_pitch: bool = True, device: DeviceLike = None,
             **vocoder_kw) -> "ConversionPipeline":
        """``device=None`` runs every stage on the CUDA card and raises
        without one."""
        device = resolve_device(device)
        spk_dict = load_id_to_spkr(id_to_spkr)
        stats = load_f0_stats(f0_stats) if f0_stats else None
        id2mean = id2std = None
        if stats is not None:
            id2mean, id2std = prep_stats_arrays(spk_dict, stats)
        prosody = ProsodyConverter.load(
            n_speakers=len(spk_dict), len_model_dir=len_model_dir,
            f0_model_dir=f0_model_dir, f0_model_type=f0_model_type,
            id2pitch_mean=id2mean, id2pitch_std=id2std, n_tokens=n_tokens, device=device)
        vocoder = VocoderEngine.from_checkpoint(vocoder_ckpt, device=device, **vocoder_kw)
        encoder = None
        if hubert_weights and kmeans_codebook:
            encoder = load_encoder(hubert_weights, kmeans_codebook, device=device)
        return cls(vocoder, prosody, spk_dict, f0_stats=stats, encoder=encoder,
                   norm_pitch=norm_pitch)

    def encode(self, wav: np.ndarray, sr: int = 16000) -> Dict:
        """wav -> ``{units, f0}`` unit record, resampled to 16 kHz first when
        ``sr`` differs (needs HuBERT weights and a codebook at load)."""
        if self.encoder is None:
            raise RuntimeError(
                "ConversionPipeline was loaded without hubert_weights/"
                "kmeans_codebook; pass a unit record to convert_record() "
                "instead, or reload with encoder weights")
        if sr != 16000:
            from dissc_tpu_torch.audio.resample import resample_poly_np

            wav = resample_poly_np(np.asarray(wav, np.float32), sr, 16000)
            sr = 16000
        return self.encoder(np.asarray(wav, np.float32), sr)

    def convert_record(self, record: Dict, target_speaker: str,
                       source_speaker: Optional[str] = None, renorm_f0: bool = False
                       ) -> Tuple[np.ndarray, int]:
        """Convert one unit record to ``target_speaker``'s voice and prosody.

        ``record``: ``{"units": [int], "f0": [float], ["audio": name]}``.
        ``source_speaker`` names the input speaker for f0 whitening; by
        default the record's filename prefix (``sr/dataset.py:140-141``).
        ``renorm_f0`` also shifts the contour toward the target's f0
        statistics (reference ``sr/inference.py:220-235``).
        Returns (float32 waveform, sample rate)."""
        if target_speaker not in self.spk_dict:
            raise KeyError(f"unknown target speaker {target_speaker!r}; "
                           f"known: {sorted(self.spk_dict)[:8]}...")
        rec = dict(record)
        if source_speaker is not None:
            rec["audio"] = f"{source_speaker}_pipeline.wav"
        elif "audio" not in rec:
            raise ValueError("record has no 'audio' name; pass source_speaker")
        converted = self.prosody.convert_records(
            [rec], self.spk_dict, target_speaker=target_speaker, norm_pitch=self.norm_pitch)[0]
        target_id = self.spk_dict[target_speaker]
        f0 = np.asarray(converted["f0"], np.float32)
        if renorm_f0:
            if self.f0_stats is None:
                raise RuntimeError("renorm_f0 requires f0_stats at load()")
            f0 = _renorm_f0(f0, target_id, target_speaker, self.f0_stats)
        item = {"code": np.asarray(converted["units"], np.int32), "f0": f0.reshape(-1, 1),
                "spkr": np.asarray([target_id], np.int32)}
        wavs, _rtf = self.vocoder.synthesize_utterances([item])
        return wavs[0], self.vocoder.h.sampling_rate

    def convert(self, wav: np.ndarray, target_speaker: str, sr: int = 16000,
                source_speaker: Optional[str] = None, renorm_f0: bool = False
                ) -> Tuple[np.ndarray, int]:
        """Waveform -> units + f0 -> prosody conversion -> synthesis; see
        :meth:`convert_record`."""
        record = self.encode(wav, sr)
        return self.convert_record(record, target_speaker, source_speaker=source_speaker,
                                   renorm_f0=renorm_f0)

    def convert_batch(self, records: List[Dict], target_speaker: str, batch_size: int = 8
                      ) -> Tuple[List[np.ndarray], int]:
        """Convert many unit records in bucketed batches (the serving shape).
        Records need reference-style ``audio`` names for the source speaker.
        Returns (waveforms, sample rate)."""
        converted = self.prosody.convert_records(
            records, self.spk_dict, target_speaker=target_speaker,
            norm_pitch=self.norm_pitch, batch_size=batch_size)
        target_id = self.spk_dict[target_speaker]
        items = [{"code": np.asarray(c["units"], np.int32),
                  "f0": np.asarray(c["f0"], np.float32).reshape(-1, 1),
                  "spkr": np.asarray([target_id], np.int32)} for c in converted]
        wavs, _rtf = self.vocoder.synthesize_utterances(items, batch_size=batch_size)
        return wavs, self.vocoder.h.sampling_rate
