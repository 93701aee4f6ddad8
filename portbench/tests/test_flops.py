"""``portbench/flops.py`` against ``torch.utils.flop_counter`` over the
frozen reference models at small widths."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops
from portbench import weights as wt
from portbench.reference import hubert as rh
from portbench.reference import prosody as rp
from portbench.reference import vocoder as rv
from portbench.reference.ops import Ops
from portbench.tests.small import TINY

CPU = torch.device("cpu")


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def small_vocoder() -> dict:
    from dissc_tpu_torch.core.config import VocoderConfig

    return dataclasses.asdict(VocoderConfig.from_dict({k: v for k, v in TINY.items()
                                                       if k != "hubert"}))


@pytest.mark.parametrize("frames", [7, 40])
def test_generator(frames):
    h = small_vocoder()
    p = wt.materialize(rv.generator_spec(h), 1, CPU)
    code = torch.randint(0, 100, (2, frames))
    f0 = torch.rand(2, frames, 1)
    spkr = torch.zeros(2, 1, dtype=torch.long)
    n = counted(lambda: rv.generator(Ops(), p, h, code, f0, spkr))
    assert n == 2 * flops.generator(h, frames)


@pytest.mark.parametrize("t", [1280, 1283])
def test_discriminators(t):
    h = small_vocoder()
    mpd_p = wt.materialize(rv.mpd_spec(h), 2, CPU)
    msd_p = wt.materialize(rv.msd_spec(h), 3, CPU)
    y = torch.randn(1, t) * 0.3
    with torch.no_grad():
        n = counted(lambda: (rv.mpd(Ops(), mpd_p, h, y, y),
                             rv.msd(Ops(), msd_p, h, y, y, train=False)))
    total, first = flops.discriminators(h, t)
    assert n == 2 * total  # the spectral norm's matrix-vector products are not counted
    assert 0 < first < total


def test_train_step():
    """The step's count with the mel loss's log-mels (left out of
    ``flops.train_step``) added back as the plain chain computes them."""
    h = small_vocoder()
    b, t = h["batch_size"], h["segment_size"]
    gp = wt.materialize(rv.generator_spec(h), 1, CPU)
    dp = {**{f"mpd.{k}": v for k, v in wt.materialize(rv.mpd_spec(h), 2, CPU).items()},
          **{f"msd.{k}": v for k, v in wt.materialize(rv.msd_spec(h), 3, CPU).items()}}
    frames = t // h["code_hop_size"]
    batch = {"code": torch.randint(0, 100, (b, frames)), "f0": torch.rand(b, frames, 1) * 200,
             "spkr": torch.zeros(b, 1, dtype=torch.long), "audio": torch.randn(b, t) * 0.3}
    mk = lambda: rv.AdamW(8e-4, 0.8, 0.99)  # noqa: E731
    n = counted(lambda: rv.gan_step(Ops(), gp, dp, mk(), mk(), h, batch))
    pad = (h["n_fft"] - h["hop_size"]) // 2
    mel_frames = b * (1 + (t + 2 * pad - h["n_fft"]) // h["hop_size"])
    freq = h["n_fft"] // 2 + 1
    dft = 2 * 2 * mel_frames * h["n_fft"] * freq
    mel = 2 * mel_frames * freq * h["num_mels"]
    log_mels = 2 * (dft + mel) + (dft + mel)  # y and y_hat forward, y_hat's data gradient
    # torch's counter takes a grouped conv's weight gradient ``groups`` times
    # over (it counts the ungrouped conv): the D step's two MSD passes
    over, n_in = 0, t
    for i in range(h["msd_scales"]):
        n_in = flops.conv_out(n_in, 4, 2, 2) if i else n_in
        m = n_in
        for cin, cout, k, stride, g, pad in flops.MSD_SPECS:
            m = flops.conv_out(m, k, stride, pad)
            over += 2 * b * (g - 1) * flops.conv(cin, cout, k, m, g)
    assert n - log_mels - over == flops.train_step(h, b)


@pytest.mark.parametrize("n", [5, 60])
def test_prosody(n):
    p = {"emb_size": 32, "hidden": 128}
    lw = wt.materialize(rp.len_predictor_spec(100, 107, 32, 128), 4, CPU)
    pw = wt.materialize(rp.pitch_predictor_spec(100, 107, 32, 128), 5, CPU)
    units = torch.randint(0, 100, (n,))
    assert counted(lambda: rp.len_predictor(Ops(), lw, units, 3, (0.0, 1.0), 100)) == \
        flops.len_predictor(p, n)
    assert counted(lambda: rp.pitch_predictor(Ops(), pw, units, 3, 100)) == \
        flops.pitch_predictor(p, n)


@pytest.mark.parametrize("samples", [4000, 8321])
def test_hubert(samples):
    from dissc_tpu_torch.models.hubert import HubertConfig

    c = dataclasses.asdict(HubertConfig(**TINY["hubert"]))
    hub = wt.materialize(rh.hubert_spec(c), 6, CPU)
    wav = torch.randn(1, samples) * 0.1
    codebook = torch.randn(100, c["hidden_size"])
    with torch.no_grad():
        n = counted(lambda: rh.distances(Ops(), rh.features(Ops(), hub, c, wav)[0], codebook))
    assert n == flops.hubert(c, samples, 100)
