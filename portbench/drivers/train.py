"""Driver of the vocoder's GAN training: ``GANTrainer.train_step`` fed by
``CodeDataset.batches`` through ``Prefetcher``, as ``train_vocoder``'s
epoch loop feeds it, on a corpus written from the seed.

Set-up builds the trainer, loads the benchmark's seeded weights into it,
opens the epoch's prefetcher and runs the first ``check.steps`` steps
through the same loop as the window; those steps are the ones checked.
The window runs on from the same trainer, closed loop, for ``seconds``.

The check: the plain reference (``portbench/reference/vocoder.py``) runs
the same steps from the same weights on the same batches, and compares
each step's losses, the first gradient of every leaf as the optimizer got
it (its AdamW ``exp_avg`` after one step, over ``1 - b1``) and every
leaf's change over the checked steps, each by the gap of the norms.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from portbench import traffic as tf
from portbench import weights as wt
from portbench.reference import vocoder as ref
from portbench.reference.ops import Ops

from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.data.code_dataset import CodeDataset, parse_manifest
from dissc_tpu_torch.train import vocoder_trainer as vt


def _config(run) -> VocoderConfig:
    return VocoderConfig.from_dict(run.config)


def _weights(run, h: dict) -> tuple:
    seed = wt.sub_seed(run.seed, "weights")
    gen = wt.materialize(ref.generator_spec(h), seed, run.device)
    mpd = wt.materialize(ref.mpd_spec(h), seed + 1, run.device)
    msd = wt.materialize(ref.msd_spec(h), seed + 2, run.device)
    return gen, mpd, msd


def _named(trainer) -> dict:
    """The trainer's leaves by the reference's names."""
    out = {k: v for k, v in trainer.gen.named_parameters()}
    out.update({f"mpd.{k}": v for k, v in trainer.mpd.named_parameters()})
    out.update({f"msd.{k}": v for k, v in trainer.msd.named_parameters()})
    return out


def _epochs(ds, batch: int, seed: int, pin: bool):
    """One prefetcher an epoch, as ``train_vocoder`` opens them (pinned on the card)."""
    epoch = 0
    while True:
        yield vt.Prefetcher(ds.batches(batch, shuffle=True, seed=seed + epoch), pin=pin)
        epoch += 1


def setup(run):
    h = _config(run)
    t = run.traffic
    manifest = tf.write_corpus(t, wt.rng(run.seed, "corpus"), run.tmpdir)
    files = parse_manifest(manifest, run.tmpdir)
    crop_seed = wt.sub_seed(run.seed, "crops") % (2 ** 31)
    ds = CodeDataset(files, h.segment_size, h.code_hop_size, h.sampling_rate,
                     multispkr=h.multispkr, f0=h.f0, f0_normalize=h.f0_normalize,
                     f0_median=h.f0_median, seed=crop_seed, f0_device=run.device)
    trainer = vt.GANTrainer(h, device=run.device, steps_per_epoch=max(1, len(ds) // h.batch_size))
    gen, mpd, msd = _weights(run, dataclasses.asdict(h))
    trainer.gen.load_state_dict(gen)
    trainer.mpd.load_state_dict(mpd)
    trainer.msd.load_state_dict(msd)
    del gen, mpd, msd
    run.spans.wrap(trainer, "train_step", "train_step")
    epochs = _epochs(ds, h.batch_size, crop_seed, pin=run.device.type == "cuda")
    s = dict(h=h, trainer=trainer, epochs=epochs, steps=0, batches=[], losses=[], wait_s=0.0)
    s["prefetch"] = next(s["epochs"])
    s["it"] = iter(s["prefetch"])
    p0 = {k: v.detach().clone() for k, v in _named(trainer).items()}
    for k in range(run.workload["check"]["steps"]):
        batch, metrics = _step(run, s)
        s["batches"].append(batch)
        s["losses"].append({n: float(metrics[n]) for n in ("loss_disc", "loss_gen_total")})
        if k == 0:
            named = _named(trainer)
            b1 = h.adam_b1
            s["grad1"] = {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"]) / (1 - b1))
                          for opt in (trainer.opt_g, trainer.opt_d)
                          for n, p in named.items() if p in opt.state}
    s["delta"] = {n: float(torch.linalg.vector_norm(v.detach() - p0[n]))
                  for n, v in _named(trainer).items()}
    del p0
    return s


def _step(run, s):
    """One step of the loop: the next batch (a new epoch's prefetcher when
    one ends), onto the card, ``train_step``; the losses read every 5
    steps, as ``train_vocoder`` prints them."""
    with run.spans.span("batch_wait"):
        try:
            batch = next(s["it"])
        except StopIteration:
            s["wait_s"] += s["prefetch"].wait_s
            s["prefetch"].__exit__(None, None, None)
            s["prefetch"] = next(s["epochs"])
            s["it"] = iter(s["prefetch"])
            batch = next(s["it"])
    dev_batch = vt._device_batch(batch, run.device)
    metrics = s["trainer"].train_step(dev_batch)
    s["steps"] += 1
    if s["steps"] % 5 == 0:
        float(metrics["loss_gen_total"])
    return dev_batch, metrics


def _wait(s) -> float:
    return s["wait_s"] + s["prefetch"].wait_s


def window(run, s, seconds: float) -> dict:
    steps0, wait0 = s["steps"], _wait(s)
    t0 = time.perf_counter_ns()
    while time.perf_counter_ns() - t0 < seconds * 1e9:
        _step(run, s)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    t1 = time.perf_counter_ns()
    n = s["steps"] - steps0
    return {"t0_ns": t0, "t1_ns": t1, "attempted": n, "failed": 0, "steps": n,
            "segments": n * s["h"].batch_size, "batch": s["h"].batch_size,
            "prefetch_wait_s": _wait(s) - wait0}


def release(run, s) -> None:
    s["prefetch"].__exit__(None, None, None)
    for key in ("trainer", "it", "prefetch", "epochs"):
        s.pop(key)


def _gap(prog: dict, refn: dict, names) -> float:
    """The worst leaf's gap of norms, against the larger of the leaf's own
    reference norm and the median leaf's (a leaf the program's optimizer
    holds no state for reads as a norm of 0)."""
    med = statistics.median(refn[n] for n in names)
    return max(abs(prog.get(n, 0.0) - refn[n]) / max(refn[n], med) for n in names)


def reference_readings(run, s, ops: Ops) -> dict:
    """The reference's losses, first gradients and changes over the
    checked steps, from the benchmark's weights and the captured batches."""
    h = dataclasses.asdict(s["h"])
    gen, mpd, msd = _weights(run, h)
    dp = {**{f"mpd.{k}": v for k, v in mpd.items()}, **{f"msd.{k}": v for k, v in msd.items()}}
    gp = dict(gen)
    p0 = {**{k: v.clone() for k, v in gp.items()}, **{k: v.clone() for k, v in dp.items()}}
    mk = lambda: ref.AdamW(h["learning_rate"], h["adam_b1"], h["adam_b2"])  # noqa: E731
    opt_g, opt_d = mk(), mk()
    losses, grad1 = [], {}
    with ops.numerics():
        for k, batch in enumerate(s["batches"]):
            batch = {n: v.long() if n in ("code", "spkr") else v for n, v in batch.items()}
            out, gg, dg = ref.gan_step(ops, gp, dp, opt_g, opt_d, h, batch)
            losses.append(out)
            if k == 0:
                grad1 = {n: float(torch.linalg.vector_norm(g)) for n, g in {**gg, **dg}.items()}
            del gg, dg
    delta = {n: float(torch.linalg.vector_norm({**gp, **dp}[n] - p0[n])) for n in grad1}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def compare(s, r: dict) -> dict:
    """The readings of the check: the first step's losses' worst relative
    gap (``loss_gap``) and the later steps' (``loss_gap_later``, read by
    ``control.py`` and not compared: after Adam's first step every element
    has moved by the learning rate, whose sign round-off decides where the
    gradient is near 0, so two runs of one seed read up to ten times apart
    there); the worst leaf's gap of
    first-gradient norms (generator and discriminator leaves each against
    their own median);
    and of change norms over the checked steps, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's (the
    rest move by round-off alone)."""
    gaps = [max(abs(p[n] - q[n]) / abs(q[n]) for n in p)
            for p, q in zip(s["losses"], r["losses"])]
    groups = [[n for n in r["grad1"] if not n.startswith(("mpd.", "msd."))],
              [n for n in r["grad1"] if n.startswith(("mpd.", "msd."))]]
    moved = []
    for g in groups:
        med = statistics.median(r["grad1"][n] for n in g)
        moved += [n for n in g if r["grad1"][n] >= 1e-3 * med]
    return {"loss_gap": gaps[0], "loss_gap_later": max(gaps[1:], default=0.0),
            "grad_gap": max(_gap(s["grad1"], r["grad1"], g) for g in groups),
            "delta_gap": _gap(s["delta"], r["delta"], moved)}


def check(run, s, result) -> dict:
    return compare(s, reference_readings(run, s, Ops("float32")))
