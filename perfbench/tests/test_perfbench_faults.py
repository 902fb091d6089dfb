"""``correct`` has to see a broken timed path and the control. Each cell runs
here on the CPU at a small size with the rest of a run as it is (the look for
a card skipped): a sound run is correct; a run whose timed path leaves half
of each batch out, or alters one answer where it is produced, is not; and the
control (the reference one precision below the cell's, in the program's
place) is not correct either. A training cell's faults are a half batch, an
update that leaves the state as it was, and two that only the window's
checked call can see: the KL term dropped, and a batch replayed in place of
the stream's, each from the fourth update on."""

from __future__ import annotations

import io

import pytest
import torch

from perfbench.tests import tiny

CELLS = [w["name"] for w in tiny.manifest()["workloads"]]


def half_batch(monkeypatch, kind):
    """Serving: the encoder's forward computes only the first half of each
    batch (the other rows' latents stay zero). Training: the loss is the mean
    over the first half of the batch only."""
    if kind == "train":
        from anuraxla_torch.models import train

        loss = train.vae_loss
        monkeypatch.setattr(train, "vae_loss", lambda vae, batch, eps, beta: loss(
            vae, batch[: batch.shape[0] // 2], eps[: batch.shape[0] // 2], beta))
        return
    from anuraxla_torch.pipeline.session import EncoderSession

    forward = EncoderSession._forward

    def broken(self, audio, replica=None):
        mu = forward(self, audio, replica)
        return torch.cat([mu[: mu.shape[0] // 2], torch.zeros_like(mu[mu.shape[0] // 2:])])

    monkeypatch.setattr(EncoderSession, "_forward", broken)


def altered_answer(monkeypatch, kind):
    """The radial decision reports one row's best distance 25 % too far."""
    from anuraxla_torch.cli import evaluate_wav
    from anuraxla_torch.detect.radial import radial_decide
    from anuraxla_torch.pipeline import benchmark

    def broken(Z, centroids, thresholds, ranks):
        det, win, best = radial_decide(Z, centroids, thresholds, ranks)
        best = best.clone()
        best[0] *= 1.25
        return det, win, best

    monkeypatch.setattr(benchmark, "radial_decide", broken)
    monkeypatch.setattr(evaluate_wav, "radial_decide", broken)


def state_unchanged(monkeypatch, kind):
    """The optimizer's update returns the state as it found it."""
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def kl_dropped_later(monkeypatch, kind):
    """From the fourth update on, the loss leaves its KL term out."""
    from anuraxla_torch.models import train

    beta = train.kl_beta
    monkeypatch.setattr(train, "kl_beta", lambda b, step, *a: 0.0 if step >= 3 else beta(b, step, *a))


def stale_batch_later(monkeypatch, kind):
    """From the fourth update on, every update steps on the batch of the fourth
    (as a captured graph that replays its first input would)."""
    from anuraxla_torch.models import train

    make = train.make_train_step

    def broken(*a, **k):
        step, kept = make(*a, **k), {}

        def stale(state, batch, eps=None):
            if state.step >= 3:
                batch = kept.setdefault("batch", batch)
            return step(state, batch, eps)

        return stale

    monkeypatch.setattr(train, "make_train_step", broken)


# the faults a cell of each kind can have
FAULTS = {"folder": (half_batch, altered_answer), "scan": (half_batch, altered_answer),
          "request": (half_batch, altered_answer),
          "train": (half_batch, state_unchanged, kl_dropped_later, stale_batch_later)}
CASES = [(n, f.__name__) for n in CELLS for f in FAULTS[tiny.cell(n).kind]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res, err = tiny.run(tiny.cell(name))
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    lines = err.strip().splitlines()[-len(res["compared"]):]
    assert [ln.split()[0] for ln in lines] == list(res["compared"])


@pytest.mark.parametrize("name,fault", CASES)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny.cell(name)
    globals()[fault](monkeypatch, cell.kind)
    res, _ = tiny.run(cell)
    assert res["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    from perfbench import control

    rows = control.control_readings(tiny.cell(name), [11, 12, 13], torch.device("cpu"), out=io.StringIO())
    assert not any(r["correct"] for r in rows), rows
