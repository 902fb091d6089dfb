"""Training: ``train-vae``'s path, ``models.train.train_loop`` fed by
``cli.train_vae.mel_batch_stream`` (decode on the prefetch thread, a pageable
transfer, the mel kernel on the card) over a labelled chunk tree, epochs
cycled. Set-up builds one train state from the seed's weights and drives it
through its first three updates by the window's own call; the window goes
on with that same state. A unit is ``steps_a_call`` updates of one batch
each; it completes their examples.

The check follows two stretches of the program's updates with the plain
reference:

- the first three, from the seed's weights: each update's loss, the first
  gradient as AdamW holds it after one update (its first moment over
  1 - beta1), and each tensor's change after three updates. The learning
  rate and the KL weight are all but zero there;
- one call of the window, the first that starts at or after update
  ``checked_call_from_step`` (past the learning rate's warm-up and the KL
  weight's delay), or the window's last call where the window ends before
  it: from the program's own parameters and AdamW moments before that call,
  the loss of the call's last update and each tensor's change over the call.
  Before that call is reached each call's starting state is kept (a copy on
  the card, a fraction of a millisecond against a call of some hundred).

Losses are compared relatively. Gradients and changes are compared by the
norm of each tensor: |norm(program) - norm(reference)| over the larger of the
reference's norm of that tensor and of the median tensor, the worst tensor
counted; tensors whose reference gradient at the stretch's first update lies
under a thousandth of the median tensor's are left out of the change, since
AdamW moves them by round-off alone.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from perfbench import synth
from perfbench.drivers.base import Driver as Base
from perfbench.reference import audio as ref_audio, encoder as ref_encoder, lowp, mel as ref_mel
from perfbench.reference import train as ref_train

CHECKED_STEPS = 3
LIMITS = ("loss_gap", "grad_gap", "change_gap", "stretch_loss_gap", "stretch_change_gap")
MEL_BATCHES_TIMED = 16  # batches of the stream timed alone after a traced window


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> Dict[str, float]:
    """Each kept tensor's |norm(prog) - norm(ref)| / max(norm(ref), the median tensor's norm(ref))."""
    nr = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(nr.values())))
    return {k: abs(float(prog[k].double().norm()) - nr[k]) / max(nr[k], med) for k in keep}


def worst(gaps: Dict[str, float]) -> float:
    gap = max(gaps.values()) if gaps else float("inf")
    return gap if np.isfinite(gap) else float("inf")


class Driver(Base):
    FAMILIES = ("conv-vae",)  # the reference and the port train the conv-VAE with its decoder
    RANGES = (("anuraxla_torch.pipeline.dataset", "load_wav_batch", "perfbench::decode"),
              ("anuraxla_torch.cli.train_vae", "log_mel_batch", "perfbench::mel"))

    def train_config(self) -> dict:
        return self.wl["train"]

    def setup(self, program: bool = True) -> None:
        mel = self.cfg["mel"]
        self.root = self.work / "train"
        self.files = synth.chunk_tree(self.root, self.mix, self.seed, self.dev, sr=mel["sr"], seconds=mel["duration"])
        os.sync()  # the inputs reach the disk in set-up, not under the window
        self.params = ref_encoder.make_params(self.cfg, self.seed, self.dev, decoder=True)
        self.B = int(self.train_config()["batch_size"])
        self.checked = ref_train.batch_paths(self.root, self.B, 0, CHECKED_STEPS)
        self.check_from = int(self.train_config()["checked_call_from_step"])
        self.stretch = None
        if not program:
            return
        from anuraxla_torch.cli.train_vae import mel_batch_stream
        from anuraxla_torch.models.train import TrainConfig, create_train_state

        t = self.train_config()
        self.tc = TrainConfig(learning_rate=t["learning_rate"], weight_decay=t["weight_decay"], beta=t["beta"],
                              kl_delay_steps=t["kl_delay_steps"], kl_warmup_steps=t["kl_warmup_steps"],
                              warmup_steps=t["warmup_steps"], total_steps=t["total_steps"], batch_size=self.B,
                              seed=self.seed)
        self.vcfg = self.family.program_config(self.cfg)
        self.model, self.state = create_train_state(self.vcfg, self.tc, init_params=self.params, device=self.dev)
        s = self.wl["session"]
        self.stream = mel_batch_stream(self.root, self.mel_config(), self.B, s["io_threads"], 0,
                                       parity=not s["fast_frontend"], backend=s["frontend_backend"], device=self.dev)
        self.losses = []
        for k in range(CHECKED_STEPS):
            self.losses.append(self.steps(1)["loss"])
            if k == 0:
                self.g1 = self.first_gradient()
        self.p3 = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        for _ in range(int(self.wl.get("warmup_calls", 1))):
            self.unit()

    def steps(self, n: int) -> dict:
        from anuraxla_torch.models.train import train_loop

        _, self.state, metrics = train_loop(self.vcfg, self.tc, self.stream, num_steps=n, log_every=0,
                                            initial_state=self.state, device=self.dev)
        return metrics

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        """The gradient of the first update, from AdamW's first moment after it."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        # an update that never reached the optimizer leaves no moment: a zero gradient
        return {n: (opt.state[p]["exp_avg"] / (1.0 - beta1)).detach().clone() if "exp_avg" in opt.state.get(p, {})
                else torch.zeros_like(p) for n, p in self.model.named_parameters()}

    def unit(self) -> int:
        n = int(self.train_config()["steps_a_call"])
        keep = self.stretch is None or self.stretch["first"] < self.check_from
        if keep:
            before = self.train_state()
        loss = self.steps(n)["loss"]
        if keep:
            after = {k: v.detach().clone() for k, v in self.model.named_parameters()}
            self.stretch = dict(before, count=n, loss=loss, after=after)
        return n * self.B

    def train_state(self) -> dict:
        """The update count, parameters and AdamW moments as they stand, copied."""
        opt, names = self.state.optimizer, dict(self.model.named_parameters())
        moment = lambda p, key: opt.state[p][key].clone() if key in opt.state.get(p, {}) else torch.zeros_like(p)  # noqa: E731
        return {"first": int(self.state.step),
                "params": {k: p.detach().clone() for k, p in names.items()},
                "moments": tuple({k: moment(p, key) for k, p in names.items()} for key in ("exp_avg", "exp_avg_sq"))}

    def after_window(self) -> Dict[str, tuple]:
        t = time.perf_counter()
        for _ in range(MEL_BATCHES_TIMED):
            x = next(self.stream)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        del x
        return {"mel_stream": (MEL_BATCHES_TIMED, time.perf_counter() - t)}

    def counts(self, win) -> Dict[str, float]:
        return {"attempted": win.units, "failed": 0, "examples": win.units,
                "steps": win.calls * int(self.train_config()["steps_a_call"])}

    def release(self) -> None:
        if getattr(self, "stream", None) is not None:
            self.stream.close()  # joins the decode prefetch thread
        self.stream = self.state = self.model = None
        super().release()

    def reference_steps(self, batches, p0, *, first: int = 0, moments=None, control: bool = False):
        """The reference's updates ``first`` .. from ``p0`` on the files ``batches``."""
        mel = self.cfg["mel"]
        L = int(mel["sr"] * mel["duration"])
        rounding = lowp.ROUNDINGS[self.wl["control"]["trunk"]] if control else None
        rmel = lowp.ROUNDINGS[self.wl["control"]["mel"]] if control else None
        mels = []
        with torch.no_grad(), ref_encoder.no_tf32():
            for paths in batches:
                y = torch.from_numpy(ref_audio.read_rows(paths, L)).to(self.dev)
                mels.append(ref_mel.log_mel(y, mel, self.cfg["standardize_eps"], rounding=rmel))
        return ref_train.steps(p0, mels, self.cfg, self.train_config(), self.seed, rounding=rounding,
                               first=first, moments=moments)

    @staticmethod
    def change_gaps(p0, after, r_after, r_g):
        """Each moved tensor's change gap (tensors with a reference gradient
        under a thousandth of the median's left out) -> (gaps, left out)."""
        norms = {k: float(v.double().norm()) for k, v in r_g.items()}
        med = float(np.median(list(norms.values())))
        moved = [k for k in r_g if norms[k] >= 1e-3 * med]
        change = {k: after[k] - p0[k] for k in moved}
        return leaf_gaps(change, {k: r_after[k] - p0[k] for k in moved}, moved), sorted(set(r_g) - set(moved))

    def compare(self, start, stretch) -> Dict[str, float]:
        """``start`` (the first three updates' losses, first gradient and
        parameters after) and ``stretch`` (the checked call: its first update,
        state before, last loss and parameters after), each against the
        reference."""
        losses, g1, p3 = start
        r_losses, r_g1, r_p3 = self.reference_steps(self.checked, self.params)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        grad = leaf_gaps(g1, r_g1, list(r_g1))
        chg, left_out = self.change_gaps(self.params, p3, r_p3, r_g1)
        top = lambda g: sorted(((round(v, 9), k) for k, v in g.items()), reverse=True)[:3]  # noqa: E731
        self.diag = {"losses": list(map(float, losses)), "ref_losses": r_losses, "left_out": left_out,
                     "worst_grad": top(grad), "worst_change": top(chg),
                     "median_change_gap": float(np.median(list(chg.values())))}
        got = {"loss_gap": float(loss_gap), "grad_gap": worst(grad), "change_gap": worst(chg)}
        if stretch is None:  # no call of the window was kept: nothing of it can be judged
            return dict(got, stretch_loss_gap=float("inf"), stretch_change_gap=float("inf"))
        first, n = stretch["first"], stretch["count"]
        batches = ref_train.batch_paths(self.root, self.B, first, n)
        s_losses, s_g, s_after = self.reference_steps(batches, stretch["params"], first=first,
                                                      moments=stretch["moments"])
        s_chg, s_left = self.change_gaps(stretch["params"], stretch["after"], s_after, s_g)
        self.diag.update(stretch_first=first, stretch_loss=float(stretch["loss"]), stretch_ref_loss=s_losses[-1],
                         stretch_left_out=s_left, stretch_worst_change=top(s_chg),
                         stretch_median_change_gap=float(np.median(list(s_chg.values()))),
                         stretch_kl_weight=ref_train.kl_weight(self.train_config(), first),
                         stretch_learning_rate=ref_train.learning_rate(self.train_config(), first))
        loss = abs(float(stretch["loss"]) - s_losses[-1]) / abs(s_losses[-1])
        return dict(got, stretch_loss_gap=loss if np.isfinite(loss) else float("inf"),
                    stretch_change_gap=worst(s_chg))

    def check(self) -> Dict[str, tuple]:
        got = self.compare((self.losses, {k: v.to(self.dev) for k, v in self.g1.items()}, self.p3), self.stretch)
        lim = self.limits()
        return {k: (got[k], lim[k]) for k in LIMITS}

    # the control needs the program's state before the checked call: it runs
    # the program that far, then puts the reference one precision below in its place
    CONTROL_RUNS_PROGRAM = True

    def control_numbers(self) -> Dict[str, float]:
        while self.stretch is None or self.stretch["first"] < self.check_from:
            self.unit()
        stretch = self.stretch
        self.release()
        losses, g1, p3 = self.reference_steps(self.checked, self.params, control=True)
        first, n = stretch["first"], stretch["count"]
        c_losses, _, c_after = self.reference_steps(ref_train.batch_paths(self.root, self.B, first, n),
                                                    stretch["params"], first=first, moments=stretch["moments"],
                                                    control=True)
        return self.compare((losses, g1, p3), dict(stretch, loss=c_losses[-1], after=c_after))
