"""Single requests: a closed loop of one client that asks
``cli.evaluate_wav.detect_species`` about one 5 s WAV at a time (config read,
WAV decode, a batch of one row through the session, radial decision on the
host), cycling over the mix's files in an order drawn from the seed. A unit
is one request."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from perfbench import synth
from perfbench.drivers.base import Driver as Base
from perfbench.reference import audio as ref_audio
from perfbench.reference.compare import compare


class Driver(Base):
    RANGES = (("anuraxla_torch.cli.evaluate_wav", "load_config", "perfbench::config_read"),
              ("anuraxla_torch.cli.evaluate_wav", "load_wav_batch", "perfbench::decode"),
              ("anuraxla_torch.pipeline.session:EncoderSession", "encode_array", "perfbench::encode"),
              ("anuraxla_torch.cli.evaluate_wav", "radial_decide", "perfbench::decide"))

    def setup(self, program: bool = True) -> None:
        mel = self.cfg["mel"]
        self.files = synth.chunk_tree(self.work / "req", self.mix, self.seed, self.dev,
                                      sr=mel["sr"], seconds=mel["duration"])
        self.make_weights()
        L = int(mel["sr"] * mel["duration"])
        cal = [f for f in self.files if f["has_call"]]
        rows = ref_audio.read_rows([f["path"] for f in cal], L)
        self.config_path = self.work / "config.json"
        self.config_path.write_text(json.dumps(self.detector(rows, np.array([f["species"] for f in cal]),
                                                             normalize=False)))
        os.sync()  # the inputs reach the disk in set-up, not under the window
        paths = [f["path"] for f in self.files]
        self.ref_rows = lambda a, b: ref_audio.read_rows(paths[a:b], L)
        self.n_ref, self.ref_normalize = len(paths), False
        if not program:
            return
        self.session = self.make_session()
        self.order = np.random.default_rng([self.seed, 4]).permutation(len(self.files))
        self.k = 0
        self.species_index = {s: j for j, s in enumerate(synth.SPECIES)}
        for warm in (True, False):  # each request's answer, kept as plain numbers
            self.asked, self.detected, self.winner, self.best = [], [], [], []
            for _ in range(int(self.wl.get("warmup_calls", 1)) if warm else 0):
                self.unit()

    def unit(self) -> int:
        from anuraxla_torch.cli.evaluate_wav import detect_species

        i = int(self.order[self.k % len(self.order)])
        self.k += 1
        detected, species, best = detect_species(self.files[i]["path"], self.session, self.config_path)
        self.asked.append(i)
        self.detected.append(detected)
        self.winner.append(self.species_index.get(species, -1) if detected else -1)
        self.best.append(best)
        return 1

    def counts(self, win) -> Dict[str, float]:
        return {"attempted": win.units, "failed": 0, "requests": win.units}

    def check(self) -> Dict[str, tuple]:
        d_ref = self.reference_distances()
        idx = np.array(self.asked, int)
        if not len(idx):
            return self.worst([])
        return self.worst([compare(np.array(self.best), np.array(self.winner), np.array(self.detected, bool), 0,
                                   d_ref[idx], self.thresholds, self.limits()["dist_gap"])])
