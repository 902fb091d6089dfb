"""Folder benchmarks: a labelled tree of 5 s WAVs, each pass the whole folder
through ``pipeline.benchmark.run_folder_benchmark`` (decode into the
session's host ring, host -> device, mel, encoder, radial decision) with the
radial block of the run's ``config.json``. A unit is one pass; it completes
one chunk a file."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from perfbench import synth
from perfbench.drivers.base import Driver as Base, quiet
from perfbench.reference import audio as ref_audio
from perfbench.reference.compare import compare


class Driver(Base):
    RANGES = (("anuraxla_torch.pipeline.dataset", "load_wav_batch", "perfbench::decode"),
              ("anuraxla_torch.pipeline.benchmark", "scan_species_tree", "perfbench::tree_scan"),
              ("anuraxla_torch.pipeline.session:EncoderSession", "_dispatch", "perfbench::dispatch"))

    def setup(self, program: bool = True) -> None:
        mel = self.cfg["mel"]
        self.files = synth.chunk_tree(self.work / "tree", self.mix, self.seed, self.dev,
                                      sr=mel["sr"], seconds=mel["duration"])
        self.index = {str(f["path"]): i for i, f in enumerate(self.files)}
        self.species_index = {s: i for i, s in enumerate(synth.SPECIES)}
        self.make_weights()
        rng = np.random.default_rng([self.seed, 3])
        sample = [f for fs in synth.by_species([f for f in self.files if f["has_call"]], len(synth.SPECIES)).values()
                  for f in rng.permutation(np.array(fs, dtype=object))[: int(self.mix["calibration_per_species"])]]
        rows = ref_audio.read_rows([f["path"] for f in sample], int(mel["sr"] * mel["duration"]))
        self.config_path = self.work / "config.json"
        self.config_path.write_text(json.dumps(self.detector(rows, np.array([f["species"] for f in sample]),
                                                             normalize=False)))
        os.sync()  # the inputs reach the disk in set-up, not under the window
        paths = [f["path"] for f in self.files]
        L = int(mel["sr"] * mel["duration"])
        self.ref_rows = lambda a, b: ref_audio.read_rows(paths[a:b], L)
        self.n_ref, self.ref_normalize = len(paths), False
        self.passes = []
        if not program:
            return
        self.session = self.make_session()
        for _ in range(int(self.wl.get("warmup_calls", 1))):
            self.unit()
        self.passes.clear()

    def unit(self) -> int:
        from anuraxla_torch.pipeline.benchmark import run_folder_benchmark

        res = run_folder_benchmark(root=self.work / "tree", config_path=self.config_path, detector="radial",
                                   session=self.session, out_dir=self.work / "out", log=quiet, write_artifacts=False)
        self.passes.append(self.answers(res.rows))
        return len(res.rows)

    def answers(self, rows):
        """A pass's rows as arrays over the files (best distance, species
        index or -1, detected, answered), so that the window keeps no Python
        objects a file."""
        n = len(self.files)
        best, win, det, seen = np.full(n, np.nan), np.full(n, -2), np.zeros(n, bool), np.zeros(n, bool)
        for r in rows:
            i = self.index.get(r["file"])
            if i is None or r["pred_species"] == "ERROR":
                continue
            seen[i] = True
            best[i], det[i] = r["best_distance"], r["detected"]
            win[i] = self.species_index.get(r["pred_species"], -1)
        return best, win, det, seen

    def after_window(self) -> Dict[str, tuple]:
        paths = sorted((f["path"] for f in self.files), key=str)
        t = time.perf_counter()
        for _batch, _n in self.session.decoded_batches(paths):
            pass
        return {"decode_pass": (len(paths), time.perf_counter() - t)}

    def counts(self, win) -> Dict[str, float]:
        b = int(self.wl["session"]["batch_size"])
        n = len(self.files)
        failed = sum(int((~seen).sum()) for *_, seen in self.passes)
        return {"attempted": win.units, "failed": failed, "batches": win.calls * -(-n // b), "chunks": win.units}

    def check(self) -> Dict[str, tuple]:
        d_ref = self.reference_distances()
        return self.worst([compare(best[seen], win[seen], det[seen], int((~seen).sum()), d_ref[seen],
                                   self.thresholds, self.limits()["dist_gap"]) for best, win, det, seen in self.passes])
