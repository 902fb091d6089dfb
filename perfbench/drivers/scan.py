"""Fleet scans: long recordings with planted calls, each pass the whole fleet
through ``pipeline.stream.scan_soundscapes`` (window extraction on the
prefetch thread, windows of all recordings packed into shared batches,
host -> device, per-window RMS normalization, mel, encoder, radial
decision). A unit is one pass; it completes one chunk a window."""

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


def schedule(n_samples: int, hop: int):
    """Window starts of one recording: every ``hop`` samples from 0 while the
    start lies before the last sample."""
    return list(range(0, max(n_samples - 1, 1), hop))


class Driver(Base):
    RANGES = (("anuraxla_torch.utils.wavio:WavStream", "read", "perfbench::extract_read"),
              ("anuraxla_torch.pipeline.stream", "_rms_normalize_rows", "perfbench::host_rms"),
              ("anuraxla_torch.pipeline.session:EncoderSession", "_dispatch", "perfbench::dispatch"))

    def setup(self, program: bool = True) -> None:
        mel = self.cfg["mel"]
        self.L = int(mel["sr"] * mel["duration"])
        self.hop = int(mel["sr"] * float(self.mix["hop_seconds"]))
        self.recs = synth.soundscapes(self.work / "recs", self.mix, self.seed, self.dev, sr=mel["sr"])
        self.paths = [r["path"] for r in self.recs]
        self.make_weights()
        self.samples = [ref_audio.pcm16_data(p) for p in self.paths]
        self.starts = [schedule(r["samples"], self.hop) for r in self.recs]
        self.windows = [(fi, s) for fi, starts in enumerate(self.starts) for s in starts]
        self.species_index = {s: i for i, s in enumerate(synth.SPECIES)}
        cal, labels = self.calibration_windows()
        rows = np.stack([ref_audio.window(self.samples[fi], s, self.L) for fi, s in cal])
        self.config = self.detector(rows, labels, normalize=True)
        (self.work / "config.json").write_text(json.dumps(self.config))
        os.sync()  # the inputs reach the disk in set-up, not under the window
        self.ref_rows = lambda a, b: np.stack([ref_audio.window(self.samples[fi], s, self.L)
                                               for fi, s in self.windows[a:b]])
        self.n_ref, self.ref_normalize = len(self.windows), True
        self.passes = []
        if not program:
            return
        self.session = self.make_session()
        for _ in range(int(self.wl.get("warmup_calls", 1))):
            self.unit()
        self.passes.clear()

    def calibration_windows(self):
        """The first windows of each species (in schedule order) that hold at
        least ``calibration_overlap_s`` of one of its planted calls."""
        need = int(self.cfg["mel"]["sr"] * float(self.mix["calibration_overlap_s"]))
        call_n = int(self.cfg["mel"]["sr"] * float(self.mix["call_seconds"]))
        per = int(self.mix["calibration_per_species"])
        picked = {k: [] for k in range(len(synth.SPECIES))}
        for fi, s in self.windows:
            for k, start in self.recs[fi]["plants"]:
                if len(picked[k]) < per and min(s + self.L, start + call_n) - max(s, start) >= need:
                    picked[k].append((fi, s))
                    break
        if any(len(v) < per for v in picked.values()):
            raise RuntimeError(f"too few windows hold a call: {[len(v) for v in picked.values()]}")
        return [w for k in picked for w in picked[k]], np.repeat(np.arange(len(picked)), per)

    def unit(self) -> int:
        from anuraxla_torch.pipeline.stream import scan_soundscapes

        per_file, stats = scan_soundscapes(self.paths, self.session, detector="radial", config=self.config,
                                           hop_seconds=float(self.mix["hop_seconds"]), normalize=True, log=quiet)
        self.passes.append(self.answers(per_file))
        return int(stats["n_windows"])

    def answers(self, per_file):
        """A pass's detections as arrays over the windows (best distance,
        species index or -1, detected, answered at the right start), so that
        the window keeps no Python objects a window."""
        sr = self.cfg["mel"]["sr"]
        best, win, det, seen = [], [], [], []
        for fi, p in enumerate(self.paths):
            got = per_file.get(p, [])
            want = self.starts[fi]
            ok = len(got) == len(want) and all(abs(d.t_start - s / sr) <= 0.5 / sr for d, s in zip(got, want))
            seen += [ok] * len(want)
            for d in (got if ok else []):
                best.append(d.score)
                det.append(d.detected)
                win.append(self.species_index.get(d.species, -1) if d.detected else -1)
        return np.array(best), np.array(win, int), np.array(det, bool), np.array(seen, bool)

    def after_window(self) -> Dict[str, tuple]:
        from anuraxla_torch.pipeline.stream import fleet_window_batches
        from anuraxla_torch.utils.wavio import WavStream

        s, mel = self.session, self.session.mel
        t = time.perf_counter()
        n = 0
        for _batch, _tags, n_valid in fleet_window_batches(
                [WavStream(p) for p in self.paths], num_samples=mel.num_samples, hop_samples=self.hop,
                batch_size=s.batch_size, target_sr=mel.sr, normalize=not s.normalize_on_device, layout=s._layout):
            n += n_valid
        return {"extract_pass": (n, time.perf_counter() - t)}

    def counts(self, win) -> Dict[str, float]:
        b = int(self.wl["session"]["batch_size"])
        return {"attempted": win.units, "failed": 0, "batches": win.calls * -(-len(self.windows) // b),
                "chunks": win.units}

    def check(self) -> Dict[str, tuple]:
        d_ref = self.reference_distances()
        return self.worst([compare(best, win, det, int((~seen).sum()), d_ref[seen], self.thresholds,
                                   self.limits()["dist_gap"]) for best, win, det, seen in self.passes])
