"""What the drivers share: the program's session as a cell's workload file
sets it up, the detector block made from the plain reference, and the
reference's latents in blocks.

A driver generates its traffic from the seed, builds the program's objects
and warms them up (``setup``; with ``program=False`` the inputs, weights and
detector alone, for the control), runs one call of the timed path (``unit``:
a pass, a request or a step; returns the chunks, requests or examples it
completed), times host-only layers after the window in a traced run
(``after_window``), frees the program's state (``release``) and compares
what the timed path produced with the reference (``check``: name ->
(number, limit)).
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from perfbench import synth
from perfbench.reference import encoder as ref_encoder
from perfbench.reference import lowp, mel as ref_mel, radial as ref_radial
from perfbench.reference.audio import rms_normalize

REF_BLOCK = 256  # rows of the reference at a time


def quiet(*_a, **_k) -> None:
    pass


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, work: Path):
        self.cell, self.seed, self.dev, self.work = cell, int(seed), device, Path(work)
        self.cfg, self.mix, self.wl = cell.cfg, cell.mix, cell.workload
        self.params = None
        self.session = None
        self.diag: Dict[str, object] = {}

    # -- the program ------------------------------------------------------
    def mel_config(self):
        from anuraxla_torch.constants import MelConfig

        return MelConfig(**self.cfg["mel"])

    def vae_config(self):
        from anuraxla_torch.models.vae import VAEConfig

        c = self.cfg
        return VAEConfig(latent_dim=c["latent_dim"], widths=tuple(c["widths"]), dense_width=c["dense_width"],
                         groups=c["groups"], input_hw=tuple(c["input_hw"]), conv_padding=c["conv_padding"],
                         gn_eps=c["gn_eps"], activation=c["activation"], downsample=c["downsample"])

    def make_session(self):
        """The program's ``EncoderSession`` with the workload's knobs, loaded with the seed's weights."""
        from anuraxla_torch.pipeline.session import EncoderSession

        s = self.wl["session"]
        return EncoderSession(
            mel=self.mel_config(), batch_size=s["batch_size"], parity=not s["fast_frontend"],
            backend=s["frontend_backend"], encoder_cfg=self.vae_config(), encoder_dtype=s["encoder_dtype"],
            pre_padded_host=s.get("pre_padded_host", False), normalize_on_device=s.get("normalize_on_device", False),
            num_threads=s["io_threads"], device=str(self.dev),
        ).load(params=self.params)

    def make_weights(self) -> None:
        self.params = ref_encoder.make_params(self.cfg, self.seed, self.dev)

    # -- the harness's hooks ----------------------------------------------
    # (module[:Class], attribute, range name): the program's layers a traced
    # run opens a range around, besides the encoder module's forward
    RANGES = ()

    def layer_ranges(self, trace: bool):
        """Ranges the traced run opens around the program's layers."""
        if not trace:
            return contextlib.nullcontext()
        from perfbench.devtrace import layer_ranges

        return layer_ranges(self.session._enc if self.session is not None else None, self.RANGES)

    def after_window(self) -> Dict[str, tuple]:
        return {}

    def release(self) -> None:
        self.session = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------
    def ref_latents(self, rows: Callable[[int, int], np.ndarray], n: int, *, normalize: bool,
                    device: Optional[torch.device] = None, control: bool = False) -> torch.Tensor:
        """The reference's mu [n, D] for rows ``rows(i0, i1)`` (float32 host
        arrays), in blocks; ``control`` computes it in the workload's control
        precisions."""
        dev = device or self.dev
        p = {k: v.to(dev) for k, v in self.params.items()}
        rmel = lowp.ROUNDINGS[self.wl["control"]["mel"]] if control else None
        rtrunk = lowp.ROUNDINGS[self.wl["control"]["trunk"]] if control else None
        out = []
        with torch.no_grad():
            for i0 in range(0, n, REF_BLOCK):
                y = torch.from_numpy(rows(i0, min(n, i0 + REF_BLOCK))).to(dev)
                if normalize:
                    y = rms_normalize(y, self.cfg["rms"])
                with ref_encoder.no_tf32():
                    m = ref_mel.log_mel(y, self.cfg["mel"], self.cfg["standardize_eps"], rounding=rmel)
                out.append(ref_encoder.encode(p, m, self.cfg, rounding=rtrunk)["mu"].cpu())
        return torch.cat(out) if out else torch.zeros((0, self.cfg["latent_dim"]))

    def detector(self, rows: np.ndarray, labels: np.ndarray, *, normalize: bool) -> dict:
        """The detector block both sides read: centroids and radii fitted on
        the reference's latents of a labelled sample, on the host."""
        Z = self.ref_latents(lambda a, b: rows[a:b], rows.shape[0], normalize=normalize,
                             device=torch.device("cpu")).numpy()
        cents, thr = ref_radial.fit(Z, labels, len(synth.SPECIES), float(self.mix["threshold_quantile"]))
        self.centroids, self.thresholds = cents, thr
        return ref_radial.config_block(synth.SPECIES, cents, thr, self.cfg["mel"]["duration"])

    def limits(self) -> Dict[str, float]:
        return self.wl["limits"]

    # -- what a driver's setup defines for these: ``ref_rows(i0, i1)`` (the
    # float32 rows the timed path was asked about, in the order of its
    # answers), ``n_ref`` and ``ref_normalize``
    def reference_distances(self, *, control: bool = False) -> np.ndarray:
        """[n_ref, K] distances of the reference's latents (``control``: of the
        reference in the workload's control precisions) to the centroids."""
        Z = self.ref_latents(self.ref_rows, self.n_ref, normalize=self.ref_normalize, control=control)
        return ref_radial.distances(Z, self.centroids)

    def control_numbers(self) -> Dict[str, float]:
        """The comparison's numbers with the control in the program's place:
        its decisions over every row against the reference's."""
        from perfbench.reference.compare import compare

        d_ref, d_ctl = self.reference_distances(), self.reference_distances(control=True)
        det, win, best = ref_radial.decide(d_ctl, self.thresholds)
        return compare(best, win, det, 0, d_ref, self.thresholds, self.limits()["dist_gap"])

    def worst(self, results) -> Dict[str, tuple]:
        """The compared numbers over several comparisons (one a pass): the
        widest gap, the flips and missing rows summed; ``diag`` keeps the
        largest margin of a differing decision and the share detected."""
        lim = self.limits()
        out = {"dist_gap": 0.0, "decisions_flipped": 0, "rows_missing": 0}
        self.diag = {"flip_margin": 0.0, "detected_share": None, "comparisons": len(results)}
        for res in results:
            out["dist_gap"] = max(out["dist_gap"], res["dist_gap"])
            out["decisions_flipped"] += res["decisions_flipped"]
            out["rows_missing"] += res["rows_missing"]
            self.diag["flip_margin"] = max(self.diag["flip_margin"], res["flip_margin"])
            self.diag["detected_share"] = res["detected_share"]
        if not results:
            out["rows_missing"] = self.n_ref
        return {k: (v, lim[k]) for k, v in out.items()}
