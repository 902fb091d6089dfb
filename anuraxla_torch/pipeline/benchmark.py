"""Folder detection benchmark — the port of ``anuraxla/pipeline/benchmark.py``
(``run_folder_benchmark``, ``run_snr_sweep``, ``summarize_rows``,
``write_results_csv``, ``write_summary``): ground truth from directory names,
batched encode and decide on the session's device, CSV / summary / plot
artifacts.

Artifact contract, byte for byte the reference's
(``10_benchmark_folder_detection.py`` / ``10b_..._map.py``):
  <out_dir>/results.csv        file, true_species, pred_species, detected,
                               correct, best_distance|best_score [, error]
  <out_dir>/summary.txt        fixed format, regex-parsed downstream by the
                               Spearman analysis (``9100:53-58``)
  <out_dir>/{confusion_matrix, accuracy_by_class, no_detect_rate_by_class,
             global_counts}.png   (best-effort: a host without matplotlib logs
                               one line)

The whole folder is encoded in fixed-shape device batches
(``EncoderSession.encode_paths``) and decided in one [B, K] op on the
session's device. Files that fail to decode become pred_species="ERROR"
rows, excluded from the metrics (``10:409-418,432``).
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Dict, List

import torch

from anuraxla_torch.config import load_config, priority_ranks, read_map, read_radial
from anuraxla_torch.detect.gaussian_map import map_decide
from anuraxla_torch.detect.radial import radial_decide
from anuraxla_torch.pipeline.dataset import scan_species_tree
from anuraxla_torch.pipeline.session import EncoderSession
from anuraxla_torch.utils.timing import maybe_trace, span, stage_timer

NO_DETECT = "NO_DETECT"
ERROR = "ERROR"


@dataclasses.dataclass
class BenchmarkResult:
    rows: List[dict]
    total: int
    accuracy: float
    no_detect_rate: float
    per_class: Dict[str, dict]
    encode_rate: float = float("nan")  # chunks/s, measured


def detector_from_config(cfg: dict, detector: str, device):
    """-> (species, chunk_seconds, score column, decide): ``decide(Z)`` maps
    [B, D] latents on ``device`` to (detected, winner, best) there, with the
    config's block uploaded once."""
    if detector == "radial":
        species, centroids, thresholds, chunk_seconds = read_radial(cfg)
        cents, thr, ranks = (torch.from_numpy(a).to(device) for a in (centroids, thresholds, priority_ranks(species)))
        return species, chunk_seconds, "best_distance", lambda Z: radial_decide(Z, cents, thr, ranks)
    if detector == "map":
        species, means, precs, lds, priors, tau, chunk_seconds = read_map(cfg)
        arrays = [torch.from_numpy(a).to(device) for a in (means, precs, lds, priors)]
        tau_t = torch.tensor(float("nan") if tau is None else tau, dtype=torch.float32, device=device)
        return species, chunk_seconds, "best_score", lambda Z: map_decide(Z, *arrays, tau_t)
    raise ValueError(f"unknown detector: {detector}")


def run_folder_benchmark(
    *,
    root: Path,
    config_path: Path,
    detector: str,  # "radial" | "map"
    session: EncoderSession,
    out_dir: Path,
    log=print,
    write_artifacts: bool = True,
) -> BenchmarkResult:
    """Benchmark a labelled folder with a loaded session."""
    species, chunk_seconds, score_col, decide = detector_from_config(
        load_config(config_path), detector, session._dev)
    session.reconfigure(duration=chunk_seconds)

    with maybe_trace("folder_benchmark"):
        with span("tree_scan") as s:
            tree = scan_species_tree(root)  # folder name == ground truth
            s["files"] = sum(len(v) for v in tree.values())
        if not any(tree.values()):
            raise RuntimeError(f"no species subfolders with wavs under: {root}")

        all_paths: List[Path] = []
        true_names: List[str] = []
        for sp in sorted(tree):
            for p in tree[sp]:
                all_paths.append(p)
                true_names.append(sp)

        with stage_timer("encode", n_items=len(all_paths), log=None) as t_enc:
            Z, ok, errors = session.encode_paths(all_paths)
        res = decide(torch.from_numpy(Z).to(session._dev))
        with span("fetch", rows=len(all_paths)):
            detected, winner, best = (x.cpu().numpy() for x in res)

    rows: List[dict] = []
    for i, p in enumerate(all_paths):
        if not ok[i]:
            rows.append(
                {
                    "file": str(p),
                    "true_species": true_names[i],
                    "pred_species": ERROR,
                    "detected": False,
                    "correct": False,
                    score_col: float("nan"),
                    "error": errors[i] or "decode failed",
                }
            )
            continue
        pred = species[int(winner[i])] if bool(detected[i]) and winner[i] >= 0 else NO_DETECT
        rows.append(
            {
                "file": str(p),
                "true_species": true_names[i],
                "pred_species": pred,
                "detected": bool(detected[i]),
                "correct": pred == true_names[i],
                score_col: float(best[i]),
            }
        )

    result = summarize_rows(rows, encode_rate=t_enc.rate)

    if write_artifacts:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        write_results_csv(rows, out_dir / "results.csv", score_col)
        ok_rows = [r for r in rows if r["pred_species"] != ERROR]
        write_summary(ok_rows, out_dir / "summary.txt", map_variant=(detector == "map"))
        try:
            from anuraxla_torch.utils.plotting import write_benchmark_plots

            write_benchmark_plots(ok_rows, out_dir, map_variant=(detector == "map"))
        except Exception as e:  # plots are best-effort (no matplotlib, headless hosts)
            log(f"⚠️ plot generation failed: {e}")
        log(f"✅ artifacts in {out_dir}")

    log(
        f"✅ DONE{' (MAP)' if detector == 'map' else ''} | N={result.total} "
        f"| Acc={result.accuracy * 100:.2f}% | NO_DETECT={result.no_detect_rate * 100:.2f}% "
        f"| encode {result.encode_rate:.1f} chunks/s"
    )
    return result


def run_snr_sweep(
    *,
    root: Path,
    config_path: Path,
    detector: str,
    session: EncoderSession,
    out_dir: Path,
    snrs_db: List,  # floats; None = clean
    log=print,
) -> List[dict]:
    """Noise-robustness curve: the folder benchmark at several injected SNRs
    through one session (noise is injected host-side per row, so the device
    path is the same at every point). Writes <out_dir>/<clean|snr_<db>db>/
    per point plus <out_dir>/snr_curve.csv; returns the curve rows."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    curve: List[dict] = []
    for snr in snrs_db:
        session.add_noise_db = None if snr is None else float(snr)
        session._fingerprint = None  # the cache key embeds the noise config
        tag = "clean" if snr is None else f"snr_{snr:g}db"
        log(f"— {tag} —")
        res = run_folder_benchmark(
            root=root, config_path=config_path, detector=detector,
            session=session, out_dir=out_dir / tag, log=log,
        )
        curve.append(
            {
                "snr_db": "" if snr is None else float(snr),
                "accuracy": res.accuracy,
                "no_detect_rate": res.no_detect_rate,
                "n": res.total,
            }
        )
    session.add_noise_db = None
    session._fingerprint = None
    path = out_dir / "snr_curve.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["snr_db", "accuracy", "no_detect_rate", "n"])
        w.writeheader()
        for r in curve:
            w.writerow(r)
    log(f"💾 SNR curve: {path}")
    return curve


def summarize_rows(rows: List[dict], encode_rate: float = float("nan")) -> BenchmarkResult:
    ok_rows = [r for r in rows if r["pred_species"] != ERROR]
    total = len(ok_rows)
    correct = sum(r["correct"] for r in ok_rows)
    no_det = sum(r["pred_species"] == NO_DETECT for r in ok_rows)
    per_class: Dict[str, dict] = {}
    for r in ok_rows:
        d = per_class.setdefault(r["true_species"], {"n": 0, "correct": 0, "no_detect": 0})
        d["n"] += 1
        d["correct"] += int(r["correct"])
        d["no_detect"] += int(r["pred_species"] == NO_DETECT)
    for d in per_class.values():
        d["acc"] = d["correct"] / d["n"] if d["n"] else 0.0
        d["no_detect_rate"] = d["no_detect"] / d["n"] if d["n"] else 0.0
    return BenchmarkResult(
        rows=rows,
        total=total,
        accuracy=(correct / total) if total else 0.0,
        no_detect_rate=(no_det / total) if total else 0.0,
        per_class=per_class,
        encode_rate=encode_rate,
    )


def write_results_csv(rows: List[dict], path: Path, score_col: str) -> None:
    has_error = any("error" in r for r in rows)
    cols = ["file", "true_species", "pred_species", "detected", "correct", score_col]
    if has_error:
        cols.append("error")
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow(r)


def write_summary(ok_rows: List[dict], path: Path, *, map_variant: bool = False) -> None:
    """The exact summary.txt layout downstream regexes parse (``9100:53-58``)."""
    res = summarize_rows(ok_rows)
    correct = sum(r["correct"] for r in ok_rows)
    no_det = sum(r["pred_species"] == NO_DETECT for r in ok_rows)
    lines = [
        f"=== Detection Benchmark Summary{' (MAP)' if map_variant else ''} ===",
        f"Total files: {res.total}",
        f"Correct: {correct}  | Accuracy: {res.accuracy * 100:.2f}%",
        f"NO_DETECT: {no_det} | Rate: {res.no_detect_rate * 100:.2f}%",
        "",
        "=== Per-class ===",
    ]
    by_acc = sorted(res.per_class.items(), key=lambda kv: -kv[1]["acc"])
    for sp, d in by_acc:
        lines.append(
            f"- {sp:30s}  n={d['n']:4d}  acc={d['acc'] * 100:6.2f}%  "
            f"no_detect={d['no_detect_rate'] * 100:6.2f}%"
        )
    Path(path).write_text("\n".join(lines), encoding="utf-8")
