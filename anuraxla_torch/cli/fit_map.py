"""``fit-map`` on the port — fit the Gaussian MAP (LDA/QDA) detector (the
reference's ``08b_fit_map_detector.py`` contract, as
``anuraxla/cli/fit_map.py``: same flags, ``--preset small-n``, the same
config.json block). Encoding and the fit run on the card unless
``--device cpu``.

    python -m anuraxla_torch.cli.fit_map --root train_chunks --cov-type qda --preset small-n --set-tau-q 0.01
"""

from __future__ import annotations

import argparse

from anuraxla_torch.cli.fit_radial import add_fit_args, fit_setup, parse_augment
from anuraxla_torch.pipeline.fit import fit_map_tree


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_fit_args(p)
    p.add_argument("--cov-type", type=str, default="lda", choices=["lda", "qda"])
    # None sentinels so --preset can tell "user said full/0.0" from "default"
    p.add_argument("--cov-structure", type=str, default=None, choices=["full", "diag"])
    p.add_argument("--priors", type=str, default="empirical", choices=["empirical", "uniform"])
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--shrink", type=float, default=None)
    p.add_argument("--set-tau-q", type=float, default=None,
                   help="e.g. 0.01 => tau = quantile(train true-class scores, 0.01)")
    p.add_argument(
        "--preset", type=str, default=None, choices=["small-n"],
        help="small-n: diag covariance + shrink 0.1, for classes with fewer samples than latent dims "
        "(a full pooled covariance then overfits so hard that a train-score tau rejects every val "
        "chunk). Explicit --cov-structure/--shrink flags override the preset values.",
    )
    return p


def resolve_preset(args) -> tuple[str, float, list[str]]:
    """(cov_structure, shrink, notes) after applying --preset small-n.
    Explicit user flags always win over preset values."""
    notes: list[str] = []
    cov_structure = args.cov_structure
    shrink = args.shrink
    if args.preset == "small-n":
        if cov_structure is None:
            cov_structure = "diag"
            notes.append("preset small-n: cov_structure=diag")
        if shrink is None:
            shrink = 0.1
            notes.append("preset small-n: shrink=0.1")
        if args.set_tau_q is None:
            notes.append(
                "preset small-n: consider --set-tau-q 0.01 — without tau the "
                "detector never rejects (NO_DETECT disabled)"
            )
    return (
        cov_structure if cov_structure is not None else "full",
        shrink if shrink is not None else 0.0,
        notes,
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cov_structure, shrink, preset_notes = resolve_preset(args)
    if not (0.0 <= shrink <= 1.0):
        raise SystemExit("❌ --shrink must be in [0,1].")
    if args.set_tau_q is not None and not (0.0 < float(args.set_tau_q) < 1.0):
        raise SystemExit("❌ --set-tau-q must be in (0,1).")
    cfg_path, cfg, chunks_dir, session, cache_dir = fit_setup(args)
    print(
        f"🎯 cov_type={args.cov_type} | cov_structure={cov_structure} | "
        f"priors={args.priors} | eps={args.eps} | shrink={shrink}"
    )
    print(f"🎯 max_per_class={args.max_per_class} | cache={args.cache}")
    for note in preset_notes:
        print(f"🧩 {note}")
    print()
    fit_map_tree(
        cfg_path=cfg_path, cfg=cfg, chunks_dir=chunks_dir, session=session.load(),
        cov_type=args.cov_type, cov_structure=cov_structure, priors_mode=args.priors,
        eps=args.eps, shrink=shrink, tau_q=args.set_tau_q,
        cache=args.cache, cache_dir=cache_dir,
        max_per_class=args.max_per_class, seed=args.seed,
        augment_noise_db=parse_augment(args.augment_noise_db),
    )


if __name__ == "__main__":
    main()
