"""Per-class distance statistics of noised val latents under the fitted
radial detector — the inline diagnostic of the reference's
``scripts/drive_5db_floor.sh:37-70``, run from a fitted project directory.

The val tree is encoded with ``add_noise_db`` = 5 dB (parity frontend on the
mel kernel, bf16 encoder trunk, PCM16 transfer), and for each species the
table gives its radius rk, the median and 10th percentile of the distance to
its own centroid, and the median distance to the nearest other centroid.

    python -m anuraxla_torch.scripts.noise_distance [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from anuraxla_torch.config import load_json
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.pipeline.session import EncoderSession, encode_species_tree

VAL_TREE = Path("latent_space_exploration/val_chunks")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default: the card) or 'cpu' (the kernels' plain versions)")
    args = p.parse_args(argv)

    cfg = load_json(Path("config.json"))
    rd = cfg["radial_detector"]
    species = list(rd["centroids"])
    mel = MelConfig(duration=cfg["chunk_seconds"])
    sess = EncoderSession(mel=mel, encoder_dir=None, project_root=Path("."),
                          parity=True, backend="cuda", device=args.device,
                          encoder_dtype="bfloat16", transfer_int16=True).load()
    sess.add_noise_db = 5.0
    Z_by, _, _ = encode_species_tree(
        sess, VAL_TREE, species,
        cache=False, cache_dir=None, max_per_class=0, seed=0,
        log=lambda *a: None)
    print(f"{'species':34s} {'rk':>7s} {'d_own p50':>10s} {'p10':>8s} "
          f"{'d_best-other p50':>17s}")
    cents = {sp: np.asarray(rd["centroids"][sp], np.float32) for sp in species}
    for sp in species:
        Z = np.asarray(Z_by[sp])
        d_own = np.linalg.norm(Z - cents[sp], axis=1)
        d_other = np.min(np.stack([
            np.linalg.norm(Z - cents[o], axis=1)
            for o in species if o != sp]), axis=0)
        rk = rd["thresholds"][sp]
        print(f"{sp:34s} {rk:7.3f} {np.median(d_own):10.3f} "
              f"{np.percentile(d_own, 10):8.3f} {np.median(d_other):17.3f}")
    print("\nreading: if d_own p10 >> rk for every class, no radius fits 5 dB "
          "(geometry, not threshold); if d_own ~ d_best-other, the classes have "
          "merged at this SNR and only covariance-shaped decisions (MAP) survive.")


if __name__ == "__main__":
    main()
