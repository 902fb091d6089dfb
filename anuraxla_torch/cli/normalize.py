"""``normalize`` on the port — RMS-normalize chunk datasets (the reference's
``00_normalize_dataset_rms.py``, as ``anuraxla/cli/normalize.py``): clone
``{train,val,test}_chunks/`` to ``*_norm/`` with RMS -> 0.05, silence gate
1e-4 (silent files copied unscaled), clip to [-1, 1]. Equal-length files of a
species are normalized as one [B, L] op (``ops.frontend.rms_normalize_batch``)
on the card unless ``--device cpu``.

    python -m anuraxla_torch normalize --base-dir latent_space_exploration
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.cli.common import add_device_arg
from anuraxla_torch.ops.frontend import rms_normalize_batch
from anuraxla_torch.pipeline.dataset import scan_species_tree
from anuraxla_torch.utils.timing import stage_timer
from anuraxla_torch.utils.wavio import read_wav, write_wav


def _normalize(batch: np.ndarray, device: torch.device) -> np.ndarray:
    out, _ = rms_normalize_batch(torch.from_numpy(batch).to(device))
    return out.cpu().numpy()


def process_split(src: Path, dst: Path, sr: int, batch_size: int, log=print, device="cuda") -> int:
    dev = resolve_device(device)
    tree = scan_species_tree(src)
    n_done = 0
    for sp, wavs in tree.items():
        sp_src = src / sp

        def out_path(w: Path) -> Path:
            # preserve nested structure: the scanner recurses, so bare names
            # from different subdirs must not collide in the output
            p = dst / sp / w.relative_to(sp_src)
            p.parent.mkdir(parents=True, exist_ok=True)
            return p

        # variable-length files: batch equal-length runs, else one file at a time
        n_fail = 0
        for i in range(0, len(wavs), batch_size):
            ys, good = [], []
            for w in wavs[i : i + batch_size]:
                try:
                    y, _ = read_wav(w, sr=sr, mono=True)
                    ys.append(y)
                    good.append(w)
                except Exception as e:  # per-file isolation, like every stage
                    n_fail += 1
                    log(f"  ⚠️ {w.name}: {type(e).__name__}: {e}")
            if not good:
                continue
            if len({len(y) for y in ys}) == 1:
                out = _normalize(np.stack(ys), dev)
                for j, w in enumerate(good):
                    write_wav(out_path(w), out[j], sr, subtype="PCM_16")
            else:
                for y, w in zip(ys, good):
                    write_wav(out_path(w), _normalize(y[None], dev)[0], sr, subtype="PCM_16")
            n_done += len(good)
        suffix = f" (failed={n_fail})" if n_fail else ""
        log(f"  {src.name}/{sp}: {len(wavs)} files{suffix}")
    return n_done


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base-dir", type=str, default="latent_space_exploration")
    p.add_argument("--sr", type=int, default=48000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--sets", nargs="*", default=["train_chunks", "val_chunks", "test_chunks"])
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(args.device)

    base = Path(args.base_dir).resolve()
    total = 0
    for s in args.sets:
        src, dst = base / s, base / f"{s}_norm"
        if not src.exists():
            print(f"⚠ missing {src}")
            continue
        print(f"\nnormalizing {s} → {s}_norm")
        with stage_timer(f"normalize[{s}]"):
            total += process_split(src, dst, args.sr, args.batch_size, device=args.device)
    print(f"\n✅ normalized dataset ready ({total} files).")


if __name__ == "__main__":
    main()
