"""``snapshot-from-log`` on the port — a copy of
``anuraxla/cli/snapshot_from_log.py``: extract per-species rk_in/rk_out/rk
from a fit run's log into config_snapshot.json (reference
``9105_make_config_snapshot_from_log.py``; the ✅ line format it parses is
what both packages' fit-radial print).

    python -m anuraxla_torch snapshot-from-log --log run.log --q-in 0.95 --q-out 0.1 --out snap.json
"""

from __future__ import annotations

import argparse
import json
import re
from datetime import datetime
from pathlib import Path

RK_LINE = re.compile(
    r"✅\s+(?P<sp>[\w_]+):\s+rk_in=(?P<rk_in>[0-9.]+)\s+\|\s+rk_out=(?P<rk_out>[0-9.]+|nan)\s+\|\s+rk=(?P<rk>[0-9.]+)"
)


def parse_log(text: str):
    rk, rk_in, rk_out = {}, {}, {}
    for line in text.splitlines():
        m = RK_LINE.search(line)
        if m:
            sp = m.group("sp")
            rk_in[sp] = float(m.group("rk_in"))
            rk_out[sp] = float(m.group("rk_out"))
            rk[sp] = float(m.group("rk"))
    return rk, rk_in, rk_out


def write_snapshot(log_path: Path, out_path: Path, q_in: float, q_out: float) -> dict:
    rk, rk_in, rk_out = parse_log(log_path.read_text(encoding="utf-8", errors="ignore"))
    snapshot = {
        "timestamp": datetime.now().isoformat(),
        "q_in": float(q_in),
        "q_out": float(q_out),
        "rk_in_per_species": rk_in,
        "rk_out_per_species": rk_out,
        "rk_per_species": rk,
        "source_log": str(log_path),
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(snapshot, indent=2), encoding="utf-8")
    return snapshot


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log", required=True, type=str)
    p.add_argument("--q-in", required=True, type=float, dest="q_in")
    p.add_argument("--q-out", required=True, type=float, dest="q_out")
    p.add_argument("--out", required=True, type=str)
    args = p.parse_args(argv)

    log_path = Path(args.log).expanduser().resolve()
    if not log_path.exists():
        raise SystemExit(f"❌ log not found: {log_path}")
    snap = write_snapshot(log_path, Path(args.out).expanduser().resolve(), args.q_in, args.q_out)
    if not snap["rk_per_species"]:
        print("⚠️ WARNING: no rk lines found in the log — check the fit output format.")
    print(f"✅ snapshot written: {args.out}")


if __name__ == "__main__":
    main()
