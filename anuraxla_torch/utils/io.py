"""JSON persistence and project-root discovery — a copy of
``anuraxla/utils/io.py`` (``find_project_root``, ``load_json``,
``save_json``, ``save_json_with_backup``, ``resolve_root_dir``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict


def find_project_root(start: Path) -> Path:
    """Walk up from ``start`` to the project root: a directory holding the
    reference's ``downloaded_models/`` + ``latent_space_exploration/``, or a
    ``config.json`` next to a ``models/``, ``anuraxla`` or
    ``latent_space_exploration`` dir; ``start`` itself if none is found."""
    cur = Path(start).resolve()
    for _ in range(15):
        if (cur / "downloaded_models").exists() and (cur / "latent_space_exploration").exists():
            return cur
        if (cur / "config.json").exists() and (
            (cur / "models").exists() or (cur / "anuraxla").exists() or (cur / "latent_space_exploration").exists()
        ):
            return cur
        if cur.parent == cur:
            break
        cur = cur.parent
    return Path(start).resolve()


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError(f"JSON at {path} is not an object/dict.")
    return obj


def save_json(path: Path, obj: Dict[str, Any]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, ensure_ascii=False)


def save_json_with_backup(path: Path, obj: Dict[str, Any]) -> Path:
    """Write ``obj`` to ``path``, first copying any existing file to
    ``<path>.bak`` (the reference's behaviour before every config overwrite)."""
    path = Path(path)
    backup = path.with_suffix(path.suffix + ".bak")
    if path.exists():
        shutil.copy2(path, backup)
    save_json(path, obj)
    return backup


def resolve_root_dir(root_arg: str, project_root: Path) -> Path:
    """--root resolution: absolute as-is, else the first existing dir of the
    working directory, the project root and project_root/latent_space_exploration."""
    root_in = Path(root_arg).expanduser()
    if root_in.is_absolute():
        candidates = [root_in]
    else:
        candidates = [Path.cwd() / root_in, project_root / root_in, project_root / "latent_space_exploration" / root_in]
    for cand in candidates:
        cand = cand.resolve()
        if cand.exists() and cand.is_dir():
            return cand
    tried = "\n".join(f"   - {c.resolve()}" for c in candidates)
    raise SystemExit(f"❌ chunks dir not found. Tried:\n{tried}")
