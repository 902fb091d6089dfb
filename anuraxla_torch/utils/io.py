"""JSON persistence — a copy of ``anuraxla/utils/io.py:load_json``."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError(f"JSON at {path} is not an object/dict.")
    return obj
