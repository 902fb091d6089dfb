"""The port's species-tree walk (``anuraxla_torch.pipeline.dataset.scan_species_tree``)
against the JAX package's and against the rglob + ``is_file`` scan the port
used before it: the same dict, the same paths in the same order, the same
strings. Its tree holds nested and hidden entries, ``.WAV`` files, names that
only look like WAVs, an empty species, and (where the platform makes them)
symlinks to a file, to nothing and to a directory, and a symlinked species.
The walk asks no ``stat`` of a plain file: it reads each entry's type from
the directory listing."""

from __future__ import annotations

import os
import pathlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import pytest

from anuraxla.pipeline.dataset import scan_species_tree as jax_scan
from anuraxla_torch.pipeline.dataset import scan_species_tree

EXPLICIT = ["Alpha", "Missing", "stray.wav", "Beta", "Delta", "Gamma"]


def rglob_scan(root: Path, species: Optional[Sequence[str]] = None) -> Dict[str, List[Path]]:
    """The port's scan before the walk: rglob, then a stat a file."""
    root = Path(root)
    if species is None:
        names = [d.name for d in sorted(d for d in root.iterdir() if d.is_dir() and not d.name.startswith("."))]
    else:
        names = list(species)
    out: Dict[str, List[Path]] = {}
    for name in names:
        sp_dir = root / name
        out[name] = (sorted(p for p in sp_dir.rglob("*") if p.is_file() and p.suffix in (".wav", ".WAV"))
                     if sp_dir.exists() else [])
    return out


def touch(p: Path) -> None:
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(b"RIFF")


def make_tree(root: Path, links: bool) -> None:
    for rel in ("Alpha/a1.wav", "Alpha/A2.WAV", "Alpha/.hidden.wav", "Alpha/..wav", "Alpha/.wav",
                "Alpha/sub/deep/b.wav", "Alpha/sub/a.wav", "Alpha/sub.wav/inside.wav", "Alpha/.hid/c.wav",
                "Alpha/x.wav.bak", "Alpha/notes.txt", "Alpha/upper.Wav", "Gamma/g1.wav", "Gamma/z/g2.WAV",
                ".hidden_species/h.wav", "stray.wav"):
        touch(root / rel)
    (root / "Beta").mkdir()
    if links:
        os.symlink(root / "Alpha" / "a1.wav", root / "Gamma" / "to_file.wav")
        os.symlink(root / "Alpha" / "gone.wav", root / "Gamma" / "broken.wav")
        os.symlink(root / "Alpha" / "sub", root / "Gamma" / "to_dir")
        os.symlink(root / "Alpha" / "sub", root / "Gamma" / "dir_link.wav")
        os.symlink(root / "Gamma", root / "Delta")


def can_symlink(tmp: Path) -> bool:
    try:
        os.symlink(tmp / "nowhere", tmp / "probe_link")
    except (OSError, NotImplementedError):
        return False
    os.unlink(tmp / "probe_link")
    return True


@pytest.mark.parametrize("how", ["every_species", "explicit_list", "relative_root"])
@pytest.mark.parametrize("links", [False, True], ids=["plain", "symlinks"])
def test_walk_matches_jax_and_rglob(tmp_path, monkeypatch, links, how):
    if links and not can_symlink(tmp_path):
        pytest.skip("this platform cannot make symlinks")
    make_tree(tmp_path / "tree", links)
    root: object = tmp_path / "tree"
    species = EXPLICIT if how == "explicit_list" else None
    if how == "relative_root":
        monkeypatch.chdir(tmp_path)
        root = "tree/"
    got = scan_species_tree(root, species)
    want = rglob_scan(root, species)
    assert got == jax_scan(root, species) == want
    assert list(got) == list(want)
    assert {k: [str(p) for p in v] for k, v in got.items()} == {k: [str(p) for p in v] for k, v in want.items()}
    assert all(type(p) is type(q) for k in got for p, q in zip(got[k], want[k]))

    alpha = ["a1.wav", "A2.WAV", ".hidden.wav", "..wav", "sub/deep/b.wav", "sub/a.wav", "sub.wav/inside.wav",
             ".hid/c.wav"]
    assert sorted(str(p.relative_to(Path(root) / "Alpha")) for p in got["Alpha"]) == sorted(alpha)
    assert got["Beta"] == []
    assert [p.name for p in got["Gamma"]] == (["g1.wav", "to_file.wav", "g2.WAV"] if links else ["g1.wav", "g2.WAV"])
    if species is None:
        assert list(got) == (["Alpha", "Beta", "Delta", "Gamma"] if links else ["Alpha", "Beta", "Gamma"])
    else:
        assert got["Missing"] == got["stray.wav"] == [] and got["Delta"] == (
            [Path(root) / "Delta" / p.relative_to(Path(root) / "Gamma") for p in got["Gamma"]] if links else [])


def test_walk_asks_no_stat_of_a_plain_file(tmp_path, monkeypatch):
    root = tmp_path / "tree"
    for sp in ("A", "B"):
        for i in range(6):
            touch(root / sp / f"c{i}.wav")
        touch(root / sp / "nested" / "d.wav")
    want = rglob_scan(root)

    def refuse(*_a, **_k):
        raise AssertionError("a stat was asked")

    for name in ("is_file", "is_dir", "exists", "stat", "lstat"):
        monkeypatch.setattr(pathlib.Path, name, refuse)
    monkeypatch.setattr(os, "stat", refuse)
    monkeypatch.setattr(os, "lstat", refuse)
    counts: Dict[str, int] = {}
    got = scan_species_tree(root, counts=counts)
    monkeypatch.undo()
    assert got == want and [str(p) for p in got["A"]] == [str(p) for p in want["A"]]
    # two species directories and their two subdirectories; each lists 6 files and 1 directory, then 1 file
    assert counts == {"dirs": 4, "entries": 2 * (7 + 1), "followed": 0}


def test_walk_counts_the_symlinks_it_follows(tmp_path):
    if not can_symlink(tmp_path):
        pytest.skip("this platform cannot make symlinks")
    make_tree(tmp_path / "tree", links=True)
    counts: Dict[str, int] = {}
    scan_species_tree(tmp_path / "tree", ["Gamma"], counts=counts)
    # Gamma: g1.wav, z, and four links; z: g2.WAV
    assert counts == {"dirs": 2, "entries": 7, "followed": 4}
