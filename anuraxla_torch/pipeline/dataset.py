"""Folder scanning and batched WAV loading — the port of
``anuraxla/pipeline/dataset.py`` (``scan_species_tree``, ``subsample_paths``,
``LoadedBatch``, ``load_wav_batch``, ``iter_batches``).

Decoding takes the C++ batch decoder (``native/wavloader.py``, built with
``g++`` at first use) and falls back to the pure-Python reader
(``utils.wavio``, on a thread pool) where it cannot be built or
``use_native=False``; ``load_wav_batch.routes`` counts the batches each route
decoded. Rows can be decoded straight into the pre-padded layout the mel
kernel reads (``layout=``) and into a buffer the caller owns (``out=``, the
session's pinned host slot): the decoder copies into a preallocated row
either way, so neither costs the host a further copy.
"""

from __future__ import annotations

import random as pyrandom
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from anuraxla_torch.native import wavloader
from anuraxla_torch.utils.timing import span
from anuraxla_torch.utils.wavio import crop_or_pad_samples, read_wav


def scan_species_tree(root: Path, species: Optional[Sequence[str]] = None) -> Dict[str, List[Path]]:
    """root/<Species>/*.wav -> {species: sorted wav paths}. With an explicit
    species list only those subdirs are read (absent ones map to []);
    otherwise every non-hidden subdir is a class. Recurses and accepts
    .wav/.WAV."""
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


def subsample_paths(wavs: List[Path], max_per_class: int, rng: pyrandom.Random) -> List[Path]:
    """``rng.sample`` of the sorted list when it exceeds ``max_per_class`` —
    the reference's draw, so one seeded ``random.Random`` consumed species by
    species picks the same files in both packages."""
    if max_per_class and len(wavs) > max_per_class:
        return rng.sample(wavs, max_per_class)
    return wavs


class LoadedBatch(NamedTuple):
    audio: np.ndarray  # [B, L] float32 (failed rows zeroed)
    ok: np.ndarray  # [B] bool
    errors: List[Optional[str]]  # per-row error message or None


def load_wav_batch(
    paths: Sequence[Path],
    *,
    sr: int,
    num_samples: int,
    num_threads: int = 16,
    use_native: bool = True,
    layout: Optional[Tuple[int, int]] = None,
    out: Optional[np.ndarray] = None,
) -> LoadedBatch:
    """Decode a list of WAVs into a fixed [len(paths), row_len] array.

    Failures (missing/corrupt files) zero their row's samples and set
    ok=False — the batched analogue of the reference's per-file try/except
    counters.

    ``layout=(row_len, col_offset)``: each file's samples go at
    ``col_offset`` of a row of ``row_len`` (the mel kernel's pre-padded
    layout, ``ops.mel_kernel.phase_padded_layout``). ``out``: decode into
    this float32 [len(paths), row_len] C-contiguous array instead of a new
    zeroed one; its columns outside the sample window must be zero and stay
    untouched.
    """
    n = len(paths)
    row_len, col_off = layout if layout is not None else (num_samples, 0)
    if col_off < 0 or col_off + num_samples > row_len:
        raise ValueError(f"layout {layout} cannot hold {num_samples} samples")
    if out is None:
        out = np.zeros((n, row_len), np.float32)
    elif out.shape != (n, row_len) or out.dtype != np.float32:
        raise ValueError(f"out must be float32 {(n, row_len)}, got {out.dtype} {out.shape}")

    with span("decode", files=n) as sp:
        if use_native and wavloader.available():
            ok, errors = wavloader.decode_into(paths, out, sr=sr, num_samples=num_samples, col_offset=col_off,
                                               num_threads=num_threads)
            route = "native"
        else:
            ok, errors = _decode_python(paths, out, sr, num_samples, col_off, num_threads)
            route = "python"
        sp["failed"] = n - int(np.count_nonzero(ok))
    load_wav_batch.routes[route] += 1
    return LoadedBatch(out, ok, errors)


def _decode_python(paths, out: np.ndarray, sr: int, num_samples: int, col_off: int,
                   num_threads: int) -> Tuple[np.ndarray, List[Optional[str]]]:
    """The pure-Python route of ``load_wav_batch``: ``utils.wavio`` on a
    thread pool, each file into its row of ``out``."""
    n = len(paths)
    ok = np.zeros(n, bool)
    errors: List[Optional[str]] = [None] * n

    def work(i: int):
        window = out[i, col_off : col_off + num_samples]
        try:
            y, _ = read_wav(paths[i], sr=sr, mono=True)
            window[:] = crop_or_pad_samples(y, num_samples)
            ok[i] = True
        except Exception as e:  # noqa: BLE001 — per-file isolation by design
            window[:] = 0.0
            errors[i] = f"{type(e).__name__}: {e}"

    if n:
        with ThreadPoolExecutor(max_workers=min(num_threads, n)) as ex:
            list(ex.map(work, range(n)))
    return ok, errors


load_wav_batch.routes = {"native": 0, "python": 0}  # batches decoded by each route


def iter_batches(
    paths: Sequence[Path],
    *,
    sr: int,
    num_samples: int,
    batch_size: int,
    num_threads: int = 16,
    use_native: bool = True,
    layout: Optional[Tuple[int, int]] = None,
    transform=None,
    buffers: Optional[Callable[[], np.ndarray]] = None,
) -> Iterator[Tuple[LoadedBatch, int]]:
    """Yield (batch, n_valid_rows) with the last batch zero-padded to
    ``batch_size``, decoding the next batch on a background thread while the
    caller works on the current one. ``transform(audio, start, n_valid) ->
    audio`` (optional) runs on the prefetch thread; ``start`` is the batch's
    global row offset in ``paths``. ``buffers()`` (optional) hands out the
    float32 [batch_size, row_len] array each batch is decoded into, called
    on the prefetch thread in batch order (the session's pinned slots); by
    default each batch gets a new zeroed array."""
    row_len = layout[0] if layout is not None else num_samples

    def load(start: int) -> Tuple[LoadedBatch, int]:
        chunk = list(paths[start : start + batch_size])
        n_valid = len(chunk)
        rows = buffers() if buffers is not None else np.zeros((batch_size, row_len), np.float32)
        b = load_wav_batch(chunk, sr=sr, num_samples=num_samples, num_threads=num_threads,
                           use_native=use_native, layout=layout, out=rows[:n_valid])
        if n_valid < batch_size:
            rows[n_valid:] = 0.0
        b = LoadedBatch(rows, np.concatenate([b.ok, np.zeros(batch_size - n_valid, bool)]),
                        b.errors + [None] * (batch_size - n_valid))
        if transform is not None:
            b = b._replace(audio=transform(b.audio, start, n_valid))
        return b, n_valid

    return prefetched(load, range(0, len(paths), batch_size))


def prefetched(load: Callable, starts: Sequence[int]) -> Iterator:
    """``load(s)`` for each ``s`` of ``starts`` in order, the next one run on
    one background thread while the caller works on the current one (a
    single start runs inline). The caller's wait for each is an
    ``input_wait`` span whose ``id`` is its start, a batch's first row."""
    starts = list(starts)
    if len(starts) <= 1:
        yield from (load(s) for s in starts)
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(load, starts[0])
        for i, s in enumerate(starts):
            with span("input_wait", id=s):
                cur = fut.result()
            if i + 1 < len(starts):
                fut = ex.submit(load, starts[i + 1])
            yield cur
