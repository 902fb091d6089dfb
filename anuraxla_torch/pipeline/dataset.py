"""Batched WAV loading — the port of ``anuraxla/pipeline/dataset.py``
(``LoadedBatch``, ``load_wav_batch``, ``iter_batches``).

Decoding here is the pure-Python reader (``utils.wavio``) on a thread pool;
the C++ batch decoder the reference can use (``anuraxla/native``) is not
ported yet and comes in a later slice. Rows can be decoded straight into the
pre-padded layout the mel kernel reads (``layout=``), which costs the host
nothing: the reader copies into a preallocated row either way.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from anuraxla_torch.utils.wavio import crop_or_pad_samples, read_wav


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
    layout: Optional[Tuple[int, int]] = None,
) -> LoadedBatch:
    """Decode a list of WAVs into a fixed [len(paths), row_len] array.

    Failures (missing/corrupt files) zero their row and set ok=False — the
    batched analogue of the reference's per-file try/except counters.

    ``layout=(row_len, col_offset)``: decode into zeroed rows of ``row_len``
    samples with the file's samples at ``col_offset`` (the mel kernel's
    pre-padded layout, ``ops.mel_kernel.phase_padded_layout``).
    """
    n = len(paths)
    row_len, col_off = layout if layout is not None else (num_samples, 0)
    if col_off < 0 or col_off + num_samples > row_len:
        raise ValueError(f"layout {layout} cannot hold {num_samples} samples")
    audio = np.zeros((n, row_len), np.float32)
    ok = np.zeros(n, bool)
    errors: List[Optional[str]] = [None] * n

    def work(i: int):
        try:
            y, _ = read_wav(paths[i], sr=sr, mono=True)
            audio[i, col_off : col_off + num_samples] = crop_or_pad_samples(y, num_samples)
            ok[i] = True
        except Exception as e:  # noqa: BLE001 — per-file isolation by design
            errors[i] = f"{type(e).__name__}: {e}"

    if n:
        with ThreadPoolExecutor(max_workers=min(num_threads, n)) as ex:
            list(ex.map(work, range(n)))
    return LoadedBatch(audio, ok, errors)


def iter_batches(
    paths: Sequence[Path],
    *,
    sr: int,
    num_samples: int,
    batch_size: int,
    num_threads: int = 16,
    layout: Optional[Tuple[int, int]] = None,
    transform=None,
) -> Iterator[Tuple[LoadedBatch, int]]:
    """Yield (batch, n_valid_rows) with the last batch zero-padded to
    ``batch_size``, decoding the next batch on a background thread while the
    caller works on the current one. ``transform(audio, start, n_valid) ->
    audio`` (optional) runs on the prefetch thread; ``start`` is the batch's
    global row offset in ``paths``."""
    chunks = [list(paths[i : i + batch_size]) for i in range(0, len(paths), batch_size)]
    row_len = layout[0] if layout is not None else num_samples

    def load(chunk: List[Path], start: int) -> Tuple[LoadedBatch, int]:
        b = load_wav_batch(chunk, sr=sr, num_samples=num_samples,
                           num_threads=num_threads, layout=layout)
        n_valid = len(chunk)
        if n_valid < batch_size:
            pad = batch_size - n_valid
            b = LoadedBatch(
                np.concatenate([b.audio, np.zeros((pad, row_len), np.float32)]),
                np.concatenate([b.ok, np.zeros(pad, bool)]),
                b.errors + [None] * pad,
            )
        if transform is not None:
            b = b._replace(audio=transform(b.audio, start, n_valid))
        return b, n_valid

    starts = list(range(0, len(paths), batch_size))
    if len(chunks) <= 1:
        for c, s in zip(chunks, starts):
            yield load(c, s)
        return

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(load, chunks[0], 0)
        for nxt, s in zip(chunks[1:], starts[1:]):
            cur = fut.result()
            fut = ex.submit(load, nxt, s)
            yield cur
        yield fut.result()
