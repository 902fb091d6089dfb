"""Streaming soundscape detection — the port of ``anuraxla/pipeline/stream.py``
(``window_batches``, ``fleet_window_batches``, ``scan_soundscape``,
``scan_soundscapes``, ``extract_detected_chunks``, ``write_detections_csv``):
long recordings cut into overlapping analysis windows, packed into fixed
[B, row_len] batches, encoded and decided on the session's device.

Where every recording is PCM16 mono at the mel rate and nothing normalizes
on the host, the scan cuts its windows on the device instead
(``fleet_span_batches``): each batch's source samples cross the link once,
as int16, and ``ops.window_expand`` cuts the rows there, bit for bit the
host's rows.

The reference caps every input at ``chunk_seconds`` (``map_detector_core.py:
212-217``); here a recording of any length is scanned in place, and a fleet of
recordings shares the device batches (windows tagged by source file).
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from anuraxla_torch.ops.frontend import rms_normalize_np
from anuraxla_torch.ops.window_expand import slot_size, split_slot
from anuraxla_torch.pipeline.benchmark import detector_from_config
from anuraxla_torch.pipeline.dataset import prefetched
from anuraxla_torch.pipeline.session import EncoderSession, HostRing, WindowSpans
from anuraxla_torch.utils.timing import maybe_trace, span, stage_timer
from anuraxla_torch.utils.wavio import WavStream, resample, write_wav


@dataclasses.dataclass
class Detection:
    t_start: float
    t_end: float
    detected: bool
    species: Optional[str]
    score: float  # best_distance (radial) or best_score (map)


def _rms_normalize_rows(batch: np.ndarray) -> None:
    """In-place host normalization with the numpy twin of the device op
    (``ops.frontend.rms_normalize_np``)."""
    out, _ = rms_normalize_np(batch)
    np.copyto(batch, out)


def window_batches(
    stream: WavStream,
    *,
    num_samples: int,
    hop_samples: int,
    batch_size: int,
    target_sr: int,
    normalize: bool = False,
    prefetch: bool = True,
    layout: Optional[tuple[int, int]] = None,
) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Single-recording wrapper over :func:`fleet_window_batches`, yielding
    (batch, starts, n_valid)."""
    for batch, tags, n_valid in fleet_window_batches(
        [stream], num_samples=num_samples, hop_samples=hop_samples,
        batch_size=batch_size, target_sr=target_sr, normalize=normalize,
        prefetch=prefetch, layout=layout,
    ):
        yield batch, tags[:, 1], n_valid


def fleet_window_batches(
    streams: List[WavStream],
    *,
    num_samples: int,
    hop_samples: int,
    batch_size: int,
    target_sr: int,
    normalize: bool = False,
    prefetch: bool = True,
    layout: Optional[tuple[int, int]] = None,
    emit_int16: bool = False,
) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Yield ([B, row_len] float32, tags [B, 2] = (file_idx, start_frame),
    n_valid) over the concatenated window schedule of every recording:
    batches at file boundaries mix windows of adjacent recordings, so the
    device always sees full batches.

    ``layout`` = (row_len, col_offset): each window is written at the mel
    kernel's pre-padded column offset (``ops.mel_kernel.phase_padded_layout``),
    so the device skips its pad. Without it rows are [B, num_samples].
    Resampling (per-file sr) and optional host RMS normalization apply to the
    valid region only. With ``prefetch`` the next batch is extracted on one
    background thread while the caller computes on the current one.

    ``emit_int16``: batches stay raw int16 (``WavStream.read_i16``, bitwise
    what the int16 link would re-quantize). Only honoured when every stream is
    PCM16 mono at target_sr and ``normalize`` is False; otherwise rows are
    float32."""
    emit_int16 = (
        emit_int16
        and not normalize
        and all(st.is_pcm16_mono and st.sr == target_sr for st in streams)
    )
    dtype = np.int16 if emit_int16 else np.float32
    row_len, off = layout if layout is not None else (num_samples, 0)
    sched: List[tuple[int, int]] = []
    for fi, st in enumerate(streams):
        scale = st.sr / target_sr
        src_hop = max(1, int(round(hop_samples * scale)))
        sched.extend(
            (fi, s) for s in range(0, max(st.num_frames - 1, 1), src_hop)
        )

    def load(start: int):
        chunk = sched[start : start + batch_size]
        with span("extract", id=start, windows=len(chunk), on_device=0):
            batch = np.zeros((batch_size, row_len), dtype)
            for j, (fi, s) in enumerate(chunk):
                st = streams[fi]
                if emit_int16:
                    y = st.read_i16(s, num_samples)
                elif st.sr != target_sr:
                    scale = st.sr / target_sr
                    y = resample(st.read(s, int(round(num_samples * scale))),
                                 st.sr, target_sr)
                    y = y[:num_samples]
                    if y.shape[0] < num_samples:
                        y = np.pad(y, (0, num_samples - y.shape[0]))
                else:
                    y = st.read(s, num_samples)
                batch[j, off : off + num_samples] = y
            if normalize:
                _rms_normalize_rows(batch[:, off : off + num_samples])
        return batch, np.asarray(chunk, np.int64).reshape(-1, 2), len(chunk)

    starts = range(0, len(sched), batch_size)
    if not prefetch:
        return (load(s) for s in starts)
    # one worker: every WavStream read stays on one thread, in order
    return prefetched(load, starts)


def takes_spans(streams: List[WavStream], *, target_sr: int, batch_size: int, num_samples: int) -> bool:
    """Whether a fleet's windows can travel as source spans
    (``fleet_span_batches``): every stream PCM16 mono at ``target_sr``, and a
    slot's offsets within int32."""
    return (slot_size(batch_size, batch_size * num_samples) < 2**31
            and all(st.is_pcm16_mono and st.sr == target_sr for st in streams))


def fleet_span_batches(
    streams: List[WavStream],
    *,
    num_samples: int,
    hop_samples: int,
    batch_size: int,
    ring: HostRing,
) -> Iterator[tuple[WindowSpans, np.ndarray, int]]:
    """The batches of :func:`fleet_window_batches` — the same windows, tags
    and ``n_valid`` — for PCM16 mono streams at the target rate
    (``takes_spans``), each as ``WindowSpans`` in a slot of ``ring`` (the
    session's ``span_ring``) instead of [B, row_len] rows.

    The batch's windows are merged into disjoint runs of source samples, per
    file in schedule order (overlapping windows share one run; a hop longer
    than the window leaves one run a window), and the runs copied from each
    file's memmap into the slot, raw int16, each sample once. Ahead of them
    the slot holds the table: each row's offset into the runs and its valid
    length (shorter past EOF; 0 for rows past the batch's windows). The
    device expands the slot into the rows the host route builds
    (``ops.window_expand``). Batches are made on one background thread, one
    ahead; a slot is claimed once the transfer that last read it is done,
    so the consumer sends each batch before it takes the next two."""
    if not all(st.is_pcm16_mono for st in streams):
        raise ValueError("fleet_span_batches needs PCM16 mono streams")
    if ring.shape[0] < slot_size(batch_size, batch_size * num_samples):
        raise ValueError(f"a ring slot of {ring.shape[0]} int16 values cannot hold {batch_size} windows")
    sched = [(fi, s) for fi, st in enumerate(streams) for s in range(0, max(st.num_frames - 1, 1), hop_samples)]

    def load(start: int):
        chunk = sched[start : start + batch_size]
        with span("extract", id=start, windows=len(chunk), on_device=1) as sp:
            runs: List[list] = []  # [file, first sample, end]
            which = []  # each window's run
            for fi, s in chunk:
                stop = min(s + num_samples, streams[fi].num_frames)
                if runs and runs[-1][0] == fi and s <= runs[-1][2]:
                    runs[-1][2] = max(runs[-1][2], stop)
                else:
                    runs.append([fi, s, stop])
                which.append(len(runs) - 1)
            at = np.cumsum([0] + [b - a for _, a, b in runs])  # each run's offset into the runs
            k = ring.claim_slot()
            table, body = (t.numpy() for t in split_slot(ring.bufs[k], batch_size))
            table[:] = 0
            for j, ((fi, s), r) in enumerate(zip(chunk, which)):
                table[j] = (at[r] + s - runs[r][1], min(s + num_samples, streams[fi].num_frames) - s)
            with span("stage", bytes=2 * int(at[-1])):
                for (fi, a, b), p in zip(runs, at):
                    body[p : p + b - a] = streams[fi].read_i16(a, b - a)
            sp["samples"] = int(at[-1])
        tags = np.asarray(chunk, np.int64).reshape(-1, 2)
        return WindowSpans(ring, k, slot_size(batch_size, int(at[-1])), batch_size), tags, len(chunk)

    return prefetched(load, range(0, len(sched), batch_size))


def scan_soundscape(
    wav_path: Path,
    session: EncoderSession,
    *,
    detector: str,
    config: dict,
    hop_seconds: Optional[float] = None,
    normalize: bool = True,
    log=print,
) -> List[Detection]:
    """Scan one long recording; returns per-window detections."""
    per_file, _stats = scan_soundscapes(
        [Path(wav_path)], session, detector=detector, config=config,
        hop_seconds=hop_seconds, normalize=normalize, log=log,
    )
    return next(iter(per_file.values()))


def scan_soundscapes(
    wav_paths: List[Path],
    session: EncoderSession,
    *,
    detector: str,
    config: dict,
    hop_seconds: Optional[float] = None,
    normalize: bool = True,
    log=print,
) -> tuple[dict, dict]:
    """Fleet scan: many long recordings through one loaded session, windows
    of all of them packed into shared fixed-shape device batches (tagged by
    source file).

    Returns ({path: [Detection...]}, stats) with stats carrying n_files /
    total_audio_seconds / wall_seconds / realtime_x (aggregate) / n_windows /
    windows_on_device (the windows cut on the device from source spans:
    all of them or none).
    """
    if session.add_noise_db is not None:
        # the scan dispatches windows directly (no _inject_noise leg), so a
        # noised session would scan clean while its fingerprint claims noised
        raise ValueError(
            "scan_soundscapes does not implement add_noise_db injection; "
            "use a clean session (noise-robustness scans take a noisy "
            "RECORDING, not an injected session)"
        )
    if not normalize and session.normalize_on_device:
        raise ValueError(
            "normalize=False but the session was built with "
            "normalize_on_device=True — its forward would normalize anyway; "
            "build the session without normalize_on_device instead"
        )
    species, chunk_seconds, _score_col, decide = detector_from_config(config, detector, session._dev)
    session.reconfigure(duration=chunk_seconds)

    mel = session.mel
    hop_seconds = hop_seconds if hop_seconds is not None else chunk_seconds
    hop_samples = max(1, int(mel.sr * hop_seconds))

    wav_paths = [Path(p) for p in wav_paths]
    streams = [WavStream(p) for p in wav_paths]
    out: dict = {p: [] for p in wav_paths}
    n_windows = 0

    def emit(res, tags, n_valid, first):
        with span("fetch", id=first, rows=n_valid):
            det, win, best = (x.cpu().numpy() for x in res)
        for j in range(n_valid):
            fi, s = int(tags[j, 0]), int(tags[j, 1])
            t0 = s / streams[fi].sr
            out[wav_paths[fi]].append(
                Detection(
                    t_start=t0,
                    t_end=t0 + chunk_seconds,
                    detected=bool(det[j]),
                    species=(species[int(win[j])] if det[j] and win[j] >= 0 else None),
                    score=float(best[j]),
                )
            )

    # three-way overlap, as in EncoderSession.encode_paths: the prefetch
    # thread extracts (and, without normalize_on_device, normalizes) window
    # batch i+1, the device runs encode + decide for batch i — decide chained
    # after the encode, no host sync between them — and the host fetches
    # batch i−1's decisions. PCM16 mono fleets at the mel rate ship source
    # spans and cut the windows on the device, unless the host normalizes
    # or the batch is split over data shards.
    host_norm = normalize and not session.normalize_on_device
    on_device = (not host_norm and session._mesh is None
                 and takes_spans(streams, target_sr=mel.sr, batch_size=session.batch_size,
                                 num_samples=mel.num_samples))
    if on_device:
        batches = fleet_span_batches(streams, num_samples=mel.num_samples, hop_samples=hop_samples,
                                     batch_size=session.batch_size, ring=session.span_ring())
    else:
        batches = fleet_window_batches(
            streams,
            num_samples=mel.num_samples,
            hop_samples=hop_samples,
            batch_size=session.batch_size,
            target_sr=mel.sr,
            normalize=host_norm,
            layout=session._layout,
            # PCM16-mono sources on an int16 link: ship the raw samples
            emit_int16=session.transfer_int16,
        )
    pending = None
    with maybe_trace("scan_soundscapes"), stage_timer("scan", log=None) as t:
        for batch, tags, n_valid in batches:
            with torch.inference_mode():
                res = decide(session._dispatch(batch))
            if pending is not None:
                emit(*pending)
            pending = (res, tags, n_valid, n_windows)
            n_windows += n_valid
        if pending is not None:
            emit(*pending)
    total_audio = sum(st.duration_seconds for st in streams)
    rate = n_windows / t.seconds if t.seconds > 0 else float("nan")
    realtime = total_audio / max(t.seconds, 1e-9)
    log(
        f"✅ scanned {len(streams)} file(s) / {total_audio / 3600:.2f} h in "
        f"{t.seconds:.1f}s ({n_windows} windows, {rate:.1f} windows/s, "
        f"{realtime:.0f}x realtime aggregate)"
    )
    stats = {
        "n_files": len(streams),
        "total_audio_seconds": total_audio,
        "wall_seconds": t.seconds,
        "realtime_x": realtime,
        "n_windows": n_windows,
        "windows_on_device": n_windows if on_device else 0,
    }
    return out, stats


def extract_detected_chunks(
    wav_path: Path,
    dets: List[Detection],
    out_root: Path,
    *,
    sr: int,
    stem: Optional[str] = None,
    log=print,
) -> int:
    """Write each detected window as a per-species chunk WAV under
    ``out_root/<Species>/`` — a raw field recording turned into the labelled
    chunk-tree layout every fit and benchmark tool reads."""
    stream = WavStream(wav_path)
    stem = stem if stem is not None else Path(wav_path).stem
    n = 0
    for d in dets:
        if not d.detected or d.species is None:
            continue
        out_dir = Path(out_root) / d.species
        out_dir.mkdir(parents=True, exist_ok=True)
        src_start = int(round(d.t_start * stream.sr))
        src_len = int(round((d.t_end - d.t_start) * stream.sr))
        y = stream.read(src_start, src_len)
        if stream.sr != sr:
            y = resample(y, stream.sr, sr)
        ms = int(round(d.t_start * 1000))
        write_wav(out_dir / f"{stem}_t{ms:09d}ms.wav", y, sr, subtype="PCM_16")
        n += 1
    log(f"💾 extracted {n} detected chunks under {out_root}")
    return n


def write_detections_csv(dets: List[Detection], path: Path, score_name: str) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["t_start", "t_end", "detected", "species", score_name])
        for d in dets:
            w.writerow([f"{d.t_start:.3f}", f"{d.t_end:.3f}", d.detected, d.species or "NO_DETECT", f"{d.score:.6f}"])
