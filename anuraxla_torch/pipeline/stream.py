"""Streaming soundscape detection — the port of ``anuraxla/pipeline/stream.py``
(``window_batches``, ``fleet_window_batches``, ``scan_soundscape``,
``scan_soundscapes``, ``extract_detected_chunks``, ``write_detections_csv``):
long recordings cut into overlapping analysis windows, packed into fixed
[B, row_len] batches, encoded and decided on the session's device.

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
from anuraxla_torch.pipeline.benchmark import detector_from_config
from anuraxla_torch.pipeline.dataset import prefetched
from anuraxla_torch.pipeline.session import EncoderSession
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
        with span("extract", id=start, windows=len(chunk)):
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
    total_audio_seconds / wall_seconds / realtime_x (aggregate) / n_windows.
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
    # batch i−1's decisions
    host_norm = normalize and not session.normalize_on_device
    pending = None
    with maybe_trace("scan_soundscapes"), stage_timer("scan", log=None) as t:
        for batch, tags, n_valid in fleet_window_batches(
            streams,
            num_samples=mel.num_samples,
            hop_samples=hop_samples,
            batch_size=session.batch_size,
            target_sr=mel.sr,
            normalize=host_norm,
            layout=session._layout,
            # PCM16-mono sources on an int16 link: ship the raw samples
            emit_int16=session.transfer_int16,
        ):
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
