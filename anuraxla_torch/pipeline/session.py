"""Load-once inference session: wav rows -> latents on the card — the port
of ``anuraxla/pipeline/session.py`` (``EncoderSession``, the fingerprints,
``encode_species_tree`` and the latent helpers).

The served path: ``encode_paths`` decodes each batch (native decoder, on a
prefetch thread) straight into a slot of the session's host ring — pinned
buffers on a card, in the mel kernel's pre-padded layout when
``pre_padded_host`` is set — and sends that slot to the device with a
non-blocking copy; no host copy lies between decoder and link. The device
computes the fused RMS scale over the valid slice, the log-mel frontend
(``backend="cuda"`` / ``"cuda-bf16"``: a Hopper mel kernel;
``parity=False``: the crop-first fast frontend), and the encoder's ``mu``
(``quantize=True``: int8 conv / dense contractions, ``models.quant``, with
weights quantized once at ``load`` and activation scales taken per row).
Two batches are in flight: batch i−1's latents are fetched only after batch
i is dispatched, while batch i+1 decodes. ``encode_array`` copies its rows
into a slot (PCM16-converted with ``transfer_int16``). A fleet scan of PCM16
recordings hands ``_dispatch`` its batches as ``WindowSpans`` instead: a
slot of the session's int16 span ring holding each batch's source samples
once, which one kernel expands into the rows on the device
(``ops.window_expand``).

``data_parallel=True`` splits each batch over this process's data shards
(``parallel.mesh.make_mesh(local=True)``: the visible cards;
``set_default_devices`` for others — encode stays process-local under a
process group too): ``batch_size`` is rounded up to a multiple of the shard count, each
shard's rows of the host slot go to its device, and each device runs the
forward with its own replica of the encoder; ragged batches are padded with
zero rows and the latents sliced back. With one shard (one card, or the CPU)
the session is the single-device path.

Weights: ``load(params=state_dict)``, else the encoder artifact
(``encoder_dir``, else ``<project_root>/models/anuraxla_vae_encoder_v0``;
``models.checkpoint``), else a seeded random init (``init_seed``), with a
warning.

``session_fingerprint`` is the latent-cache key: everything that changes
latents, plus a framework tag so that no key of this package equals one of
the JAX package (both name a ``matmul`` backend).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import random as pyrandom
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.constants import CACHE_DIR_NAME, MelConfig
from anuraxla_torch.models.checkpoint import load_or_init_encoder
from anuraxla_torch.models.quant import encoder_apply_quantized, quantize_encoder
from anuraxla_torch.models.vae import ConvVAEEncoder, VAEConfig
from anuraxla_torch.ops.frontend import (
    BACKENDS, arithmetic_backend, log_mel_batch, mel_to_encoder_input, rms_scale_batch,
)
from anuraxla_torch.ops.mel_kernel import kernel_takes, phase_padded_layout
from anuraxla_torch.ops.window_expand import slot_size, window_expand
from anuraxla_torch.parallel.encode import replicate
from anuraxla_torch.parallel.mesh import batch_sharded, make_mesh, pad_to_multiple
from anuraxla_torch.pipeline.dataset import iter_batches, scan_species_tree, subsample_paths
from anuraxla_torch.utils.timing import span

HOST_SLOTS = 3  # slots of a host ring: batch i+1 decodes while i transfers and i−1 may still be copying


PCM16_BLOCK = 16  # rows a step of to_pcm16: a 19 MB temporary at 294 912-sample rows


def to_pcm16(src: np.ndarray, dst: np.ndarray) -> None:
    """``dst[...] = clip(round(src * 32768), -32768, 32767)`` as int16, the
    reference's conversion (rounding half to even, in f32), a few rows at a
    time through one small temporary with torch's threaded kernels: a
    whole-batch numpy temporary costs a page fault every 4 KB and one core."""
    s, d, b = torch.from_numpy(src), torch.from_numpy(dst), PCM16_BLOCK
    tmp = torch.empty((min(b, s.shape[0]), s.shape[1]), dtype=torch.float32)
    for i in range(0, s.shape[0], b):
        q = torch.mul(s[i : i + b], 32768.0, out=tmp[: min(b, s.shape[0] - i)])
        d[i : i + b].copy_(q.round_().clamp_(-32768, 32767))


class HostRing:
    """Host buffers that rows are written into before their transfer: a few
    slots of one shape and dtype, pinned on a card, used in turn.

    Each slot's transfer records a CUDA event, and ``claim`` hands the slot
    out again only after that event has completed, so a writer on another
    thread (the prefetch thread decoding the next batch) never overwrites
    rows that a non-blocking copy is still reading. The buffers start
    zeroed; writers fill only the sample window of a row, so the pre-padded
    layout's pad columns stay zero."""

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device):
        self.device = device
        self.bufs = [torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda") for _ in range(HOST_SLOTS)]
        self.views = [b.numpy() for b in self.bufs]
        self._sent: List[List[torch.cuda.Event]] = [[] for _ in range(HOST_SLOTS)]
        self._next = 0
        self._lock = threading.Lock()

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.bufs[0].shape)

    def claim(self) -> np.ndarray:
        """The next slot's rows, once the transfers that last read it are done."""
        return self.views[self.claim_slot()]

    def claim_slot(self) -> int:
        """The next slot's index, once the transfers that last read it are done."""
        with self._lock:
            k = self._next
            self._next = (k + 1) % len(self.bufs)
        with span("slot_wait", events=len(self._sent[k])):
            for done in self._sent[k]:
                done.synchronize()
        self._sent[k] = []
        return k

    def slot_of(self, rows: np.ndarray) -> Optional[int]:
        """The index of the slot whose rows ``rows`` are, else None."""
        return next((k for k, v in enumerate(self.views) if v is rows), None)

    def send(self, k: int, start: int = 0, stop: Optional[int] = None,
             device: Optional[torch.device] = None) -> torch.Tensor:
        """Slot ``k``'s rows ``start:stop`` (a data shard's; default all) ->
        the ring's device or ``device``: a non-blocking copy on a card (an
        event recorded after it on that card's stream), the buffer's rows
        themselves on the CPU."""
        buf = self.bufs[k][start:stop]
        dev = self.device if device is None else torch.device(device)
        if dev.type != "cuda":
            return buf
        out = buf.to(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        self._sent[k].append(done)
        return out


class WindowSpans(NamedTuple):
    """A batch of analysis windows as the PCM16 source runs they are cut
    from (``pipeline.stream.fleet_span_batches``): slot ``k`` of ``ring``
    holds the rows' table, then the runs (``ops.window_expand``), its first
    ``n`` int16 values in use; ``rows`` is the batch size."""

    ring: HostRing
    k: int
    n: int
    rows: int


@dataclasses.dataclass
class EncoderSession:
    """Everything needed to turn wav paths into latents, batched on device."""

    mel: MelConfig
    batch_size: int = 64
    # encoder artifact dir (encoder.msgpack + encoder.json); None: the
    # default artifact under project_root, else a seeded init
    encoder_dir: Optional[Path] = None
    project_root: Path = Path(".")
    parity: bool = True  # False: the crop-first fast frontend
    backend: str = "cuda"  # "cuda" | "cuda-bf16" | "matmul" | "matmul-bf16"
    encoder_cfg: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    # trunk compute dtype ("float32" | "bfloat16"); params and heads stay f32
    encoder_dtype: str = "float32"
    # int8 encoder contractions (models.quant): weights quantized once at
    # load, activation scales per ROW, so a row's latent (and the _q8 cache)
    # never depends on its batch-mates; excludes encoder_dtype="bfloat16"
    quantize: bool = False
    normalize_on_device: bool = False  # fuse RMS normalization into the mel op
    # decode into the mel kernel's pre-padded row layout (host cost nil, the
    # device skips the signal pad); needs parity, backend="cuda", hop % 128 == 0
    pre_padded_host: bool = False
    transfer_int16: bool = False  # ship PCM16 over the host->device link
    # robustness noise at this SNR (dB over each row's valid region), seeded
    # per (noise_seed, global row index); None = clean
    add_noise_db: Optional[float] = None
    noise_seed: int = 0
    # split batches over this process's data shards (parallel.mesh.make_mesh(local=True))
    data_parallel: bool = False
    num_threads: int = 16
    init_seed: int = 0  # seeded weights when there are no params and no artifact
    device: str = "cuda"
    latent_dim: int = 0

    def load(self, params: Optional[dict] = None) -> "EncoderSession":
        self._dev = resolve_device(self.device)
        if self.encoder_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"encoder_dtype must be float32 or bfloat16, got {self.encoder_dtype!r}")
        if self.encoder_dtype == "bfloat16" and self.quantize:
            raise ValueError(
                "encoder_dtype='bfloat16' and quantize=True are mutually "
                "exclusive (int8 serving has its own compute path)"
            )
        if params is None:
            params, self.encoder_cfg = load_or_init_encoder(
                self.encoder_dir, Path(self.project_root), seed=self.init_seed, cfg=self.encoder_cfg)
        cfg = dataclasses.replace(self.encoder_cfg, dtype=self.encoder_dtype)
        if tuple(cfg.input_hw) != (self.mel.target_frames, self.mel.n_mels):
            raise ValueError(
                f"encoder expects input {cfg.input_hw}, mel config produces "
                f"({self.mel.target_frames}, {self.mel.n_mels})"
            )
        enc = ConvVAEEncoder(cfg)
        enc.load_state_dict(params)
        self._enc = enc.eval().to(self._dev)
        self._enc_cfg = cfg
        self._q = quantize_encoder(params, cfg, device=self._dev) if self.quantize else None
        self.latent_dim = cfg.latent_dim
        self._rings: Dict[torch.dtype, HostRing] = {}
        self._span_ring: Optional[HostRing] = None
        self._mesh = None
        if self.data_parallel:
            mesh = make_mesh(device=self._dev, local=True)  # encode stays process-local
            nd = mesh.shape["data"]
            if nd > 1:
                if self.batch_size % nd:
                    self.batch_size = -(-self.batch_size // nd) * nd
                    print(f"ℹ️ data-parallel: batch_size rounded up to {self.batch_size} ({nd}-way even shards)")
                self._mesh = mesh
                # one encoder replica, and its int8 weights, on each distinct shard device
                self._replicas = {
                    d: (enc, self._q if enc is self._enc else
                        quantize_encoder(params, cfg, device=d) if self.quantize else None)
                    for d, enc in replicate(self._enc, mesh).items()
                }
        self._setup_layout()
        return self

    def _setup_layout(self) -> None:
        """Validate the frontend settings and derive the decode layout."""
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        self._fingerprint = None  # computed lazily (hashes the weights once)
        self._layout = None  # (row_len, col_offset)
        if self.pre_padded_host:
            if (not self.parity or self.backend != "cuda" or self.mel.hop_length % 128
                    or not kernel_takes(self.mel, "ct")):
                raise ValueError(
                    "pre_padded_host requires parity=True, backend='cuda' and "
                    "hop_length % 128 == 0 (the ct kernel's pre-padded layout); got "
                    f"parity={self.parity}, backend={self.backend!r}, hop={self.mel.hop_length}"
                )
            self._layout = phase_padded_layout(self.mel, self.mel.total_frames)

    def reconfigure(
        self,
        *,
        duration: Optional[float] = None,
        parity: Optional[bool] = None,
        backend: Optional[str] = None,
    ) -> "EncoderSession":
        """Change frontend parameters (config.json's chunk_seconds, the
        frontend mode, the backend) on a loaded session: the layout is derived
        and validated again, as ``load()`` does, and the fingerprint is reset,
        only when something changed. The weights stay loaded."""
        changed = False
        if duration is not None and abs(duration - self.mel.duration) > 1e-9:
            self.mel = self.mel.replace(duration=duration)
            changed = True
        if parity is not None and parity != self.parity:
            self.parity = parity
            changed = True
        if backend is not None and backend != self.backend:
            self.backend = backend
            changed = True
        if changed:
            self._setup_layout()
        return self

    def _inject_noise(self, audio: np.ndarray, start_idx: int, n_valid: int, *, copy: bool = True) -> np.ndarray:
        """Row-deterministic broadband noise at ``add_noise_db`` SNR, seeded
        by (noise_seed, global row index); the SNR references each row's RMS
        over the valid region. ``copy=False`` adds it in place (the decoded
        rows of a host slot)."""
        if self.add_noise_db is None:
            return audio
        off = 0
        if self._layout is not None and audio.shape[1] != self.mel.num_samples:
            off = self._layout[1]
        L = self.mel.num_samples
        if copy:
            audio = np.array(audio, np.float32, copy=True)
        factor = 10.0 ** (-float(self.add_noise_db) / 20.0)
        for i in range(int(n_valid)):
            seg = audio[i, off : off + L]
            rms = float(np.sqrt(np.mean(seg * seg)))
            if rms <= 0.0:
                continue
            g = np.random.default_rng((int(self.noise_seed), start_idx + i))
            seg += (rms * factor) * g.standard_normal(L).astype(np.float32)
            np.clip(seg, -1.0, 1.0, out=seg)
        return audio

    def _ring(self, shape: Tuple[int, int], dtype: torch.dtype) -> HostRing:
        """The session's host ring of ``dtype``, made anew when the batch
        shape changes."""
        ring = self._rings.get(dtype)
        if ring is None or ring.shape != tuple(shape):
            ring = self._rings[dtype] = HostRing(tuple(shape), dtype, self._dev)
        return ring

    def span_ring(self) -> HostRing:
        """The session's int16 ring of window spans (``WindowSpans``): a slot
        holds a batch's table and up to ``batch_size`` whole windows of source
        samples, the most a batch can need."""
        n = slot_size(self.batch_size, self.batch_size * self.mel.num_samples)
        if self._span_ring is None or self._span_ring.shape != (n,):
            self._span_ring = HostRing((n,), torch.int16, self._dev)
        return self._span_ring

    def _to_slot(self, audio: np.ndarray) -> Tuple[HostRing, int]:
        """Host rows -> (a host ring, the index of its slot holding them). A
        slot of the f32 ring (``encode_paths`` decoded into it) is used as it
        is; other rows — raw [B, num_samples] (staged into the pre-padded
        layout where the session uses it) or already in the session's row
        layout — are written into a slot first, PCM16-converted with
        ``transfer_int16``."""
        f32 = self._rings.get(torch.float32)
        k = f32.slot_of(audio) if f32 is not None and not self.transfer_int16 else None
        if k is not None:
            return f32, k
        row_len, col = (self._layout if self._layout is not None and audio.shape[1] == self.mel.num_samples
                        else (audio.shape[1], 0))
        ring = self._ring((audio.shape[0], row_len), torch.int16 if self.transfer_int16 else torch.float32)
        k = ring.claim_slot()
        window = ring.views[k][:, col : col + audio.shape[1]]
        with span("stage", bytes=window.nbytes):
            if self.transfer_int16 and audio.dtype != np.int16:
                to_pcm16(audio, window)
            else:
                window[...] = audio
        return ring, k

    def _to_device(self, audio: np.ndarray) -> torch.Tensor:
        ring, k = self._to_slot(audio)
        return ring.send(k)

    def _forward(self, audio: torch.Tensor, replica: Optional[tuple] = None) -> torch.Tensor:
        """The device forward of one batch (``replica``: a data shard's
        (encoder, int8 weights); default the session's own)."""
        enc, q = replica or (self._enc, self._q)
        if audio.dtype == torch.int16:
            audio = audio.to(torch.float32) / 32768.0
        scale = None
        if self.normalize_on_device:
            valid = audio
            if self._layout is not None:
                # reduce over the valid slice, not the padded row
                off = self._layout[1]
                valid = audio[:, off : off + self.mel.num_samples]
            scale = rms_scale_batch(valid)
        mels = log_mel_batch(
            audio, self.mel, parity=self.parity, backend=self.backend,
            rms_scale=scale, pre_padded=self._layout is not None,
        )
        x = mel_to_encoder_input(mels)
        with span("encoder", rows=x.shape[0]):
            if q is not None:
                return encoder_apply_quantized(q, self._enc_cfg, x)["mu"]
            return enc(x)["mu"]

    def _dispatch(self, audio: "np.ndarray | WindowSpans") -> torch.Tensor:
        """Start the device computation for one batch — host rows, or
        ``WindowSpans`` whose slot the device expands into rows
        (``ops.window_expand``) — without fetching. Over several data shards,
        a ragged batch of rows is padded with zero rows to a multiple of their
        count (callers slice results to their own rows), and each shard's
        rows of the host slot go to its device; spans are refused there, since
        one device would expand and encode every row."""
        spans = isinstance(audio, WindowSpans)
        if spans and self._mesh is not None:
            raise ValueError("WindowSpans reach no data shards: a data-parallel session takes host rows")
        with torch.inference_mode(), span("dispatch", rows=audio.rows if spans else audio.shape[0]):
            if spans:
                row_len, col = self._layout or (self.mel.num_samples, 0)
                slot = audio.ring.send(audio.k, 0, audio.n)
                return self._forward(window_expand(slot, audio.rows, self.mel.num_samples, row_len, col))
            if self._mesh is None:
                return self._forward(self._to_device(audio))
            audio, _ = pad_to_multiple(audio, self._mesh.shape["data"])
            ring, k = self._to_slot(audio)
            slices = self._mesh.local_slices(audio.shape[0])

            def shard(i: int, _rows) -> torch.Tensor:
                dev = self._mesh.data_devices[i]
                return self._forward(ring.send(k, *slices[i], device=dev), self._replicas[dev])

            return batch_sharded(shard, self._mesh)(audio)

    def encode_array(self, audio: np.ndarray) -> np.ndarray:
        """[B, num_samples] (or pre-padded) waveforms -> [B, D] latents."""
        audio = self._inject_noise(np.ascontiguousarray(audio, np.float32), 0, audio.shape[0])
        z = self._dispatch(audio)
        with span("fetch", rows=audio.shape[0]):
            return z.cpu().numpy()[: audio.shape[0]]

    def decoded_batches(self, paths: Sequence[Path]):
        """``iter_batches`` over ``paths`` as ``encode_paths`` runs it: each
        batch decoded into a slot of the session's f32 host ring (its
        ``audio`` is that slot), noise added there in place."""
        row_len = self._layout[0] if self._layout is not None else self.mel.num_samples
        ring = self._ring((self.batch_size, row_len), torch.float32)
        noise = functools.partial(self._inject_noise, copy=False) if self.add_noise_db is not None else None
        return iter_batches(
            paths, sr=self.mel.sr, num_samples=self.mel.num_samples, batch_size=self.batch_size,
            num_threads=self.num_threads, layout=self._layout, transform=noise, buffers=ring.claim,
        )

    def encode_paths(self, paths: Sequence[Path]) -> Tuple[np.ndarray, np.ndarray, List[Optional[str]]]:
        """Decode+encode a path list. Returns (Z [N, D], ok [N], errors [N])."""
        N = len(paths)
        Z = np.zeros((N, self.latent_dim), np.float32)
        ok = np.zeros(N, bool)
        errors: List[Optional[str]] = [None] * N
        pos = 0
        pending = None  # (device_result, start, n_valid)
        for batch, n_valid in self.decoded_batches(paths):
            ok[pos : pos + n_valid] = batch.ok[:n_valid]
            errors[pos : pos + n_valid] = batch.errors[:n_valid]
            cur = (self._dispatch(batch.audio), pos, n_valid)
            if pending is not None:
                self._fetch(pending, Z)
            pending = cur
            pos += n_valid
        if pending is not None:
            self._fetch(pending, Z)
        return Z, ok, errors

    @staticmethod
    def _fetch(pending: tuple, Z: np.ndarray) -> None:
        """A dispatched batch's latents -> their rows of ``Z`` (the host waits for the device here)."""
        z, p0, nv = pending
        with span("fetch", id=p0, rows=nv):
            Z[p0 : p0 + nv] = z.cpu().numpy()[:nv]


def cache_path_for(cache_dir: Path, chunks_dir: Path, species: str, tag: str = "") -> Path:
    """``cache_npz/Z_<rootname>_<species><tag>.npz``, the reference's archive
    name; ``tag`` gives variant encodes their own file."""
    return Path(cache_dir) / f"Z_{Path(chunks_dir).name}_{species}{tag}.npz"


def mel_fingerprint(mel: MelConfig) -> str:
    return (
        f"sr{mel.sr}_d{mel.duration}_m{mel.n_mels}_f{mel.fmin}-{mel.fmax}"
        f"_h{mel.hop_length}_n{mel.n_fft}_t{mel.target_frames}"
    )


FRAMEWORK_TAG = "torch"


def session_fingerprint(session: EncoderSession) -> str:
    """Cache key of a loaded session, covering everything that changes
    latents: mel parameters, frontend mode, the arithmetic that runs
    (``arithmetic_backend``: a kernel backend on a config no kernel takes
    runs matmul math, and on the CPU its plain version, not the card's
    split), the encoder weights (digest of the ``state_dict`` in sorted key
    order), the architecture (hash of the config, its compute dtype
    included), int8 serving (``_q8``; ``_q8-cpuplain`` off the card, where
    the contractions run their plain versions), int16 transfer, device-side
    normalization and noise injection. The backend is prefixed with :data:`FRAMEWORK_TAG`, so no key equals one of
    the JAX package, whose ``matmul`` backends share their names with this
    one's while its latents differ in the last bits."""
    if session._fingerprint:
        return session._fingerprint
    h = hashlib.blake2b(digest_size=10)
    state = session._enc.state_dict()
    for key in sorted(state):
        h.update(key.encode())
        h.update(state[key].detach().cpu().contiguous().numpy().tobytes())
    d = dataclasses.asdict(session._enc_cfg)
    d["dtype"] = str(d["dtype"]).replace("torch.", "")
    d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}
    arch = hashlib.blake2b(json.dumps(d, sort_keys=True).encode(), digest_size=6).hexdigest()
    fp = (
        f"{mel_fingerprint(session.mel)}_p{int(session.parity)}"
        f"_{FRAMEWORK_TAG}-{arithmetic_backend(session.mel, session.backend, session._dev)}"
        f"_e{h.hexdigest()}_a{arch}"
        + (("_q8" if session._dev.type == "cuda" else "_q8-cpuplain") if session.quantize else "")
        + ("_i16" if session.transfer_int16 else "")
        + ("_ndev" if session.normalize_on_device else "")
        + (f"_nz{session.add_noise_db:g}s{session.noise_seed}" if session.add_noise_db is not None else "")
    )
    session._fingerprint = fp
    return fp


def encode_species_tree(
    session: EncoderSession,
    chunks_dir: Path,
    species: Sequence[str],
    *,
    cache: bool = False,
    cache_dir: Optional[Path] = None,
    max_per_class: int = 0,
    seed: int = 123,
    cache_tag: str = "",
    log=print,
) -> Tuple[Dict[str, np.ndarray], Dict[str, int], Dict[str, int]]:
    """Per-species encode with an optional .npz cache and subsampling.
    Returns (Z_by_species, failed_counts, used_counts); species with no wavs
    or no successful encodes are omitted.

    The archive holds the reference's fields — ``Z``, ``failed``, ``root``
    (the resolved source root), ``mel_fp`` (the session's fingerprint),
    ``sub`` (the subsampling request) and ``files`` (a digest of the folder's
    file list) — and is stale when any of them is missing or differs."""
    tree = scan_species_tree(chunks_dir, species)
    rng = pyrandom.Random(seed)  # seeded once; draws consume sequential state
    if cache:
        cache_dir = Path(cache_dir) if cache_dir else Path(CACHE_DIR_NAME)
        cache_dir.mkdir(parents=True, exist_ok=True)

    Z_by: Dict[str, np.ndarray] = {}
    failed: Dict[str, int] = {}
    used: Dict[str, int] = {}
    fp = session_fingerprint(session)
    root_key = str(Path(chunks_dir).resolve())
    sub_key = f"{max_per_class}:{seed}" if max_per_class else "all"

    for sp in species:
        wavs = tree.get(sp, [])
        files_key = hashlib.sha1("\n".join(p.name for p in wavs).encode()).hexdigest()[:16]
        cpath = cache_path_for(cache_dir, chunks_dir, sp, cache_tag) if cache else None
        if cpath is not None and cpath.exists():
            data = np.load(cpath, allow_pickle=False)
            stale = any(k not in data or str(data[k]) != v
                        for k, v in (("mel_fp", fp), ("root", root_key), ("sub", sub_key), ("files", files_key)))
            if not stale:
                Zm = data["Z"].astype(np.float32)
                Z_by[sp] = Zm
                failed[sp] = int(data["failed"]) if "failed" in data else 0
                used[sp] = int(Zm.shape[0])
                log(f"🧊 {sp}: cache {cpath.name} -> N={Zm.shape[0]}")
                continue
            log(f"♻️ {sp}: cache stale (mel/frontend/encoder/root/subsample/file-list changed), re-encoding")

        if not wavs:
            log(f"⚠️ {sp}: no wavs under {Path(chunks_dir) / sp} (skipped)")
            continue
        wavs = subsample_paths(wavs, max_per_class, rng)

        t0 = time.perf_counter()
        Z, ok, _errors = session.encode_paths(wavs)
        rate = len(wavs) / max(time.perf_counter() - t0, 1e-9)
        n_fail = int((~ok).sum())
        if ok.sum() == 0:
            log(f"❌ {sp}: nothing could be encoded (skipped)")
            continue
        Zm = Z[ok]
        Z_by[sp] = Zm
        failed[sp] = n_fail
        used[sp] = int(Zm.shape[0])
        log(f"🧪 {sp}: encoded N={Zm.shape[0]} (failed={n_fail}) [{rate:.1f} chunks/s]")

        if cpath is not None:
            np.savez_compressed(cpath, Z=Zm, failed=n_fail, root=root_key, mel_fp=fp, sub=sub_key, files=files_key)
            log(f"   ↳ cached: {cpath.name}")

    return Z_by, failed, used


def concat_species_latents(Z_by: Dict[str, np.ndarray], species: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """{sp: [N, D]} -> (Z [N_total, D], true_idx [N_total]) with labels
    indexed by position in ``species``; species absent from Z_by are skipped."""
    present = [(i, sp) for i, sp in enumerate(species) if sp in Z_by]
    if not present:
        raise SystemExit(
            "❌ no evaluation latents: none of the species "
            f"{list(species)} had encodable wavs (wrong --val-root?)"
        )
    Z = np.concatenate([Z_by[sp] for _, sp in present])
    true_idx = np.concatenate([np.full(len(Z_by[sp]), i, np.int32) for i, sp in present])
    return Z, true_idx


def pad_species_latents(Z_by: Dict[str, np.ndarray]) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Ragged {sp: [N_sp, D]} -> (species order, Z [K, Nmax, D], mask [K, Nmax])
    — the fixed-shape layout ``detect.fit_*`` expect."""
    species = list(Z_by.keys())
    if not species:
        raise ValueError("no encoded species")
    Nmax = max(z.shape[0] for z in Z_by.values())
    D = next(iter(Z_by.values())).shape[1]
    Z = np.zeros((len(species), Nmax, D), np.float32)
    mask = np.zeros((len(species), Nmax), bool)
    for i, sp in enumerate(species):
        n = Z_by[sp].shape[0]
        Z[i, :n] = Z_by[sp]
        mask[i, :n] = True
    return species, Z, mask
