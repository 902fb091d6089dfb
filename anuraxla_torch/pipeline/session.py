"""Load-once inference session: wav rows -> latents on the card — the port
of ``anuraxla/pipeline/session.py``'s ``EncoderSession``.

The served path: decoded rows (optionally already in the mel kernel's
pre-padded layout) go to the device through a pinned host buffer with a
non-blocking copy; the device computes the fused RMS scale over the valid
slice, the log-mel frontend (``backend="cuda"``: the Hopper mel kernel), and
the encoder's ``mu``. ``encode_paths`` keeps two batches in flight: it
fetches batch i−1's latents only after batch i is dispatched, while the next
batch decodes on a prefetch thread.

Weights: ``load(params=state_dict)`` (e.g. from
``models.convert.encoder_state_from_jax``) or, with no params, a seeded
random init (``init_seed``). The encoder artifact loader (flax msgpack) is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.models.vae import ConvVAEEncoder, VAEConfig, init_encoder_params
from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input, rms_scale_batch
from anuraxla_torch.ops.mel_kernel import kernel_takes, phase_padded_layout
from anuraxla_torch.pipeline.dataset import iter_batches


@dataclasses.dataclass
class EncoderSession:
    """Everything needed to turn wav paths into latents, batched on device."""

    mel: MelConfig
    batch_size: int = 64
    # only the parity frontend is ported: False (the fast tier) is refused
    # at load() until that tier lands
    parity: bool = True
    backend: str = "cuda"  # "cuda" | "matmul"
    encoder_cfg: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    # trunk compute dtype ("float32" | "bfloat16"); params and heads stay f32
    encoder_dtype: str = "float32"
    normalize_on_device: bool = False  # fuse RMS normalization into the mel op
    # decode into the mel kernel's pre-padded row layout (host cost nil, the
    # device skips the signal pad); needs parity, backend="cuda", hop % 128 == 0
    pre_padded_host: bool = False
    transfer_int16: bool = False  # ship PCM16 over the host->device link
    # robustness noise at this SNR (dB over each row's valid region), seeded
    # per (noise_seed, global row index); None = clean
    add_noise_db: Optional[float] = None
    noise_seed: int = 0
    num_threads: int = 16
    init_seed: int = 0  # seeded weights when load() gets no params
    device: str = "cuda"
    latent_dim: int = 0

    def load(self, params: Optional[dict] = None) -> "EncoderSession":
        self._dev = resolve_device(self.device)
        if not self.parity:
            raise NotImplementedError("the fast frontend (parity=False) is not ported yet")
        if self.encoder_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"encoder_dtype must be float32 or bfloat16, got {self.encoder_dtype!r}")
        cfg = dataclasses.replace(self.encoder_cfg, dtype=self.encoder_dtype)
        if tuple(cfg.input_hw) != (self.mel.target_frames, self.mel.n_mels):
            raise ValueError(
                f"encoder expects input {cfg.input_hw}, mel config produces "
                f"({self.mel.target_frames}, {self.mel.n_mels})"
            )
        if params is None:
            params = init_encoder_params(cfg, torch.Generator().manual_seed(self.init_seed))
        enc = ConvVAEEncoder(cfg)
        enc.load_state_dict(params)
        self._enc = enc.eval().to(self._dev)
        self.latent_dim = cfg.latent_dim
        self._pinned = [None, None]
        self._slot = 0
        self._setup_layout()
        return self

    def _setup_layout(self) -> None:
        self._layout = None  # (row_len, col_offset)
        if self.pre_padded_host:
            if not self.parity or self.backend != "cuda" or not kernel_takes(self.mel):
                raise ValueError(
                    "pre_padded_host requires parity=True, backend='cuda' and a "
                    f"config the mel kernel takes (hop % 128 == 0); got parity="
                    f"{self.parity}, backend={self.backend!r}, hop={self.mel.hop_length}"
                )
            self._layout = phase_padded_layout(self.mel, self.mel.total_frames)

    def reconfigure(self, *, duration: Optional[float] = None) -> "EncoderSession":
        """Retarget the clip duration (config.json's chunk_seconds)."""
        if duration is not None and abs(duration - self.mel.duration) > 1e-9:
            self.mel = self.mel.replace(duration=duration)
            self._setup_layout()
        return self

    def _inject_noise(self, audio: np.ndarray, start_idx: int, n_valid: int) -> np.ndarray:
        """Row-deterministic broadband noise at ``add_noise_db`` SNR, seeded
        by (noise_seed, global row index); the SNR references each row's RMS
        over the valid region."""
        if self.add_noise_db is None:
            return audio
        off = 0
        if self._layout is not None and audio.shape[1] != self.mel.num_samples:
            off = self._layout[1]
        L = self.mel.num_samples
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

    def _to_device(self, audio: np.ndarray) -> torch.Tensor:
        """Host rows -> device. On CUDA: through one of two pinned buffers
        (alternating, so a buffer is rewritten only after the batch that used
        it was fetched) with a non-blocking copy."""
        if self._dev.type != "cuda":
            return torch.from_numpy(audio)
        self._slot ^= 1
        buf = self._pinned[self._slot]
        dt = torch.from_numpy(audio[:0]).dtype
        if buf is None or tuple(buf.shape) != audio.shape or buf.dtype != dt:
            buf = torch.empty(audio.shape, dtype=dt, pin_memory=True)
            self._pinned[self._slot] = buf
        buf.numpy()[...] = audio
        return buf.to(self._dev, non_blocking=True)

    def _forward(self, audio: torch.Tensor) -> torch.Tensor:
        if self.transfer_int16:
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
        return self._enc(mel_to_encoder_input(mels))["mu"]

    def _dispatch(self, audio: np.ndarray) -> torch.Tensor:
        """Start the device computation for one batch without fetching."""
        if self._layout is not None and audio.shape[1] == self.mel.num_samples:
            # raw [B, num_samples] rows: stage into the pre-padded layout
            row_len, off = self._layout
            staged = np.zeros((audio.shape[0], row_len), np.float32)
            staged[:, off : off + self.mel.num_samples] = audio
            audio = staged
        if self.transfer_int16 and audio.dtype != np.int16:
            audio = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
        with torch.inference_mode():
            return self._forward(self._to_device(np.ascontiguousarray(audio)))

    def encode_array(self, audio: np.ndarray) -> np.ndarray:
        """[B, num_samples] (or pre-padded) waveforms -> [B, D] latents."""
        audio = self._inject_noise(np.asarray(audio, np.float32), 0, audio.shape[0])
        return self._dispatch(audio).cpu().numpy()[: audio.shape[0]]

    def encode_paths(self, paths: Sequence[Path]) -> Tuple[np.ndarray, np.ndarray, List[Optional[str]]]:
        """Decode+encode a path list. Returns (Z [N, D], ok [N], errors [N])."""
        N = len(paths)
        Z = np.zeros((N, self.latent_dim), np.float32)
        ok = np.zeros(N, bool)
        errors: List[Optional[str]] = [None] * N
        pos = 0
        pending = None  # (device_result, start, n_valid)
        for batch, n_valid in iter_batches(
            paths, sr=self.mel.sr, num_samples=self.mel.num_samples,
            batch_size=self.batch_size, num_threads=self.num_threads,
            layout=self._layout,
            transform=self._inject_noise if self.add_noise_db is not None else None,
        ):
            ok[pos : pos + n_valid] = batch.ok[:n_valid]
            errors[pos : pos + n_valid] = batch.errors[:n_valid]
            cur = (self._dispatch(batch.audio), pos, n_valid)
            if pending is not None:
                z, p0, nv = pending
                Z[p0 : p0 + nv] = z.cpu().numpy()[:nv]
            pending = cur
            pos += n_valid
        if pending is not None:
            z, p0, nv = pending
            Z[p0 : p0 + nv] = z.cpu().numpy()[:nv]
        return Z, ok, errors
