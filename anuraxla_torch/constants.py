"""Defaults shared across the port — a copy of ``anuraxla/constants.py``
(the port imports nothing of ``anuraxla``)."""

from __future__ import annotations

import dataclasses

#: Fixed species set and tie-break priority of the reference
#: (``09_evaluate_wav_detection.py:61-66``). Detection accepts may tie; the
#: first accepted species in this order wins.
PRIORITY_ORDER: tuple[str, ...] = (
    "Batrachyla_leptopus",
    "Batrachyla_taeniata",
    "Calyptocephalella_gayi",
    "Pleurodema_thaul",
)

SPECIES: tuple[str, ...] = PRIORITY_ORDER


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Log-mel frontend parameters (reference ``wav_to_mel``,
    ``map_detector_core.py:198-237``)."""

    sr: int = 48_000
    duration: float = 5.0
    n_mels: int = 64
    fmin: float = 150.0
    fmax: float = 15_000.0
    hop_length: int = 384
    n_fft: int = 2048
    target_frames: int = 192
    #: librosa.power_to_db defaults the reference relies on implicitly.
    amin: float = 1e-10
    top_db: float = 80.0

    @property
    def num_samples(self) -> int:
        return int(self.sr * self.duration)

    @property
    def total_frames(self) -> int:
        """Frame count of a centered STFT over the full clip
        (librosa center=True: 1 + num_samples // hop)."""
        return 1 + self.num_samples // self.hop_length

    def replace(self, **kw) -> "MelConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_MEL = MelConfig()

#: RMS normalization parameters (``00_normalize_dataset_rms.py:29-38``).
RMS_TARGET: float = 0.05
RMS_SILENCE_GATE: float = 1e-4
RMS_EPS: float = 1e-8

#: Latent-encode cache directory name (``08_fit_radial_detector.py:432``).
CACHE_DIR_NAME = "cache_npz"

#: Default encoder artifact directory under the project root, the JAX
#: package's (``encoder.msgpack`` + ``encoder.json``, read by
#: ``models.checkpoint``).
DEFAULT_ENCODER_DIR = "models/anuraxla_vae_encoder_v0"
