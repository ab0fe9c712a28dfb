"""Noise augmentation: background + babble with a ramped SNR schedule.

Reference: data/dali/noise.py:6-311 (iterators, schedule, numba blending —
the blending itself lives in data/audio.py here, plain numpy) and
args/noise_augmentation.py (defaults). Semantics kept:

- each sample independently draws "apply noise?" with probability p, and a
  target SNR uniform in [low, high] dB (no-noise = SNR 200 dB sentinel);
- the SNR range starts high (30-60 dB ~ inaudible), holds for
  ``delay_steps``, then ramps linearly over ``ramp_steps`` to the final
  range: background 0-30 dB, babble 15-30 dB (noise.py:107-137);
- background noise clips come from a directory of audio files; babble
  sums other utterances from the same batch.

The port's copy of ``caiman_asr_tpu/data/noise.py``, on local directories
only: a Hugging Face hub dataset needs the network and raises (ROADMAP.md
Queue 1 item 3).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from caiman_asr_tpu_torch.data.audio import read_audio

NO_NOISE_SNR = 200.0  # dB; effectively silent

AUDIO_SUFFIXES = {".wav", ".flac", ".ogg", ".mp3"}


class NoiseSampler:
    """Per-sample (apply?, snr, start_ratio) draws with a mutable range
    (reference NoiseAugmentationIterator, noise.py:6-54)."""

    def __init__(self, prob: float, rng: np.random.Generator,
                 low: float = 30.0, high: float = 60.0):
        self.prob = prob
        self.low = low
        self.high = high
        self.rng = rng

    def set_range(self, low: float, high: float):
        self.low, self.high = low, high

    def get_range(self) -> Tuple[float, float]:
        return self.low, self.high

    def draw(self) -> Tuple[float, float]:
        """Returns (target_snr_db, start_ratio)."""
        if self.rng.random() < self.prob:
            snr = float(self.rng.uniform(self.low, self.high))
        else:
            snr = NO_NOISE_SNR
        return snr, float(self.rng.random())


class NoiseDataset:
    """Background-noise clips from a local directory (lazily decoded)."""

    def __init__(self, root: str | Path, sample_rate: int = 16000,
                 max_clips: Optional[int] = None):
        root = Path(root)
        self.paths: List[Path] = sorted(
            p for p in root.rglob("*") if p.suffix.lower() in AUDIO_SUFFIXES
        )
        if max_clips:
            self.paths = self.paths[:max_clips]
        if not self.paths:
            raise FileNotFoundError(f"no audio files under {root}")
        self.sr = sample_rate
        self._cache: dict = {}

    def get(self, rng: np.random.Generator) -> np.ndarray:
        i = int(rng.integers(len(self.paths)))
        if i not in self._cache:
            self._cache[i] = read_audio(self.paths[i], self.sr)
        return self._cache[i]

    @classmethod
    def from_spec(cls, spec: str, sample_rate: int = 16000,
                  hf_config: Optional[str] = None,
                  max_clips: Optional[int] = None) -> "NoiseDataset":
        """A local directory of audio files. A Hugging Face hub dataset name
        (the JAX package's connected branch) raises: it needs the network
        and is not ported (ROADMAP.md Queue 1 item 3)."""
        if Path(spec).is_dir():
            return cls(spec, sample_rate, max_clips)
        raise NotImplementedError(
            f"--noise_dataset {spec!r} is not a local directory: Hugging Face hub noise "
            "datasets are not ported (ROADMAP.md Queue 1 item 3)")


class NoiseSchedule:
    """Delay-then-ramp SNR schedule (reference noise.py:56-137)."""

    def __init__(
        self,
        delay_steps: int,
        ramp_steps: int,
        initial_low: float,
        initial_high: float,
        background: Optional[NoiseSampler] = None,
        babble: Optional[NoiseSampler] = None,
    ):
        self.delay_steps = delay_steps
        self.ramp_steps = ramp_steps
        self.initial_low = initial_low
        self.initial_high = initial_high
        self.background = background
        self.babble = babble

    BG_FINAL = (0.0, 30.0)
    BABBLE_FINAL = (15.0, 30.0)

    def adjust_snrs(self, step: int):
        if step <= self.delay_steps:
            bg = bb = (self.initial_low, self.initial_high)
        elif step >= self.delay_steps + self.ramp_steps:
            bg, bb = self.BG_FINAL, self.BABBLE_FINAL
        else:
            frac = (step - self.delay_steps) / self.ramp_steps
            high = self.initial_high - int(frac * (self.initial_high - 30.0))
            bg = (self.initial_low - int(frac * (self.initial_low - 0.0)), high)
            bb = (self.initial_low - int(frac * (self.initial_low - 15.0)), high)
        if self.background is not None:
            self.background.set_range(*bg)
        if self.babble is not None:
            self.babble.set_range(*bb)
        return (
            self.background.get_range() if self.background else (-1, -1),
            self.babble.get_range() if self.babble else (-1, -1),
        )
