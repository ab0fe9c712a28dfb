"""Host-side audio decoding (the port of ``read_audio`` and ``resample`` in
``caiman_asr_tpu/data/audio.py:24-82``).

``.npy``, ``.wav`` (8-, 16- and 32-bit PCM, downmixed) and ``.flac`` (the
port's native decoder) to float32 mono at the target rate. Other formats
raise, as the JAX package does without the optional ``soundfile``, which
the port does not use. The host-side augmentations of
``caiman_asr_tpu/data/audio.py:84-178`` (speed perturbation, narrowband
resimulation, silence trimming, noise and babble blending) keep its numpy
and scipy arithmetic, so the same ``rng`` gives the same samples.
"""

from __future__ import annotations

import wave
from fractions import Fraction
from math import gcd
from pathlib import Path

import numpy as np
from scipy import signal as sps


def read_audio(path: str | Path, target_sr: int = 16000) -> np.ndarray:
    """Decode an audio file to float32 mono at target_sr."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        return np.load(path).astype(np.float32)
    if suffix == ".wav":
        with wave.open(str(path), "rb") as w:
            sr = w.getframerate()
            width = w.getsampwidth()
            ch = w.getnchannels()
            raw = w.readframes(w.getnframes())
        if width == 2:
            audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
        elif width == 1:
            audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported wav sample width {width}")
        if ch > 1:
            audio = audio.reshape(-1, ch).mean(axis=1)  # downmix like DALI
    elif suffix == ".flac":
        from caiman_asr_tpu_torch.native import flac_decode_file

        samples, sr, bps, _ = flac_decode_file(path)
        audio = samples.astype(np.float32) / float(1 << (bps - 1))
        audio = audio.mean(axis=1) if audio.shape[1] > 1 else audio[:, 0]
    else:
        raise RuntimeError(f"Cannot decode {path}: only .npy, .wav and .flac are read.")
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    return audio


def resample(audio: np.ndarray, sr_in: int | float, sr_out: int | float) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    a, b = int(round(sr_in)), int(round(sr_out))
    g = gcd(a, b)
    return sps.resample_poly(audio, b // g, a // g).astype(np.float32)


def speed_perturb(
    audio: np.ndarray, rate: float, quality_steps: int = 64
) -> np.ndarray:
    """Speed perturbation by resampling (reference: DALI audio_resample with
    scale in [0.85, 1.15], pipeline.py:388-406).

    The rate is snapped to a rational with denominator <= ``quality_steps``
    before the polyphase resample: resample_poly's filter length scales
    with max(up, down), so feeding it raw sample counts (~rate * n taps)
    costs ~100 ms per 12 s utterance, while p/q <= 64/64 costs ~2 ms.
    A ~1/64-granular rate is indistinguishable for augmentation (the rate
    is a uniform random draw to begin with)."""
    if rate == 1.0:
        return audio
    fr = Fraction(float(rate)).limit_denominator(quality_steps)
    if fr.numerator == fr.denominator:
        return audio
    # output length ~= n / rate: up = denominator, down = numerator
    scaled = sps.resample_poly(audio, fr.denominator, fr.numerator)
    return scaled.astype(np.float32)


def narrowband_resim(audio: np.ndarray, sr: int | float) -> np.ndarray:
    """Telephony-bandwidth resimulation: downsample to 8 kHz and back
    (reference pipeline.py:407-437 — volume is divided by 3 before the
    resample round-trip to avoid filter-overshoot clipping, then restored).
    Length is preserved (the polyphase round-trip can drift a sample)."""
    n = len(audio)
    if n == 0 or float(sr) == 8000.0:
        return audio
    x = resample(resample(audio / 3.0, sr, 8000), 8000, sr) * 3.0
    if len(x) < n:
        x = np.pad(x, (0, n - len(x)))
    return x[:n].astype(np.float32)


def trim_silence(
    audio: np.ndarray, cutoff_db: float = -60.0, window: int = 256
) -> np.ndarray:
    """Leading/trailing silence trim (reference: DALI NonsilentRegion,
    pipeline.py:309-315). Energy-based with the same cutoff convention."""
    if len(audio) == 0:
        return audio
    pad = (-len(audio)) % window
    x = np.pad(audio, (0, pad)).reshape(-1, window)
    rms = np.sqrt((x**2).mean(axis=1) + 1e-12)
    peak = rms.max()
    if peak <= 0:
        return audio
    db = 20.0 * np.log10(rms / peak + 1e-12)
    keep = np.nonzero(db > cutoff_db)[0]
    if len(keep) == 0:
        return audio
    start = keep[0] * window
    end = min(len(audio), (keep[-1] + 1) * window)
    return audio[start:end]


def blend_noise(
    rng: np.random.Generator,
    audio: np.ndarray,
    noise: np.ndarray,
    target_snr_db: float,
    ratio_start: float = 0.0,
) -> np.ndarray:
    """Blend background noise at a target SNR (reference: data/dali/noise.py
    numba `blend`). noise is tiled/cropped to cover the utterance starting at
    fraction `ratio_start` of the noise clip."""
    if len(noise) == 0:
        return audio
    start = int(ratio_start * len(noise)) % len(noise)
    reps = int(np.ceil((start + len(audio)) / len(noise)))
    seg = np.tile(noise, reps)[start : start + len(audio)]
    p_sig = (audio**2).mean() + 1e-12
    p_noise = (seg**2).mean() + 1e-12
    scale = np.sqrt(p_sig / (p_noise * 10.0 ** (target_snr_db / 10.0)))
    return (audio + scale * seg).astype(np.float32)


def babble_batch(
    rng: np.random.Generator, batch: list[np.ndarray], target_snr_db: float
) -> list[np.ndarray]:
    """Babble augmentation: each utterance gets a sum of other batch members
    as 'noise' (reference: data/dali/noise.py babble_batch)."""
    if len(batch) < 2:
        return batch
    out = []
    for i, audio in enumerate(batch):
        others = [j for j in range(len(batch)) if j != i]
        j = others[int(rng.integers(len(others)))]
        out.append(blend_noise(rng, audio, batch[j], target_snr_db,
                               float(rng.random())))
    return out
