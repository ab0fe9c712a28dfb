"""Host-side audio decoding (the port of ``read_audio`` and ``resample`` in
``caiman_asr_tpu/data/audio.py:24-82``).

``.npy``, ``.wav`` (8-, 16- and 32-bit PCM, downmixed) and ``.flac`` (the
port's native decoder) to float32 mono at the target rate. Other formats
raise, as the JAX package does without the optional ``soundfile``, which
the port does not use. The augmentations (speed perturbation and the rest)
are not ported yet.
"""

from __future__ import annotations

import wave
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
