"""Log-mel filterbank front-end in PyTorch.

Mirrors ``caiman_asr_tpu/ops/logmel.py``: initial zero padding of
``sr * (window_size - window_stride)`` samples -> dither (additive
N(0,1) * coeff) -> pre-emphasis 0.97 with clamped border -> power spectrum
(n_fft 512, 25 ms window / 10 ms step, periodic Hann, no centring) ->
80-bin Slaney mel filterbank -> natural log with a 1e-20 floor.

The DFT stays a pair of real matmuls against fixed cos/sin bases with the
window folded in: ``torch.stft`` centres and windows differently, and the
matmul form is what the reference computes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class LogMelConfig:
    """Filterbank config (the ``filterbank_features`` block of a YAML config)."""

    sample_rate: int = 16000
    window_size: float = 0.025
    window_stride: float = 0.01
    n_fft: int = 512
    n_mels: int = 80
    dither: float = 1e-5
    preemph: float = 0.97
    initial_padding: bool = True
    final_padding_secs: float = 0.0

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)

    @property
    def n_initial_zeros(self) -> int:
        return int(self.sample_rate * (self.window_size - self.window_stride))

    def num_frames(self, n_samples: int) -> int:
        """Frame count without centred windows."""
        return max(0, (n_samples - self.win_length) // self.hop_length + 1)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Slaney-scale, area-normalised triangular mel filterbank [n_bins, n_mels],
    built in float64 and returned as float32."""
    fmax = fmax or sample_rate / 2.0
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / f_sp
        above = f >= min_log_hz
        return np.where(
            above,
            min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
            mel,
        )

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        above = m >= min_log_mel
        return np.where(
            above, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp
        )

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        fb[:, m] *= 2.0 / (hi - lo)  # Slaney area normalisation
    return fb.astype(np.float32)


def dft_bases(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases [win_length, n_bins] for a matmul rFFT (the window
    is zero-padded to n_fft, so only the first win_length rows matter)."""
    n_bins = n_fft // 2 + 1
    t = np.arange(win_length)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


class LogMelFrontend:
    """Batched log-mel feature extractor.

    Call with raw waveforms [B, S] (zero-padded) and sample lengths [B].
    Returns (feats [B, n_mels, T] float32, frame_lens [B] int32).
    """

    def __init__(self, config: LogMelConfig = LogMelConfig(), *, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        cos_b, sin_b = dft_bases(config.n_fft, config.win_length)
        win = hann_window(config.win_length)[:, None]
        self._cos = torch.from_numpy(cos_b * win).to(self.device)
        self._sin = torch.from_numpy(sin_b * win).to(self.device)
        self._fb = torch.from_numpy(
            mel_filterbank(config.sample_rate, config.n_fft, config.n_mels)
        ).to(self.device)

    def __call__(
        self,
        audio: torch.Tensor,
        audio_lens: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` draws the dither noise; it must live on this
        frontend's device. Without one, a generator seeded with 0 is used."""
        cfg = self.config
        audio = audio.to(self.device, torch.float32)
        audio_lens = audio_lens.to(self.device, torch.int64)
        nz = cfg.n_initial_zeros if cfg.initial_padding else 0
        if nz:
            audio = torch.nn.functional.pad(audio, (nz, 0))
            audio_lens = audio_lens + nz
        nf = int(cfg.final_padding_secs * cfg.sample_rate)
        if nf:
            # zeros appended inside each utterance: right-padded batches are
            # already zero there, so only the lengths change
            audio = torch.nn.functional.pad(audio, (0, nf))
            audio_lens = audio_lens + nf
        B, S = audio.shape

        if cfg.dither != 0.0:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            noise = torch.randn(
                audio.shape, generator=generator, device=self.device
            )
            mask = torch.arange(S, device=self.device)[None, :] < audio_lens[:, None]
            audio = audio + torch.where(mask, noise * cfg.dither, 0.0)

        # pre-emphasis with clamped border: y[0] = x[0] - c*x[0]
        prev = torch.cat([audio[:, :1], audio[:, :-1]], dim=1)
        audio = audio - cfg.preemph * prev

        T = cfg.num_frames(S)
        frames = audio.unfold(1, cfg.win_length, cfg.hop_length)[:, :T]
        re = frames @ self._cos
        im = frames @ self._sin
        power = re * re + im * im
        logmel = torch.log(torch.clamp(power @ self._fb, min=1e-20))

        frame_lens = torch.clamp(
            torch.div(audio_lens - cfg.win_length, cfg.hop_length,
                      rounding_mode="floor") + 1,
            min=0,
        ).to(torch.int32)
        valid = torch.arange(T, device=self.device)[None, :, None] < frame_lens[:, None, None]
        logmel = torch.where(valid, logmel, 0.0)
        return logmel.transpose(1, 2), frame_lens


def normalize_batch(
    feats: torch.Tensor,
    frame_lens: torch.Tensor,
    dataset_mean: Optional[torch.Tensor] = None,
    dataset_std: Optional[torch.Tensor] = None,
    dataset_to_utt_ratio: float = 0.0,
    eps: float = 1e-9,
) -> torch.Tensor:
    """Blended per-feature normalisation; feats [B, n_mels, T], frame_lens [B].

    ``ratio`` 1 uses dataset stats only, 0 per-utterance stats (population
    variance over the valid frames); in between, a linear blend of the two
    normalised outputs. Frames past each length come out zero.
    """
    B, M, T = feats.shape
    mask = torch.arange(T, device=feats.device)[None, None, :] < frame_lens[:, None, None]
    n = torch.clamp(frame_lens[:, None, None].to(torch.float32), min=1.0)
    mean = torch.where(mask, feats, 0.0).sum(dim=2, keepdim=True) / n
    var = torch.where(mask, (feats - mean) ** 2, 0.0).sum(dim=2, keepdim=True) / n
    out = (feats - mean) * torch.rsqrt(var + eps)
    if dataset_mean is not None:
        ds = (feats - dataset_mean[None, :, None]) / (dataset_std[None, :, None] + eps)
        out = dataset_to_utt_ratio * ds + (1.0 - dataset_to_utt_ratio) * out
    return torch.where(mask, out, 0.0)
