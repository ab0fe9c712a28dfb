"""The published front end: 16 kHz audio -> 80 log-mel bins every 10 ms
(25 ms periodic Hann windows, 512-point DFT, Slaney mel scale, natural log
with a 1e-20 floor, 0.97 pre-emphasis with a clamped border, 15 ms of
leading zeros) -> normalisation -> 3 frames stacked, every 3rd kept
(``frame_splicing``) -> SpecAugment in training."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.precision import PRECISIONS, Precision

FP32 = PRECISIONS["fp32"]

SR, WIN, HOP, N_FFT, N_MELS = 16000, 400, 160, 512, 80
PREEMPH, LEAD_ZEROS = 0.97, 240


def mel_filterbank() -> np.ndarray:
    """[257, 80] Slaney-scale, area-normalised triangles (float64 maths)."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * f_sp)

    freqs = np.linspace(0, SR / 2, N_FFT // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SR / 2), N_MELS + 2))
    fb = np.zeros((freqs.size, N_MELS))
    for m in range(N_MELS):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        tri = np.minimum((freqs - lo) / max(c - lo, 1e-10), (hi - freqs) / max(hi - c, 1e-10))
        fb[:, m] = np.maximum(0.0, tri) * 2.0 / (hi - lo)
    return fb.astype(np.float32)


def _bases(device):
    n = np.arange(WIN)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / WIN)
    ang = -2 * np.pi * n[:, None] * np.arange(N_FFT // 2 + 1)[None, :] / N_FFT
    t = lambda a: torch.from_numpy((a * win[:, None]).astype(np.float32)).to(device)  # noqa: E731
    return t(np.cos(ang)), t(np.sin(ang)), torch.from_numpy(mel_filterbank()).to(device)


def log_mel(audio: torch.Tensor, lens: torch.Tensor, dither: float = 0.0,
            gen: Optional[torch.Generator] = None, pr: Precision = FP32
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio [B, S] float32, lens [B] -> (log-mels [B, 80, T], frame counts [B]);
    the DFT and the filterbank as products of ``pr``."""
    dev = audio.device
    x = torch.nn.functional.pad(audio.float(), (LEAD_ZEROS, 0))
    n = lens.to(dev).long() + LEAD_ZEROS
    inside = torch.arange(x.shape[1], device=dev)[None] < n[:, None]
    if dither:
        x = x + torch.where(inside, dither * torch.randn(x.shape, generator=gen, device=dev), 0.0)
    x = x - PREEMPH * torch.cat([x[:, :1], x[:, :-1]], dim=1)
    T = max(0, (x.shape[1] - WIN) // HOP + 1)
    frames = x.unfold(1, WIN, HOP)[:, :T]
    cos_b, sin_b, fb = _bases(dev)
    power = pr.mm(frames, cos_b) ** 2 + pr.mm(frames, sin_b) ** 2
    mel = torch.log(torch.clamp(pr.mm(power, fb), min=1e-20))
    frame_lens = torch.clamp((n - WIN) // HOP + 1, min=0)
    valid = torch.arange(T, device=dev)[None, :, None] < frame_lens[:, None, None]
    return torch.where(valid, mel, 0.0).transpose(1, 2), frame_lens


def normalize_utterance(mel: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Each utterance by its own mean and population variance per bin."""
    T = mel.shape[2]
    m = torch.arange(T, device=mel.device)[None, None, :] < lens[:, None, None]
    n = lens[:, None, None].clamp(min=1).float()
    mean = torch.where(m, mel, 0.0).sum(2, keepdim=True) / n
    var = torch.where(m, (mel - mean) ** 2, 0.0).sum(2, keepdim=True) / n
    return torch.where(m, (mel - mean) / torch.sqrt(var + 1e-9), 0.0)


def normalize_dataset(mel: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return (mel - mean[None, :, None]) / (std[None, :, None] + 1e-9)


def splice(mel: torch.Tensor, lens: torch.Tensor, stack: int = 3, sub: int = 3):
    """[B, M, T] -> [B, M * stack, ceil(T / sub)]: frame t is frames t..t+2."""
    T = mel.shape[2]
    parts = [torch.nn.functional.pad(mel[:, :, k:], (0, k)) for k in range(stack)]
    out = torch.cat(parts, dim=1)[:, :, ::sub]
    return out, -(-lens // sub) if T else lens


def _bands(u_w, u_s, w_min: int, w_max, size: int) -> torch.Tensor:
    """True where masked, [B, size]: band k is ``floor(u_w[:, k] * (w_max -
    w_min + 1)) + w_min`` wide from ``floor(u_s[:, k] * max(1, size - width +
    1))``."""
    w = (u_w * (w_max - w_min + 1).float()[:, None]).to(torch.int32) + w_min
    s = (u_s * torch.clamp(size - w + 1, min=1).float()).to(torch.int32)
    ix = torch.arange(size, device=u_w.device)[None, None, :]
    return ((ix >= s[..., None]) & (ix < (s + w)[..., None])).any(dim=1)


def spec_augment(feats: torch.Tensor, lens: torch.Tensor, cfg: dict,
                 gen: torch.Generator) -> torch.Tensor:
    """Zero ``freq_masks`` bands of ``min_freq``..``max_freq`` features and
    ``time_masks`` bands of ``min_time`` up to ``round(len * max_time)``
    frames (``max_time`` a fraction below 1) over the padded frames; feats
    [B, M, T]. The uniforms are drawn as four [B, n] tensors in the order
    frequency widths, frequency starts, time widths, time starts."""
    B, M, T = feats.shape
    dev = feats.device
    nf, nt = int(cfg["freq_masks"]), int(cfg["time_masks"])
    u = [torch.rand((B, n), generator=gen, device=dev) for n in (nf, nf, nt, nt)]
    full = lambda v: torch.full((B,), v, device=dev, dtype=torch.int64)  # noqa: E731
    fmask = _bands(u[0], u[1], cfg["min_freq"], full(cfg["max_freq"]), M)
    mt = cfg["max_time"]
    w_max = torch.round(lens.float() * mt).long() if 0 < mt < 1 else full(mt)
    tmask = _bands(u[2], u[3], cfg["min_time"], w_max.to(dev), T)
    return torch.where(fmask[:, :, None] | tmask[:, None, :], 0.0, feats)


def train_features(audio, lens, spec_cfg: dict, gen: torch.Generator, dither: float,
                   pr: Precision = FP32):
    """Training features [T, B, 240] and their lengths, per-utterance
    normalisation (the mel ramp not yet begun)."""
    mel, fl = log_mel(audio, lens, dither, gen, pr)
    mel = normalize_utterance(mel, fl)
    feats, fl = splice(mel, fl)
    feats = spec_augment(feats, fl, spec_cfg, gen)
    return feats.permute(2, 0, 1), fl


def stream_features(audio, lens, mean, std, pr: Precision = FP32):
    """A stream's features [T, B, 240] as the streaming front end sees them:
    dataset statistics, no dither."""
    mel, fl = log_mel(audio, lens, pr=pr)
    feats, fl = splice(normalize_dataset(mel, mean, std), fl)
    return feats.permute(2, 0, 1), fl
