"""Post-front-end feature processing (mirrors
``caiman_asr_tpu/ops/features.py``): SpecAugment in training, frame
stacking between the front-end and the encoder, and between the encoder's
two LSTM stacks.

SpecAugment's masks are built on the features' device as batched tensor
operations, with no loop over utterances. The random draws are apart from
the arithmetic: ``spec_augment`` draws the uniforms from a generator and
``spec_augment_masks`` turns them into masks, so the same uniforms give the
JAX package's masks bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class SpecAugmentConfig:
    """The ``spec_augment`` block of a config. ``time_masks`` and
    ``max_time`` in (0, 1) are fractions of each utterance's length
    (adaptive SpecAugment, arXiv:1912.05533); ``max_time_masks`` caps the
    adaptive count."""

    freq_masks: int = 2
    min_freq: int = 0
    max_freq: int = 20
    time_masks: float = 10
    min_time: int = 0
    max_time: float = 0.03
    max_time_masks: int = 40


def _adaptive(value: float) -> bool:
    return 0 < value < 1.0


def band_mask(u_w: torch.Tensor, u_s: torch.Tensor, n_masks: Union[int, torch.Tensor],
              w_min: int, w_max: Union[int, torch.Tensor], size: int) -> torch.Tensor:
    """Bands over an axis of ``size``: bool [B, size], True where masked.

    u_w, u_s: [B, n] uniforms in [0, 1), one pair per band. A band's width
    is ``floor(u_w * (w_max - w_min + 1)) + w_min`` and its start
    ``floor(u_s * max(1, size - width + 1))``, in fp32 as the JAX package
    computes them; only the first ``n_masks`` bands are active. ``n_masks``
    and ``w_max`` are ints or [B] integer tensors."""
    B, n = u_w.shape
    dev = u_w.device
    w_max = torch.as_tensor(w_max, device=dev).reshape(-1, 1)
    w = (u_w * (w_max - w_min + 1).float()).to(torch.int32) + w_min
    hi = torch.clamp(size - w + 1, min=1)
    s = (u_s * hi.float()).to(torch.int32)
    active = torch.arange(n, device=dev)[None, :] < torch.as_tensor(
        n_masks, device=dev).reshape(-1, 1)
    ix = torch.arange(size, device=dev, dtype=torch.int32)[None, None, :]
    bands = (ix >= s[..., None]) & (ix < (s + w)[..., None]) & active[..., None]
    return bands.any(dim=1)


def spec_augment_masks(feat_lens: torch.Tensor, n_freq: int, n_time: int,
                       cfg: SpecAugmentConfig, u_fw: torch.Tensor, u_fs: torch.Tensor,
                       u_tw: torch.Tensor, u_ts: torch.Tensor):
    """(frequency mask [B, n_freq], time mask [B, n_time]) from the
    uniforms: u_fw, u_fs [B, freq_masks], u_tw, u_ts [B, n] with n the
    number of time masks, or ``max_time_masks`` when the count is adaptive.
    The time bands span the padded ``n_time``, not each length; adaptive
    counts and widths are ``round(len * fraction)`` (half to even)."""
    fmask = band_mask(u_fw, u_fs, cfg.freq_masks, cfg.min_freq, cfg.max_freq, n_freq)
    lens = feat_lens.to(u_tw.device).float()
    tm, mt = cfg.time_masks, cfg.max_time
    count = torch.round(lens * tm).to(torch.int32) if _adaptive(tm) else int(tm)
    w_max = torch.round(lens * mt).to(torch.int32) if _adaptive(mt) else int(mt)
    tmask = band_mask(u_tw, u_ts, count, cfg.min_time, w_max, n_time)
    return fmask, tmask


def spec_augment(feats: torch.Tensor, feat_lens: torch.Tensor, cfg: SpecAugmentConfig,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """SpecAugment on feats [B, M, T] with lengths [B]: masked entries
    become 0. The band uniforms are drawn from ``generator`` (on the
    features' device)."""
    if generator is None:
        raise ValueError("SpecAugment requires a generator")
    B, M, T = feats.shape
    draw = lambda n: torch.rand((B, n), generator=generator, device=feats.device)
    # time bands drawn: the cap when the count is adaptive (only the first
    # round(len * time_masks) are active)
    n_t = cfg.max_time_masks if _adaptive(cfg.time_masks) else int(cfg.time_masks)
    u_fw, u_fs, u_tw, u_ts = draw(cfg.freq_masks), draw(cfg.freq_masks), draw(n_t), draw(n_t)
    fmask, tmask = spec_augment_masks(feat_lens, M, T, cfg, u_fw, u_fs, u_tw, u_ts)
    return torch.where(fmask[:, :, None] | tmask[:, None, :], 0.0, feats)


def stack_subsample_frames(
    feats: torch.Tensor,
    feat_lens: torch.Tensor,
    stacking: int = 1,
    subsampling: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack ``stacking`` consecutive frames along features, subsample in time.

    feats: [B, M, T] -> [B, M * stacking, ceil(T / subsampling)]. Frame t
    gets frames [t, ..., t+stacking-1] (zero-padded past the end), then
    every ``subsampling``-th frame is kept.
    """
    if stacking > 1 or subsampling > 1:
        parts = [feats] + [
            F.pad(feats[:, :, n:], (0, n)) for n in range(1, stacking)
        ]
        feats = torch.cat(parts, dim=1)[:, :, ::subsampling]
        if subsampling > 1:
            feat_lens = -torch.div(-feat_lens, subsampling, rounding_mode="floor")
    return feats, feat_lens


def stack_time(
    x: torch.Tensor, x_lens: torch.Tensor, factor: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """StackTime: x [T, B, H] -> [ceil(T/factor), B, H*factor]; output frame
    t stacks input frames t*factor + i, zero-padded past T. Lengths become
    ceil(len / factor)."""
    parts = [x] + [F.pad(x[i:], (0, 0, 0, 0, 0, i)) for i in range(1, factor)]
    out = torch.cat(parts, dim=2)[::factor]
    return out, -torch.div(-x_lens, factor, rounding_mode="floor")
