"""Frame stacking between the front-end and the encoder, and between the
encoder's two LSTM stacks (mirrors ``caiman_asr_tpu/ops/features.py``).
SpecAugment is training-only and is not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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
