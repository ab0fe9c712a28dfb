"""Automatic encoder batch-size reduction (mirrors
``caiman_asr_tpu/decoding/unbatch.py``): split a batch so that
``T * B_sub * in_feats <= max_inputs_per_batch`` and encode the slices one
after another, so that long utterances do not exhaust device memory."""

from __future__ import annotations

from typing import Tuple

import torch


def compute_sub_batch_size(T: int, B: int, feat: int, max_inputs: float) -> int:
    """Largest per-slice batch honouring the element budget (>= 1)."""
    if T * feat <= 0:
        return B
    return max(1, min(B, int(max_inputs // (T * feat))))


def encode_lower_batch_size(
    model, feats: torch.Tensor, feat_lens: torch.Tensor,
    max_inputs_per_batch: float = 1e7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``model.encode`` over batch slices. feats: [T, B, F] time-major."""
    T, B, F = feats.shape
    sub = compute_sub_batch_size(T, B, F, max_inputs_per_batch)
    if sub >= B:
        encs, enc_lens, _ = model.encode(feats, feat_lens)
        return encs, enc_lens
    out_encs, out_lens = [], []
    for start in range(0, B, sub):
        e, el, _ = model.encode(feats[:, start:start + sub], feat_lens[start:start + sub])
        out_encs.append(e)
        out_lens.append(el)
    return torch.cat(out_encs), torch.cat(out_lens)
