"""Fuzzy top-k logits: emulate the FPGA accelerator's blockwise argmax
(mirrors ``caiman_asr_tpu/decoding/fuzzy.py``). The accelerator reduces the
logits in packets of 8 vectors x 32 lanes and keeps per-lane maxima; every
value that is not its packet-lane maximum becomes the row minimum."""

from __future__ import annotations

import torch


def get_topk_logits(
    logits: torch.Tensor, vecs_in_pkt: int = 8, vec_size: int = 32
) -> torch.Tensor:
    B, K = logits.shape
    if K % (vecs_in_pkt * vec_size):
        raise ValueError(f"vocab size {K} not divisible by {vecs_in_pkt}x{vec_size}")
    r = logits.reshape(B, -1, vecs_in_pkt, vec_size)
    mx = r.amax(dim=2, keepdim=True)
    mn = logits.amin(dim=1, keepdim=True)[:, :, None, None]
    return torch.where(r == mx, r, mn).reshape(B, K)
