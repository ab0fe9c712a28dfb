"""Streaming state carried between calls (mirrors
``caiman_asr_tpu/models/state.py``). Hidden and cell states are [L, B, H];
the prediction net also carries the last emitted token [B, 1], re-embedded
as the next segment's start-of-sequence input."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

HC = Tuple[torch.Tensor, torch.Tensor]


class EncoderState(NamedTuple):
    pre_rnn: HC
    post_rnn: HC


class PredNetState(NamedTuple):
    next_to_last_pred_state: HC
    last_token: torch.Tensor


class RNNTState(NamedTuple):
    enc_state: EncoderState
    pred_net_state: PredNetState
