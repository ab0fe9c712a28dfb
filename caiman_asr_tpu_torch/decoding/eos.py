"""EOS decoding strategies on normalised log-probabilities (mirrors
``caiman_asr_tpu/decoding/eos.py``)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Union

import torch

NEG_INF = -1.0e30


@dataclass(frozen=True)
class EOSIgnore:
    eos_idx: int


@dataclass(frozen=True)
class EOSBlank:
    eos_idx: int


@dataclass(frozen=True)
class EOSPredict:
    eos_idx: int
    alpha: float = 1.0
    beta: float = 0.0


EOSStrategy = Union[None, EOSIgnore, EOSBlank, EOSPredict]


def apply_eos_strategy(
    logprobs: torch.Tensor, strategy: EOSStrategy, blank_idx: int
) -> torch.Tensor:
    """Adjust log-probabilities [..., K] per strategy; returns a new tensor."""
    if strategy is None:
        return logprobs
    out = logprobs.clone()
    e = strategy.eos_idx
    if isinstance(strategy, EOSIgnore):
        out[..., e] = NEG_INF
        return out
    if isinstance(strategy, EOSBlank):
        out[..., blank_idx] = torch.logaddexp(logprobs[..., blank_idx], logprobs[..., e])
        out[..., e] = NEG_INF
        return out
    if isinstance(strategy, EOSPredict):
        v = logprobs[..., e] * strategy.alpha
        if strategy.beta > 0:
            v = torch.where(v > math.log(strategy.beta), v, NEG_INF)
        out[..., e] = v
        return out
    raise TypeError(f"unknown EOS strategy {strategy!r}")
