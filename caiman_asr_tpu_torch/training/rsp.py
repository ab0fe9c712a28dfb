"""Random state passing (RSP): the model's streaming state (every LSTM's
h and c, and the predictor's last token) carried from one microbatch into
the next, so that the model learns to decode past its training utterances'
lengths (``caiman_asr_tpu/training/rsp.py``).

A history length drawn from ``seq_len_freq`` says how many consecutive
microbatches one history spans; RSP starts after ``delay`` steps. The train
step (``training/step.py`` with ``rsp=True``) threads the state through its
microbatches, each gated 0/1 by ``RSPController.gates``; no gradient flows
through the carried state.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from caiman_asr_tpu_torch.models.state import EncoderState, PredNetState, RNNTState


def is_rsp_on(seq_len_freq: List[int]) -> bool:
    """A non-zero frequency past the first entry: histories longer than one
    microbatch happen."""
    return sum(seq_len_freq[1:]) > 0


def rsp_delay_default(warmup_steps: int, hold_steps: int, half_life_steps: int) -> int:
    """The default start of RSP: the learning-rate schedule's warmup, hold
    and three half-lives."""
    return warmup_steps + hold_steps + 3 * half_life_steps


def zero_rnnt_state(model, batch_size: int, dtype=torch.float32, *, device) -> RNNTState:
    """An all-zero state of ``model``'s shapes on ``device`` (the carry is
    fp32 whatever the compute dtype); gated like no state at all."""
    cfg = model.cfg

    def hc(layers, hid):
        return (torch.zeros((layers, batch_size, hid), dtype=dtype, device=device),
                torch.zeros((layers, batch_size, hid), dtype=dtype, device=device))

    return RNNTState(
        EncoderState(hc(cfg.enc_pre_rnn_layers, cfg.enc_n_hid),
                     hc(cfg.enc_post_rnn_layers, cfg.enc_n_hid)),
        PredNetState(hc(cfg.pred_rnn_layers, cfg.pred_n_hid),
                     torch.zeros((batch_size, 1), dtype=torch.int32, device=device)),
    )


class RSPController:
    """Host-side gate sequencer.

    ``gates(step, n_micro)`` gives the 0/1 gate of each microbatch of the
    next step: 1 continues from the carried state. A counter of microbatches
    left in the current history runs down and is redrawn from
    ``seq_len_freq`` (numpy's ``default_rng(seed)``, the JAX package's
    stream) when a history ends; the first microbatch of a history, and
    every one before ``delay``, gets 0.
    """

    def __init__(self, seq_len_freq: List[int], delay: int, seed: int = 0):
        self.freq = list(seq_len_freq)
        self.delay = delay
        self.on = is_rsp_on(self.freq)
        self.rng = np.random.default_rng(seed)
        self.remaining = 0  # microbatches left in the current history
        self.fresh = True   # the next microbatch starts a new history

    def _sample(self) -> int:
        probs = np.asarray(self.freq, np.float64)
        probs = probs / probs.sum()
        return int(self.rng.choice(len(self.freq), p=probs)) + 1

    def gates(self, step: int, n_micro: int) -> np.ndarray:
        gates = np.zeros(n_micro, np.float32)
        if not self.on:
            return gates
        for i in range(n_micro):
            if self.remaining == 0:
                self.remaining = self._sample()
                self.fresh = True
            gates[i] = 0.0 if (self.fresh or step < self.delay) else 1.0
            self.fresh = False
            self.remaining -= 1
        return gates

    def reset(self):
        """Drop the carried state: after a skipped (non-finite) step."""
        self.remaining = 0
        self.fresh = True

    def fast_forward(self, n_steps: int, n_micro: int):
        """Consume the gates of steps [0, n_steps), so that a resumed run's
        draws line up with the uninterrupted run's (skipped-step resets are
        not replayed)."""
        for s in range(n_steps):
            self.gates(s, n_micro)
