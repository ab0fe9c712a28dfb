"""Learning-rate policy: warmup -> hold -> exponential half-life decay
(``caiman_asr_tpu/training/lr.py``):

  a = (step+1)/(warmup+1)                       for step <  warmup
  a = 1                                         for step <  warmup + hold
  a = 0.5 ** ((step - warmup - hold)/half_life) otherwise
  lr = max(a * initial_lr, min_lr)

computed in float32, as the JAX schedule is.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def lr_schedule(initial_lr: float, min_lr: float, warmup_steps: int, hold_steps: int,
                half_life_steps: int) -> Callable[[int], float]:
    """Return step (int) -> lr (float)."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            a = (s + f32(1.0)) / f32(warmup_steps + 1.0)
        elif s < warmup_steps + hold_steps:
            a = f32(1.0)
        else:
            a = f32(0.5) ** ((s - f32(warmup_steps) - f32(hold_steps)) / f32(half_life_steps))
        return float(max(f32(a * f32(initial_lr)), f32(min_lr)))

    return schedule
