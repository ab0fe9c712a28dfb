"""Host-side schedules of the scalars the train step takes each iteration
(``caiman_asr_tpu/training/schedules.py``):

- ``ConstantSchedule`` / ``StepSchedule``: the delay and star penalties;
  a StepSchedule flips from its initial to its final value at a toggle step
  or once the dev WER drops below a threshold, and stays there.
- ``GradNoiseSchedule``: the std of the Gaussian noise on the encoder's
  gradients, ``noise_level / (1 + step - start_step) ** decay_const``; the
  step draws the noise itself (``training/step.py``).
- ``MelNormRamp``: the mel-normalisation blend ratio, from ``start_ratio``
  (utterance statistics) to 1 (dataset statistics) linearly over a window of
  steps; ``data/featurize.FeaturePipeline`` takes it as
  ``dataset_to_utt_ratio``.

Plain Python floats, so the values equal the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


class ConstantSchedule:
    def __init__(self, value: float):
        self._value = float(value)

    def step(self, train_step: int, *, hints: Optional[Dict[str, Any]] = None) -> float:
        return self._value

    def value(self) -> float:
        return self._value


class StepSchedule:
    """Jump from initial_value to final_value at toggle_step or when
    hints["wer"] < wer_threshold; sticky once triggered."""

    def __init__(
        self,
        initial_value: float,
        final_value: float = 1.0,
        toggle_step: Optional[int] = None,
        wer_threshold: Optional[float] = None,
    ):
        if toggle_step is None and wer_threshold is None:
            raise ValueError("StepSchedule needs a toggle_step or a wer_threshold")
        self.initial_value = initial_value
        self.final_value = final_value
        self.toggle_step = toggle_step
        self.wer_threshold = wer_threshold
        self.set = False

    def step(self, train_step: int, *, hints: Optional[Dict[str, Any]] = None) -> float:
        if not self.set:
            wer = None if hints is None else hints.get("wer")
            if self.wer_threshold is not None and wer is not None and wer < self.wer_threshold:
                self.set = True
            if self.toggle_step is not None and train_step >= self.toggle_step:
                self.set = True
        return self.value()

    def value(self) -> float:
        return self.final_value if self.set else self.initial_value


def build_schedule(
    constant: Optional[float] = None,
    initial_value: Optional[float] = None,
    final_value: float = 1.0,
    toggle_step: Optional[int] = None,
    wer_threshold: Optional[float] = None,
):
    """A ConstantSchedule when ``constant`` is given, else a StepSchedule
    (the delay and star penalty builders of the training setup)."""
    if constant is not None:
        return ConstantSchedule(constant)
    return StepSchedule(initial_value or 0.0, final_value, toggle_step, wer_threshold)


@dataclass
class GradNoiseSchedule:
    """std(step) = noise_level / (1 + step - start_step) ** decay_const,
    0 before start_step."""

    noise_level: float = 0.15
    decay_const: float = 0.55
    start_step: int = 1

    def __post_init__(self):
        if not self.noise_level > 0:
            raise ValueError(f"noise_level must be positive, got {self.noise_level}")
        if not self.decay_const >= 0:
            raise ValueError(f"decay_const must be non-negative, got {self.decay_const}")
        if not self.start_step >= 1:
            raise ValueError(f"start_step must be at least 1, got {self.start_step}")

    def std(self, step: int) -> float:
        if step < self.start_step:
            return 0.0
        return self.noise_level / (1 + step - self.start_step) ** self.decay_const


@dataclass
class MelNormRamp:
    """The dataset_to_utt_ratio: ``start_ratio`` up to ramp_start_step,
    rising linearly to 1.0 at ramp_end_step."""

    ramp_start_step: int
    ramp_end_step: int
    start_ratio: float = 0.0

    def ratio(self, step: int) -> float:
        if step <= self.ramp_start_step:
            return self.start_ratio
        if step >= self.ramp_end_step:
            return 1.0
        frac = (step - self.ramp_start_step) / (self.ramp_end_step - self.ramp_start_step)
        return self.start_ratio + (1.0 - self.start_ratio) * frac

    def complete(self, step: int) -> bool:
        return step >= self.ramp_end_step
