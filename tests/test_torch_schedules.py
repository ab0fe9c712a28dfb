"""The port's host schedules (``caiman_asr_tpu_torch/training/schedules.py``)
against the JAX package's: the same values, exactly, step by step."""

import math

import pytest

from caiman_asr_tpu.training import schedules as js
from caiman_asr_tpu_torch.training import schedules as ts

STEPS = (0, 1, 2, 3, 99, 100, 101, 1999, 2000, 2001, 2500, 10 ** 5)


@pytest.mark.parametrize("kw", [
    dict(constant=0.007),
    dict(initial_value=0.0, final_value=0.01, toggle_step=100),
    dict(initial_value=None, final_value=0.5, toggle_step=2000),
    dict(initial_value=0.2, final_value=1.0, wer_threshold=30.0),
    dict(initial_value=0.2, final_value=0.9, toggle_step=2500, wer_threshold=12.5),
])
def test_penalty_schedules_match_jax(kw):
    """Constant and step schedules, toggled by the step or the WER hint,
    sticky once set, over the same sequence of steps and hints."""
    got, want = ts.build_schedule(**kw), js.build_schedule(**kw)
    assert type(got).__name__ == type(want).__name__
    hints = [None, {"wer": None}, {"wer": 50.0}, {"wer": 40.0}, {"wer": 20.0}, {"wer": 10.0},
             None, {"wer": 99.0}, {}, {"wer": 5.0}, None, {"wer": 1.0}]
    for step, hint in zip(STEPS, hints):
        assert got.step(step, hints=hint) == want.step(step, hints=hint)
        assert got.value() == want.value()


def test_step_schedule_needs_a_trigger():
    for mod in (ts, js):
        with pytest.raises(ValueError):
            mod.StepSchedule(0.0)


@pytest.mark.parametrize("kw", [dict(), dict(noise_level=0.3, decay_const=0.0, start_step=5),
                                dict(noise_level=0.05, decay_const=0.55, start_step=2000)])
def test_grad_noise_schedule_matches_jax(kw):
    got, want = ts.GradNoiseSchedule(**kw), js.GradNoiseSchedule(**kw)
    for step in STEPS:
        assert got.std(step) == want.std(step)
    assert got.std(0) == 0.0 and got.std(got.start_step) == got.noise_level


def test_grad_noise_schedule_rejects_what_jax_rejects():
    for kw in (dict(noise_level=0.0), dict(decay_const=-1.0), dict(start_step=0)):
        with pytest.raises(AssertionError):
            js.GradNoiseSchedule(**kw)
        with pytest.raises(ValueError):
            ts.GradNoiseSchedule(**kw)


@pytest.mark.parametrize("kw", [dict(ramp_start_step=100, ramp_end_step=2000),
                                dict(ramp_start_step=0, ramp_end_step=3, start_ratio=0.25)])
def test_mel_norm_ramp_matches_jax(kw):
    got, want = ts.MelNormRamp(**kw), js.MelNormRamp(**kw)
    for step in STEPS + (1050, 1,):
        assert got.ratio(step) == want.ratio(step)
        assert got.complete(step) == want.complete(step)
    assert got.ratio(kw["ramp_start_step"]) == kw.get("start_ratio", 0.0)
    assert math.isclose(got.ratio(kw["ramp_end_step"]), 1.0)
