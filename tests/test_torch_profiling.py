"""The port's profiling hooks (``caiman_asr_tpu_torch/log/profiling.py``)
against the JAX package's: ``PhaseTimers``' summary and dump have the same
keys and counts, ``ResourceRecorder`` writes the same CSV columns, and
``Profiler`` writes a Chrome trace of ``torch.profiler``."""

import json
import time

import pytest
import torch

from caiman_asr_tpu.log import profiling as jax_profiling
from caiman_asr_tpu_torch.log import profiling


def _drive(timers):
    for name, n in (("dataloading", 3), ("feat_proc", 2), ("fwd_bwd", 1)):
        for _ in range(n):
            with timers.phase(name):
                time.sleep(0.001)


def test_phase_timers_dump_as_jax(tmp_path):
    got, want = profiling.PhaseTimers(tmp_path / "p"), jax_profiling.PhaseTimers(tmp_path / "j")
    _drive(got)
    _drive(want)
    assert list(got.summary()) == list(want.summary()) == list(got.PHASES)
    for g, w in zip(got.summary().values(), want.summary().values()):
        assert g.keys() == w.keys() == {"total_s", "count", "mean_ms"}
        assert g["count"] == w["count"]
    got.dump(7)
    want.dump(7)
    a = json.loads((tmp_path / "p" / "benchmark" / "timings_step7.json").read_text())
    b = json.loads((tmp_path / "j" / "benchmark" / "timings_step7.json").read_text())
    assert {k: (v.keys(), v["count"]) for k, v in a.items()} == {
        k: (v.keys(), v["count"]) for k, v in b.items()}
    got.reset()
    assert got.summary() == {}
    profiling.PhaseTimers(None).dump(1)  # no directory: nothing written


def test_resource_recorder_writes_the_jax_columns(tmp_path):
    rec = profiling.ResourceRecorder(tmp_path, interval=0.2, enabled=True)
    rec.start()
    time.sleep(0.7)
    rec.stop()
    lines = (tmp_path / "profile" / "resources.csv").read_text().splitlines()
    assert lines[0] == "time_s,cpu_pct,rss_mb,host_mem_used_mb"
    assert len(lines) >= 2
    t, cpu, rss, host = map(float, lines[1].split(","))
    assert rss > 10 and host > 10 and cpu >= 0
    off = profiling.ResourceRecorder(tmp_path / "off")
    off.start()
    off.stop()
    assert not (tmp_path / "off").exists()


@pytest.mark.parametrize("enabled", [False, True])
def test_profiler_writes_a_chrome_trace(tmp_path, enabled):
    prof = profiling.Profiler(tmp_path, enabled=enabled)
    prof.start()
    torch.ones(64, 64) @ torch.ones(64, 64)
    prof.stop()
    trace = tmp_path / "profile" / "trace.json"
    assert trace.exists() == enabled
    if enabled:
        assert "traceEvents" in json.loads(trace.read_text())
