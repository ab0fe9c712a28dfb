"""Profiling hooks (the port of ``caiman_asr_tpu/log/profiling.py``;
reference log/profiling.py:12-70 + train.py:204-272).

- ``Profiler``: a ``torch.profiler`` trace of the CPU and, where present,
  the card, written as a Chrome trace (``profile/trace.json``, for
  Perfetto or chrome://tracing) behind ``--profiler``.
- ``PhaseTimers``: coarse per-phase wall-clock accumulation
  (dataloading / feat_proc / fwd_bwd), dumped to
  ``benchmark/timings_step{N}.json`` like the reference's timings files.
- ``ResourceRecorder``: host CPU and memory samples (``/proc``).
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional


class Profiler:
    def __init__(self, output_dir: str | Path, enabled: bool = False):
        self.enabled = enabled
        self.dir = Path(output_dir) / "profile"
        self._prof = None

    def start(self):
        if self.enabled and self._prof is None:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.dir.mkdir(parents=True, exist_ok=True)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def stop(self):
        if self._prof is not None:
            self._prof.stop()
            self._prof.export_chrome_trace(str(self.dir / "trace.json"))
            self._prof = None
            print(f"profiler trace written to {self.dir}")


class PhaseTimers:
    PHASES = ("dataloading", "feat_proc", "fwd_bwd")

    def __init__(self, output_dir: Optional[str | Path] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.output_dir = Path(output_dir) if output_dir else None

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
            for k, v in self.totals.items()
        }

    def dump(self, step: int):
        if self.output_dir is None:
            return
        out = self.output_dir / "benchmark"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"timings_step{step}.json").write_text(
            json.dumps(self.summary(), indent=1)
        )

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class ResourceRecorder:
    """Host-resource sampler (the reference launches nvidia-smi/top recorder
    subprocesses under --profiler, scripts/profile/*): a daemon thread
    appends ``time_s,cpu_pct,rss_mb,host_mem_used_mb`` rows to
    ``profile/resources.csv`` every ``interval`` seconds. Pure /proc —
    no psutil dependency."""

    def __init__(self, output_dir: str | Path, interval: float = 5.0,
                 enabled: bool = False):
        self.enabled = enabled
        self.interval = interval
        self.path = Path(output_dir) / "profile" / "resources.csv"
        self._stop = None
        self._thread = None

    @staticmethod
    def _cpu_times():
        with open("/proc/self/stat") as fh:
            stat = fh.read()
        # fields after the comm field, which may itself contain spaces:
        # split on the CLOSING paren (utime/stime are fields 12/13 there)
        parts = stat.rsplit(")", 1)[1].split()
        return (int(parts[11]) + int(parts[12])) / os_sysconf_clk()

    @staticmethod
    def _rss_mb() -> float:
        import os

        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6

    @staticmethod
    def _host_used_mb() -> float:
        total = avail = 0
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
        return (total - avail) / 1e3

    def start(self):
        if not self.enabled or self._thread is not None:
            return
        import threading

        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text("time_s,cpu_pct,rss_mb,host_mem_used_mb\n")
        self._stop = threading.Event()
        stop, path, interval = self._stop, self.path, self.interval

        def loop():
            t0 = time.time()
            last_t, last_cpu = t0, ResourceRecorder._cpu_times()
            while not stop.wait(interval):
                now = time.time()
                cpu = ResourceRecorder._cpu_times()
                pct = 100.0 * (cpu - last_cpu) / max(now - last_t, 1e-9)
                last_t, last_cpu = now, cpu
                with open(path, "a") as fh:
                    fh.write(
                        f"{now - t0:.1f},{pct:.1f},"
                        f"{ResourceRecorder._rss_mb():.1f},"
                        f"{ResourceRecorder._host_used_mb():.1f}\n"
                    )

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        if self._stop is not None:
            self._stop.set()
            self._thread.join(timeout=2 * self.interval)
            self._stop, self._thread = None, None


def os_sysconf_clk() -> float:
    import os

    return float(os.sysconf("SC_CLK_TCK"))
