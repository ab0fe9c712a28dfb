"""Dependency-light latency metric aggregation (the port of
``caiman_asr_tpu/latency/measure_latency_lite.py``; reference
latency/measure_latency_lite.py).

Kept import-light so the inference clients can compute the same summary
statistics as the training-side tooling without pulling in the full
framework.
"""

from __future__ import annotations

import math
from statistics import mean, median, pstdev
from typing import Dict, List, Optional, Sequence


def compute_latency_metrics(
    latencies: List[float],
    sil_latency: List[float],
    eos_latency: List[float],
    frame_width: Optional[float],
    percentiles: Sequence[float] = (90, 99),
) -> Dict[str, float]:
    """Summarise emission/endpoint latencies with the reference's key names.

    The expected half-frame wait (the decoder cannot emit a word before the
    frame containing it ends) is subtracted from the emission-latency
    statistics when ``frame_width`` is given.
    """
    metrics: Dict[str, float] = {}

    if sil_latency:
        metrics["mean-SIL-latency"] = mean(sil_latency)
        metrics["median-SIL-latency"] = median(sil_latency)
        metrics["stdev-SIL-latency"] = pstdev(sil_latency)

    if eos_latency:
        metrics["mean-EOS-latency"] = mean(eos_latency)
        metrics["stdev-EOS-latency"] = pstdev(eos_latency)
        metrics["median-EOS-latency"] = median(eos_latency)

    n = len(latencies)
    if not n:
        return metrics

    if frame_width is not None:
        latencies = [x - 0.5 * frame_width for x in latencies]

    metrics["mean-emission-latency"] = mean(latencies)
    metrics["stdev-emission-latency"] = pstdev(latencies)
    metrics["median-emission-latency"] = median(latencies)

    ordered = sorted(latencies)
    for perc in percentiles:
        # nearest-rank percentile: ceil(n*p/100) - 1, not int(n*p/100)
        # (the latter reads one rank high; p90 of 10 values would be the max)
        k = max(0, math.ceil(n * perc / 100) - 1)
        metrics[f"p{perc}-emission-latency"] = ordered[min(n - 1, k)]
    return metrics
