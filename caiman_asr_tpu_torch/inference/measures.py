"""WER + latency measures over streaming results (the port of
``caiman_asr_tpu/inference/measures.py``; reference:
inference/benchmark/measures.py:13)."""

from __future__ import annotations

from statistics import mean, median
from typing import Dict, List, Optional

from caiman_asr_tpu_torch.evaluate.wer import word_error_rate
from caiman_asr_tpu_torch.inference.transcriber import TranscriptionResult


def measure(
    results: List[TranscriptionResult],
    references: List[str],
    standardize: bool = True,
) -> Dict[str, Optional[float]]:
    hyps = [r.transcript for r in results]
    wer = word_error_rate(hyps, references, standardize=standardize)
    lats: List[float] = []
    for r in results:
        lats.extend(r.finals_latencies())
    lat_sorted = sorted(lats)

    def pct(p):
        if not lat_sorted:
            return None
        return lat_sorted[min(len(lat_sorted) - 1, round(p * (len(lat_sorted) - 1)))]

    return {
        "wer": wer.wer,
        "n_words": wer.num_words,
        "latency_mean": mean(lats) if lats else None,
        "latency_median": median(lats) if lats else None,
        "latency_p90": pct(0.90),
        "latency_p99": pct(0.99),
        "n_responses": len(lats),
    }
