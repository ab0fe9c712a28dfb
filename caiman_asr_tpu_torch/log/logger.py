"""Structured training logger: JSONL file + stdout (+ optional TensorBoard).

Replaces the reference's dllogger/TBLogger stack
(training/caiman_asr_train/log/tb_dllogger.py:113-160) without the NVIDIA
dependency: every ``log`` call appends one JSON line to
``<output_dir>/log_<timestamp>.jsonl`` and pretty-prints to stdout.
TensorBoard writing uses torch.utils.tensorboard when available (torch is a
CPU dep here), gated so the framework has no hard TB requirement. Per-subset
writers ("train", "dev", "dev_ema") mirror the reference's TBLogger layout,
including interval aggregation (``log_grouped``).

The port's copy of ``caiman_asr_tpu/log/logger.py``.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(
        self,
        output_dir: Optional[str | Path] = None,
        enable_tensorboard: bool = False,
        stdout: bool = True,
        log_file: Optional[str | Path] = None,
        timestamp: Optional[str] = None,
    ):
        self.stdout = stdout
        self.jsonl = None
        if log_file is not None:
            Path(log_file).parent.mkdir(parents=True, exist_ok=True)
            self.jsonl = open(log_file, "a")
        elif output_dir is not None:
            out = Path(output_dir)
            out.mkdir(parents=True, exist_ok=True)
            ts = timestamp or str(int(time.time()))
            self.jsonl = open(out / f"log_{ts}.jsonl", "a")
        self._tb = {}
        self._tb_dir = Path(output_dir) / "tb" if output_dir else None
        self._tb_enabled = enable_tensorboard and output_dir is not None
        self._agg: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))

    def _tb_writer(self, subset: str):
        if not self._tb_enabled:
            return None
        if subset not in self._tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb[subset] = SummaryWriter(
                    log_dir=str(self._tb_dir / subset), flush_secs=120
                )
            except Exception:
                self._tb_enabled = False
                return None
        return self._tb[subset]

    def log(self, step, metrics: Dict[str, Any], subset: str = "train"):
        """Log a metrics dict at a step (step may be an (epoch, step) tuple)."""
        rec = {"ts": round(time.time(), 3), "step": step, "subset": subset}
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                clean[k] = v
        rec.update(clean)
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.stdout:
            kv = "  ".join(
                f"{k}: {v:.6g}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in clean.items()
            )
            print(f"[{subset}] step {step}  {kv}", flush=True)
        tb = self._tb_writer(subset)
        if tb is not None:
            tb_step = step[-1] if isinstance(step, (tuple, list)) else step
            for k, v in clean.items():
                if isinstance(v, float):
                    tb.add_scalar(k, v, tb_step)

    def accumulate(self, metrics: Dict[str, float], subset: str = "train"):
        """Buffer metrics for interval-averaged logging (TBLogger parity)."""
        for k, v in metrics.items():
            try:
                self._agg[subset][k].append(float(v))
            except (TypeError, ValueError):
                pass

    def flush_accumulated(self, step, subset: str = "train"):
        if subset in self._agg and self._agg[subset]:
            means = {
                k: sum(v) / len(v) for k, v in self._agg[subset].items() if v
            }
            self._agg[subset].clear()
            self.log(step, means, subset=subset)

    def close(self):
        if self.jsonl:
            self.jsonl.close()
        for w in self._tb.values():
            w.close()


_global_logger: Optional[MetricLogger] = None


def init_log(
    output_dir=None, enable_tensorboard=False, log_file=None, timestamp=None
) -> MetricLogger:
    global _global_logger
    _global_logger = MetricLogger(
        output_dir, enable_tensorboard, log_file=log_file, timestamp=timestamp
    )
    return _global_logger
