"""A cell as the harness finds it by name, and what a run of it records."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json``: its configuration file, its
    traffic file (``traffic/<traffic>.json``) and its limits
    (``limits/<workload>.json``)."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    # a reading outside the benchmark's own runs: the control ("fp8") or a
    # fault planted in the reference put in the program's place
    control: str = ""
    # the streaming cells' lanes, where a sweep sets them
    lanes: Optional[int] = None


def find_cell(bench: dict, workload: str, **kw) -> Cell:
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    return Cell(name=workload, chips=wl["chips"], config=load_json(ROOT / cfg["file"]),
                traffic=load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{workload}.json"), **kw)


@dataclass
class Record:
    """What a run measured, for the metric readers (``metrics/<name>.py``)."""

    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    values: Dict[str, Any] = field(default_factory=dict)   # the driver's raw readings
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    trace: Optional[dict] = None     # busy_s, window_s, breakdown

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = {"value": float(value), "limit": float(limit)}


def now() -> float:
    return time.perf_counter()
