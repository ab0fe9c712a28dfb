"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The cell (``BENCHMARK.json``'s workload) names
a configuration file, a traffic file (``benchmark/traffic/<traffic>.json``,
whose ``driver`` names the module in ``benchmark/drivers/`` that generates
and offers it) and a limits file (``benchmark/limits/<workload>.json``).
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones; each metric is read from the run's record
by ``benchmark/metrics/<metric>.py`` (or, where a family of metrics shares
one, by ``benchmark/metrics/<metric up to its first dot>.py``). The numbers
that decide ``correct`` come last in the line, each beside its limit, and
again as the last lines of standard error.

``--control fp8`` (or a fault of ``reference/train.py``, or several of them
separated by commas) reads the check's numbers with the reference put in
the program's place, one precision below; ``--lanes`` sets a streaming
cell's lanes (the knee sweep). Neither is part of a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "caiman_asr_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def setup_environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))


def reader(name: str):
    """The metric's reader: ``metrics/<name>.py``, or where there is none,
    the reader of its family, ``metrics/<name up to the first dot>.py``
    (``idle_share.py`` reads every ``idle_share.<cell kind>``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports in this kind of run."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def is_correct(rec) -> bool:
    """Every number compared is finite and within its limit (and there is
    at least one)."""
    return bool(rec.checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                    for c in rec.checks.values())


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="")
    p.add_argument("--lanes", type=int, default=None)
    args = p.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").is_file() or not (ROOT / "caiman_asr_tpu_torch").is_dir():
        print("run from a checkout of the repository: BENCHMARK.json and the program are "
              "needed", file=sys.stderr)
        return 2
    setup_environment()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    from benchmark.cell import find_cell

    cell = find_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), t_start=T_START, control=args.control,
                     lanes=args.lanes)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    rec = driver.run(cell)

    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone", file=sys.stderr)
        return 4

    metrics = {}
    for m in cell_metrics(bench, cell.name, cell.trace):
        value = reader(m["name"])(rec)
        if value is None:
            if not cell.trace and not cell.control:
                print(f"end-to-end metric {m['name']} was not measured", file=sys.stderr)
                return 5
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(cell.chips)
    dev["memory_peak_bytes"] = int(rec.memory_peak_bytes)
    line = {"correct": is_correct(rec), "attempted": rec.attempted, "failed": rec.failed,
            "metrics": metrics, "device": dev}
    if cell.trace and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        line["breakdown"] = rec.trace["breakdown"]
    line["values"] = {k: v for k, v in rec.values.items()
                      if not isinstance(v, list) or len(v) <= 16}
    line["checks"] = rec.checks
    for name, c in rec.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
