"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, ``build/kernels/lib<name>.so`` beside the
package, and loaded with ctypes. Nothing is built when a module is imported:
the first launch builds, so the CPU-only tests can import every module.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# the largest dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232448

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

P, I = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels(build_dir: Path = BUILD_DIR, defines: Tuple[str, ...] = (),
                  stems: Tuple[str, ...] = ()) -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` (or those named in ``stems``) into
    ``build_dir/lib<name>.so``, one ``nvcc`` per source, all started
    together, with ``-D`` for each of ``defines`` (the LSTM kernels' timing
    variants, ``bench_lstm.phases``). A library newer than its source and
    every shared header is kept. Returns the compiler's messages (registers,
    shared memory, spills) per source; raises if any build fails."""
    build_dir.mkdir(parents=True, exist_ok=True)
    headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")), default=0.0)
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    logs: Dict[str, str] = {}
    for src in sorted(CSRC.glob("*.cu")):
        if stems and src.stem not in stems:
            continue
        out = build_dir / f"lib{src.stem}.so"
        if out.exists() and out.stat().st_mtime >= max(src.stat().st_mtime, headers):
            logs[src.stem] = "up to date"
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp, str(src)]
        procs.append((src.stem, Path(tmp), out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for stem, tmp, out, proc in procs:
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{stem} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


@functools.cache
def _built() -> None:
    build_kernels()


def load(stem: str, signatures: Dict[str, Tuple[list, object]],
         build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (once per process) and load ``lib<stem>.so`` (from
    ``build_dir``, where a caller built a variant itself), declaring each
    function's ``argtypes`` and ``restype``."""
    if build_dir == BUILD_DIR:
        _built()
    lib = ctypes.CDLL(str(build_dir / f"lib{stem}.so"))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def _runtime() -> ctypes.CDLL:
    return load("lstm_recurrence", {"caiman_cuda_error_string": ([I], ctypes.c_char_p)})


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = _runtime().caiman_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(ref: torch.Tensor, named: Dict[str, Tuple[torch.Tensor, tuple, object]],
                   what: str) -> None:
    """Each operand must lie on ``ref``'s device, be contiguous and have the
    given shape and dtype (None: any)."""
    for name, (t, shape, dtype) in named.items():
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} on {t.device}, expected {ref.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def counted(fn: Callable) -> Callable:
    """Give a kernel wrapper its launch count (``fn.launches``, a plain int
    the wrapper adds to where it launches)."""
    fn.launches = 0
    return fn
