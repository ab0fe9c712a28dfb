"""LSTM forward recurrence: the hand-written Hopper kernel, its plain PyTorch
version, its launch count and its build.

Replaces ``caiman_asr_tpu/ops/pallas_lstm.py::_kernel`` (the Pallas TPU
recurrence reached through ``_pallas_recurrence`` / ``lstm_recurrence``).
The CUDA source is ``csrc/lstm_recurrence.cu``.

What bounds it on an H100: per step the work is ``2*B*H*4H`` FLOPs against
``w_hh`` (8 MB in bf16 at H=1024) — at B=16 about 34 MFLOP per step, far too
little to fill the tensor cores, so the least time for a layer is set by
reading ``w_hh`` once and streaming gx, ys and cs, or by the FLOPs at the
card's peak, whichever is larger (``chip_smoke.py`` computes both). The
steps are sequential, so the real limit is per-step latency: the simple
design below launches once per step and re-reads ``w_hh`` from L2/HBM every
step. The Pallas kernel keeps ``w_hh`` resident in VMEM; the Hopper answer
is a persistent cooperative kernel with ``w_hh`` split across the SMs'
shared memory (8 MB / 132 SMs is about 62 KB per SM in bf16) and a
grid-wide sync per step, left for a later change.

The wrapper launches the kernel for CUDA tensors and uses the plain version
only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from caiman_asr_tpu_torch.ops.lstm import gate_math

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# the largest dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232448

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` into ``build/kernels/lib<name>.so``, one
    ``nvcc`` per source, all started together. A library newer than its
    source is kept. Returns the compiler's messages (registers, shared
    memory, spills) per source; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    logs: Dict[str, str] = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"lib{src.stem}.so"
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            logs[src.stem] = "up to date"
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
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
def _recurrence_lib() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    build_kernels()
    lib = ctypes.CDLL(str(BUILD_DIR / "liblstm_recurrence.so"))
    fn = lib.lstm_recurrence_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lstm_recurrence_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lstm_recurrence_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.caiman_cuda_error_string.argtypes = [ctypes.c_int]
    lib.caiman_cuda_error_string.restype = ctypes.c_char_p
    return lib


def lstm_recurrence_plain(
    gates_x: torch.Tensor,
    w_hh: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    hard: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch.

    gates_x: [T, B, 4H] pre-activations (x-projection + bias) in the compute
    dtype; w_hh: [4H, H] in the compute dtype; h0, c0: [B, H]. h and c are
    carried in fp32, h is cast to the weight dtype for the product, which
    accumulates in fp32 (the bf16 products are exact in fp32). Returns
    (ys, cs), each [T, B, H] in the compute dtype.
    """
    dtype = gates_x.dtype
    w_t = w_hh.float().t()
    h = h0.float()
    c = c0.float()
    ys, cs = [], []
    for t in range(gates_x.shape[0]):
        gates = gates_x[t].float() + h.to(w_hh.dtype).float() @ w_t
        h, c = gate_math(gates, c, hard)
        ys.append(h.to(dtype))
        cs.append(c.to(dtype))
    if not ys:
        empty = gates_x.new_empty((0,) + tuple(h0.shape))
        return empty, empty.clone()
    return torch.stack(ys), torch.stack(cs)


def lstm_recurrence(
    gates_x: torch.Tensor,
    w_hh: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    hard: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's forward recurrence; same contract as
    :func:`lstm_recurrence_plain`.

    CPU tensors take the plain version. CUDA tensors launch the kernel, once
    per time step, and add one to ``lstm_recurrence.launches`` per launch;
    anything the kernel does not take raises.
    """
    if gates_x.device.type == "cpu":
        return lstm_recurrence_plain(gates_x, w_hh, h0, c0, hard)
    if gates_x.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x.device}")

    T, B, H4 = gates_x.shape
    H = H4 // 4
    dtype = gates_x.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"lstm_recurrence kernel takes float32 or bfloat16, got {dtype}")
    expect = {"w_hh": (w_hh, (H4, H)), "h0": (h0, (B, H)), "c0": (c0, (B, H))}
    for name, (t, shape) in expect.items():
        if t.device != gates_x.device:
            raise ValueError(f"{name} on {t.device}, gates_x on {gates_x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, gates_x is {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    if not (gates_x.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("gates_x and w_hh must be contiguous")
    if w_hh.data_ptr() % 16:
        raise ValueError("w_hh must be 16-byte aligned")
    lib = _recurrence_lib()
    smem = lib.lstm_recurrence_fwd_smem_bytes(H, _DTYPE_CODE[dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"H={H} needs {smem} B of shared memory per block")

    ys = torch.empty((T, B, H), dtype=dtype, device=gates_x.device)
    cs = torch.empty_like(ys)
    if T == 0:
        return ys, cs
    h_buf = torch.empty((2, B, H), dtype=torch.float32, device=gates_x.device)
    c_buf = torch.empty_like(h_buf)
    h_buf[0].copy_(h0)
    c_buf[0].copy_(c0)
    stream = torch.cuda.current_stream(gates_x.device).cuda_stream
    err = lib.lstm_recurrence_fwd(
        gates_x.data_ptr(), w_hh.data_ptr(), h_buf.data_ptr(), c_buf.data_ptr(),
        ys.data_ptr(), cs.data_ptr(), T, B, H, int(hard), _DTYPE_CODE[dtype],
        stream,
    )
    if err != 0:
        msg = lib.caiman_cuda_error_string(err).decode()
        raise RuntimeError(f"lstm_recurrence_fwd: CUDA error {err}: {msg}")
    lstm_recurrence.launches += T  # one launch per time step
    return ys, cs


lstm_recurrence.launches = 0
