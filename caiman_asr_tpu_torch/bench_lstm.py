"""Times the LSTM recurrence kernels (K1, K3a, K3b) on one GPU, beside
their step floor and cuDNN's LSTM layer.

    python -m caiman_asr_tpu_torch.bench_lstm [--shape T,B,H ...] [--dtype bfloat16]
        [--rounds 5] [--cudnn] [--phases]

Prints one JSON line per shape: each kernel's median ms per layer over
``--rounds`` rounds of CUDA-event timing (each round the mean of 10 calls),
the rounds' spread, µs per step, and, where the package has them, the
kernels' plan and the step floor (a persistent grid of the plan's shape
that only passes the step barriers). cuDNN's yardsticks: the inference
layer and the training forward (both with their input GEMM), the backward
(with its dx and weight GEMMs), and each less those GEMMs, timed alone.
``--phases`` adds where a step of K3a and K3b goes (``phases``). The
package is imported from the working directory. ``chip_smoke.py`` uses
``time_kernels`` and ``cudnn_yardsticks`` for its phase 8.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path


def median_ms(fn, rounds: int = 5, reps: int = 10, warmup: int = 2) -> dict:
    """Median over ``rounds`` of the mean device time of ``reps`` calls of
    fn(), with CUDA events; also the rounds themselves."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return {"ms": statistics.median(times), "rounds_ms": times,
            "spread": (max(times) - min(times)) / statistics.median(times)}


def layer_inputs(T: int, B: int, H: int, dtype, seed: int = 0):
    """gx, w_hh, h0, c0 of one layer and the backward's inputs (gates,
    c_prev, cs, dys, dcs, w_hh) from the plain forward, on the card."""
    import torch

    from caiman_asr_tpu_torch.ops import lstm_kernel as lk

    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = 1.0 / math.sqrt(H)
    gx = (torch.randn((T, B, 4 * H), generator=g, device="cuda") * 0.5).to(dtype)
    w_hh = ((torch.rand((4 * H, H), generator=g, device="cuda") * 2 - 1) * bound).to(dtype)
    h0 = (torch.randn((B, H), generator=g, device="cuda") * 0.1).to(dtype)
    c0 = (torch.randn((B, H), generator=g, device="cuda") * 0.1).to(dtype)
    dys = (torch.randn((T, B, H), generator=g, device="cuda") * 0.1).to(dtype)
    dcs = (torch.randn((T, B, H), generator=g, device="cuda") * 0.03).to(dtype)
    _, cs, gs = lk.lstm_recurrence_sg_plain(gx, w_hh, h0, c0, False)
    c_prev = torch.cat([c0[None], cs[:-1]])
    return (gx, w_hh, h0, c0), (gs, c_prev, cs, dys, dcs, w_hh)


def time_kernels(T: int, B: int, H: int, dtype, rounds: int = 5) -> dict:
    """K1, K3a and K3b at [T, B, H]: median ms per layer, spread, µs per
    step; with the plan and the step floor where the package has them."""
    from caiman_asr_tpu_torch.ops import lstm_kernel as lk

    fwd, bwd = layer_inputs(T, B, H, dtype)
    out = {
        "K1": median_ms(lambda: lk.lstm_recurrence(*fwd, False), rounds),
        "K3a": median_ms(lambda: lk.lstm_recurrence_sg(*fwd, False), rounds),
        "K3b": median_ms(lambda: lk.lstm_recurrence_bwd(*bwd, False), rounds),
    }
    for r in out.values():
        r["us_per_step"] = 1e3 * r["ms"] / T
    if hasattr(lk, "lstm_plan"):
        for name, backward in (("K1", False), ("K3a", False), ("K3b", True)):
            plan = lk._plan_on(fwd[0], B, H, backward)
            floor = median_ms(lambda: lk.barrier_loop(T + int(backward), plan), rounds)
            out[name].update(plan=plan, floor_ms=floor["ms"],
                             floor_us_per_step=1e3 * floor["ms"] / T)
    return out


def phases(T: int, B: int, H: int, dtype) -> dict:
    """Where a step of K3a and K3b goes: builds the kernels' timing variants
    (``csrc/lstm_persist.cuh``: LSTM_PHASES, with and without
    LSTM_NO_EXCHANGE) into ``build/kernels/phases*``, runs each once through
    the wrappers at [T, B, H], and returns the median over the middle steps
    of each phase of a step, in µs, for the first and the last block:
    ``barrier`` (from the end of the step's last gate math to the start of
    the next step), and summed over the step's batch groups ``product`` (the
    contraction, its exchange loads included), ``stage`` (waiting for the
    staged inputs) and ``gates`` (the gate math, its stores and the next
    stage's copies issued); ``step``; and ``exchange``, the product's time
    less the variant's without the exchange's loads."""
    from unittest import mock

    import numpy as np
    import torch

    from caiman_asr_tpu_torch.ops import cuda_build
    from caiman_asr_tpu_torch.ops import lstm_kernel as lk

    fwd, bwd = layer_inputs(T, B, H, dtype)
    out = {}
    for name, defines in (("with", ("LSTM_PHASES",)),
                          ("without", ("LSTM_PHASES", "LSTM_NO_EXCHANGE"))):
        d = cuda_build.BUILD_DIR / f"phases_{name}"
        cuda_build.build_kernels(d, defines, ("lstm_recurrence", "lstm_recurrence_bwd"))
        sigs = {"lstm_phases_read": ([cuda_build.P], cuda_build.I)}
        libs = {"K3a": cuda_build.load("lstm_recurrence", {**lk.FWD_SIGNATURES, **sigs}, d),
                "K3b": cuda_build.load("lstm_recurrence_bwd", {**lk.BWD_SIGNATURES, **sigs}, d)}
        with mock.patch.object(lk, "_fwd_lib", lambda: libs["K3a"]), \
                mock.patch.object(lk, "_bwd_lib", lambda: libs["K3b"]):
            for kernel, call in (("K3a", lambda: lk.lstm_recurrence_sg(*fwd)),
                                 ("K3b", lambda: lk.lstm_recurrence_bwd(*bwd))):
                call()
                torch.cuda.synchronize()
                ns = np.zeros((2, 4096, 4), np.uint64)
                cuda_build.check(libs[kernel].lstm_phases_read(ns.ctypes.data), "phases")
                plan = lk._plan_on(fwd[0], B, H, kernel == "K3b")
                groups = -(-(-(-B // plan["bsplit"])) // plan["group"])
                for blk, tag in ((0, "first block"), (1, "last block")):
                    # [step, group, point], the middle steps
                    a = ns[blk, :T * groups].astype(np.int64).reshape(T, groups, 4)
                    a = a[T // 8: T - T // 8]
                    res = out.setdefault(kernel, {}).setdefault(tag, {})
                    res[f"product_{name}"] = float(np.median(
                        (a[:, :, 1] - a[:, :, 0]).sum(1))) / 1e3
                    if name == "with":
                        res.update(
                            barrier=float(np.median(a[1:, 0, 0] - a[:-1, -1, 3])) / 1e3,
                            stage=float(np.median((a[:, :, 2] - a[:, :, 1]).sum(1))) / 1e3,
                            gates=float(np.median((a[:, :, 3] - a[:, :, 2]).sum(1))) / 1e3,
                            step=float(np.median(np.diff(a[:, 0, 0]))) / 1e3)
    for per_block in out.values():
        for res in per_block.values():
            res["product"] = res.pop("product_with")
            res["exchange"] = res["product"] - res.pop("product_without")
    return out


def cudnn_yardsticks(T: int, B: int, H: int, dtype, rounds: int = 5) -> dict:
    """cuDNN's LSTM layer (input width H) at [T, B, H]: the inference call,
    the training forward and the backward (all weights' and dx's gradients),
    each also less the GEMMs cuDNN does beside the recurrence (the input
    projection forward; dx, dW_ih and dW_hh backward), timed alone; whether
    its weights sit in one flat buffer."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    lib = torch.nn.LSTM(H, H, device="cuda", dtype=dtype)
    lib.flatten_parameters()
    flat = (lib.weight_ih_l0.untyped_storage().data_ptr()
            == lib.weight_hh_l0.untyped_storage().data_ptr())
    x = torch.randn((T, B, H), generator=g, device="cuda").to(dtype).requires_grad_()
    state = (torch.zeros((1, B, H), device="cuda", dtype=dtype),) * 2
    dy = torch.randn((T, B, H), generator=g, device="cuda").to(dtype)
    with torch.no_grad():
        infer = median_ms(lambda: lib(x, state), rounds)
    train = median_ms(lambda: lib(x, state), rounds)
    y, _ = lib(x, state)
    leaves = [x, *lib.parameters()]
    back = median_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), rounds)
    xs = x.detach().reshape(T * B, H)
    w_ih = lib.weight_ih_l0.detach()
    dg = torch.randn((T * B, 4 * H), generator=g, device="cuda").to(dtype)
    gemm = median_ms(lambda: torch.matmul(xs, w_ih.t()), rounds)["ms"]
    # dx = dgates @ w_ih, and dW_ih = dgates^T x and dW_hh = dgates^T h_prev,
    # two products of one shape
    bwd_gemms = (median_ms(lambda: torch.matmul(dg, w_ih), rounds)["ms"]
                 + 2 * median_ms(lambda: torch.matmul(dg.t(), xs), rounds)["ms"])
    return {"flat_weights": flat, "layer": infer, "train_forward": train, "backward": back,
            "input_gemm_ms": gemm, "backward_gemms_ms": bwd_gemms,
            "layer_less_gemm_ms": infer["ms"] - gemm,
            "train_forward_less_gemm_ms": train["ms"] - gemm,
            "backward_less_gemms_ms": back["ms"] - bwd_gemms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", default=[],
                    help="T,B,H (default: base-85M's encoder layer 267,16,1024 and "
                         "large-196M's post-stack layer 134,64,1536)")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--cudnn", action="store_true", help="also time cuDNN's yardsticks")
    ap.add_argument("--phases", action="store_true",
                    help="also time each phase of a step (builds the timing variants)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_lstm: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from caiman_asr_tpu_torch.ops import lstm_kernel as lk

    dtype = getattr(torch, args.dtype)
    for shape in args.shape or ["267,16,1024", "134,64,1536"]:
        T, B, H = (int(v) for v in shape.split(","))
        row = {"package": str(Path(lk.__file__).resolve().parents[2]), "T": T, "B": B, "H": H,
               "dtype": args.dtype,
               "device": torch.cuda.get_device_name(0), **time_kernels(T, B, H, dtype, args.rounds)}
        if args.cudnn:
            row["cudnn"] = cudnn_yardsticks(T, B, H, dtype, args.rounds)
        if args.phases:
            row["phases_us"] = phases(T, B, H, dtype)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
