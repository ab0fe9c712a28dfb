"""The yardstick's shared arithmetic: peak rates, roofline bounds, operation
counts, the device's busy time from a profiler trace, seeds, and the
synthetic audio every traffic mix draws from.

Copied, and frozen here, from the program's own measuring code:
``bound_ms`` and ``recurrence_bound_ms`` from ``chip_smoke.py``; the union
of device spans from ``caiman_asr_tpu_torch/bench_serving.busy_share``;
``k1_times`` from ``bench_serving.k1_times``; ``pack_cap`` from
``caiman_asr_tpu_torch/training/pack.pack_cap``; the signal model of
``synthetic_audio`` from ``chip_smoke.synthetic_audio`` (vectorised on the
device)."""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Tuple

import torch

# peak rates of one H100 SXM (NVIDIA's data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
SR = 16000


def derive_seed(*parts) -> int:
    """A 63-bit seed from the run's seed and tags (any ints or strings)."""
    h = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def bound_ms(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """The larger of bytes over the HBM rate and operations over the peak
    for the type: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def recurrence_bound_ms(T: int, dtype: str, B: int, H: int) -> Tuple[float, str]:
    """Least time for one layer's recurrence: w_hh read once, gx read, ys and
    cs written, h0/c0 read, against HBM rate; 2*B*H*4H FLOPs per step against
    the peak for the type. Returns (ms, what bounds it)."""
    es = 4 if dtype == "float32" else 2
    nbytes = es * (4 * H * H + T * B * 4 * H + 2 * T * B * H + 2 * B * H)
    return bound_ms(nbytes, 2.0 * B * H * 4 * H * T, dtype)


# ------------------------------------------------------------ operations
def lstm_flops(rows: int, n_in: int, H: int) -> float:
    """One LSTM layer's products over ``rows`` (frame, utterance) pairs:
    the input and the recurrent product."""
    return 2.0 * rows * (n_in + H) * 4 * H


def model_forward_flops(rnnt: dict, K: int, pre_rows: int, post_rows: int, pred_rows: int,
                        lattice_rows: int) -> float:
    """The RNN-T's forward products at the given valid rows: pre-stack
    frames, post-stack frames, predictor positions (labels + 1), lattice
    positions (the joint's rows)."""
    H, Hp, Hj = rnnt["enc_n_hid"], rnnt["pred_n_hid"], rnnt["joint_n_hid"]
    k = rnnt["enc_stack_time_factor"]
    fl = 0.0
    for i in range(rnnt["enc_pre_rnn_layers"]):
        fl += lstm_flops(pre_rows, rnnt["in_feats"] if i == 0 else H, H)
    for i in range(rnnt["enc_post_rnn_layers"]):
        fl += lstm_flops(post_rows, k * H if i == 0 else H, H)
    for i in range(rnnt["pred_rnn_layers"]):
        fl += lstm_flops(pred_rows, Hp, Hp)
    fl += 2.0 * post_rows * H * Hj + 2.0 * pred_rows * Hp * Hj
    fl += 2.0 * lattice_rows * Hj * K
    return fl


def lstm_stack_bound_ms(rnnt: dict, pre_rows: int, post_rows: int, pred_rows: int,
                        T_pre: int, T_post: int, U1: int, B: int, dtype: str = "bfloat16"
                        ) -> float:
    """The LSTM stacks' least time, forward and backward (three times the
    forward): each layer's input product and its recurrence at the valid
    rows, bytes as ``recurrence_bound_ms`` counts them plus the input
    product's weights, each layer bounded on its own and summed."""
    H, Hp = rnnt["enc_n_hid"], rnnt["pred_n_hid"]
    es = 2 if dtype == "bfloat16" else 4
    total = 0.0
    stacks = [(rnnt["enc_pre_rnn_layers"], rnnt["in_feats"], H, pre_rows, T_pre),
              (rnnt["enc_post_rnn_layers"], rnnt["enc_stack_time_factor"] * H, H, post_rows,
               T_post),
              (rnnt["pred_rnn_layers"], Hp, Hp, pred_rows, U1)]
    for layers, n_in0, Hh, rows, T in stacks:
        for i in range(layers):
            n_in = n_in0 if i == 0 else Hh
            nbytes = es * (4 * Hh * Hh + 4 * Hh * n_in + T * B * (n_in + 4 * Hh + 2 * Hh)
                           + 2 * B * Hh)
            total += bound_ms(3 * nbytes, 3 * lstm_flops(rows, n_in, Hh), dtype)[0]
    return total


def joint_bound_ms(rows: int, Hj: int, K: int) -> Tuple[float, str]:
    """The joint's forward and backward at ``rows`` valid lattice rows in
    bf16: 2*rows*Hj*K operations three times; bytes: the hidden rows, the
    weights, the labels read and the two scores written in the forward;
    the hidden rows and weights read again, their gradients written, in
    the backward."""
    fwd = rows * Hj * 2 + Hj * K * 2 + K * 4 + rows * 8 + rows * 8
    bwd = rows * Hj * 2 + Hj * K * 2 + rows * 8 + rows * Hj * 2 + Hj * K * 4 + K * 4
    return bound_ms(fwd + bwd, 3 * 2.0 * rows * Hj * K, "bfloat16")


def pack_cap(nvalid: int, dense_n: int, quantum: int = 16384, threshold: float = 0.9
             ) -> Optional[int]:
    """The joint's rows when a step packs its valid lattice positions (a copy
    of ``caiman_asr_tpu_torch/training/pack.pack_cap``): ``nvalid`` rounded
    up to a multiple of the larger of ``quantum`` and an eighth of the dense
    size, at most ``dense_n``; None (dense) at ``threshold`` of it or more."""
    q = max(quantum, -(-dense_n // 8))
    cap = min(dense_n, -(-nvalid // q) * q)
    return None if cap >= threshold * dense_n else cap


# ---------------------------------------------------------------- traces
def device_events(prof) -> list:
    """Every kernel and copy on the device, on any stream, from a
    ``torch.profiler`` run: its device events without the host's
    annotations, which the profiler mirrors onto the device's timeline."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() != cuda}
    return [e for e in events if e.device_type() == cuda and e.duration_ns() > 0
            and e.name() not in host]


def busy_spans(prof) -> List[Tuple[int, int]]:
    """(start, end) ns of every kernel and copy on the device."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in device_events(prof))


def union_ns(spans: List[Tuple[int, int]]) -> int:
    """The time covered by the union of sorted spans."""
    busy, end = 0, None
    for a, b in spans:
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(spans: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The gaps in [lo, hi] where no span runs."""
    gaps, cur = [], lo
    for a, b in spans:
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def trace_summary(prof, window_ns: Tuple[int, int], host_prof=None,
                  host_window_ns: Optional[Tuple[int, int]] = None, top: int = 10) -> dict:
    """busy_s and window_s of the traced window, and the breakdown: the
    device operations that took most time, and the idle gaps' seconds by
    the host operation open at each gap's start. ``prof`` traced the device
    alone; the gaps come from ``host_prof``, which traced the host's
    operations too (and so ran slower where the host paces the device)."""
    def clipped(p, win):
        spans = [s for s in busy_spans(p) if s[1] > win[0] and s[0] < win[1]]
        return [(max(a, win[0]), min(b, win[1])) for a, b in spans]

    busy = union_ns(clipped(prof, window_ns))
    ops: Dict[str, float] = {}
    for e in device_events(prof):
        if window_ns[0] <= e.start_ns() < window_ns[1]:
            ops[e.name()] = ops.get(e.name(), 0.0) + e.duration_ns() / 1e9
    gaps: Dict[str, float] = {}
    if host_prof is not None:
        cuda = torch.autograd.DeviceType.CUDA
        host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                      for e in host_prof.profiler.kineto_results.events()
                      if e.device_type() != cuda and e.duration_ns() > 0)
        j, open_ = 0, []
        for a, b in idle_gaps(clipped(host_prof, host_window_ns), *host_window_ns):
            while j < len(host) and host[j][0] <= a:
                open_.append(host[j])
                j += 1
            open_ = [h for h in open_ if h[1] > a]
            name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "(no host operation)"
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    rank = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy / 1e9, "window_s": (window_ns[1] - window_ns[0]) / 1e9,
            "host_traced_window_s": (None if host_window_ns is None
                                     else (host_window_ns[1] - host_window_ns[0]) / 1e9),
            "breakdown": {"device_ops": rank(ops), "idle_gaps": rank(gaps)}}


def profiled(fn, host: bool):
    """Run ``fn()`` under ``torch.profiler``, the device idle before and
    after; returns (prof, (start_ns, end_ns) of the window on the
    profiler's clock). With ``host`` False the profiler traces the device
    alone and two marker kernels bound the window; with ``host`` True it
    records every host operation too, which slows a host-bound loop more
    (a base-85M step: 2.09 s untraced, 2.50 traced on the device alone,
    3.05 with the host's operations, on one H100)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        if host:
            with torch.profiler.record_function("bench_window"):
                fn()
                torch.cuda.synchronize()
        else:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    if host:
        win = [e for e in prof.profiler.kineto_results.events() if e.name() == "bench_window"]
        if not win:
            raise RuntimeError("the profiler recorded no window")
        return prof, (win[0].start_ns(), win[0].start_ns() + win[0].duration_ns())
    spans = busy_spans(prof)
    if len(spans) < 2:
        raise RuntimeError("the profiler recorded no device activity")
    return prof, (spans[0][0], max(b for _, b in spans))


def traced(fn) -> dict:
    """``trace_summary`` of ``fn()`` run twice: under a trace of the device
    alone (busy_s, window_s, the device operations), then under a trace of
    the host's operations too (the idle gaps by host operation)."""
    prof, win = profiled(fn, host=False)
    host_prof, host_win = profiled(fn, host=True)
    return trace_summary(prof, win, host_prof, host_win)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """ms a call of ``fn`` by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k1_times(batch: int, H: int, dtype=torch.bfloat16, reps: int = 20) -> Dict[int, float]:
    """K1 (``lstm_kernel.lstm_recurrence``) alone at the tick's shapes, T=2
    and T=1, at ``batch`` lanes, on random inputs: {T: ms a call}."""
    from caiman_asr_tpu_torch.ops import lstm_kernel

    g = torch.Generator(device="cuda").manual_seed(0)
    w_hh = ((torch.rand((4 * H, H), generator=g, device="cuda") * 2 - 1) / H ** 0.5).to(dtype)
    h0 = (torch.randn((batch, H), generator=g, device="cuda") * 0.1).to(dtype)
    out = {}
    for T in (2, 1):
        gx = (torch.randn((T, batch, 4 * H), generator=g, device="cuda") * 0.5).to(dtype)
        out[T] = cuda_ms(lambda: lstm_kernel.lstm_recurrence(gx, w_hh, h0, h0), reps)
    return out


# ----------------------------------------------------------------- audio
def synthetic_recordings(n: int, seconds: float, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` recordings [n, seconds * 16 kHz] float32: a few harmonics of a
    90-250 Hz fundamental under a slow amplitude envelope, plus noise."""
    S = int(seconds * SR)
    t = torch.arange(S, device=device, dtype=torch.float64)[None] / SR
    u = torch.rand((n, 7), generator=gen, device=device, dtype=torch.float64)
    f0 = 90 + 160 * u[:, :1]
    env_f = 1 + 3 * u[:, 1:2]
    sig = torch.zeros((n, S), device=device)
    for k in range(1, 6):
        # the phase in float64 turns, its fraction in float32
        turns = (f0 * k) * t + u[:, 1 + k:2 + k]
        sig += torch.sin(2 * math.pi * torch.frac(turns).float()) / k
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * torch.frac(env_f * t).float())
    noise = torch.randn((n, S), generator=gen, device=device)
    return 0.1 * env * sig + 0.01 * noise


def to_int16_grid(x: torch.Tensor) -> torch.Tensor:
    """Audio rounded to the int16 grid (as 16-bit PCM carries it), int16."""
    return torch.round(x * 32768.0).clamp(-32768, 32767).to(torch.int16)


def quantile(xs: List[float], q: float) -> Optional[float]:
    """The ``q`` quantile by nearest rank (the value at ceil(q n))."""
    if not xs:
        return None
    s = sorted(xs)
    return s[min(max(math.ceil(q * len(s)) - 1, 0), len(s) - 1)]
