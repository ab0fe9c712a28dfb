"""LSTM recurrence kernels: the hand-written Hopper kernels, their plain
PyTorch versions, their launch counts and the autograd Function around them.

Replaces the Pallas TPU kernels of ``caiman_asr_tpu/ops/pallas_lstm.py``:

- K1 ``_kernel``: the forward recurrence (``lstm_recurrence``);
- K3a ``_kernel_sg``: K1 that also stores the pre-activations, the forward
  of a step that needs gradients (``lstm_recurrence_sg``); one CUDA source
  with K1, ``csrc/lstm_recurrence.cu``, under a compile-time flag;
- K3b ``_bwd_kernel``: the reverse dh/dc recurrence
  (``lstm_recurrence_bwd``, ``csrc/lstm_recurrence_bwd.cu``).

``LSTMRecurrence`` is the ``jax.custom_vjp`` of ``pallas_lstm.py:326-473``:
its forward runs K3a (or K1 when ``store_gates`` is off, the backward then
recomputing the gates with one matmul), its backward K3b, and
``dW_hh = dgates^T h_prev`` is one ``torch.matmul`` outside the kernel, as
the JAX package leaves it to XLA.

What bounds them on an H100: per step the work is ``2*B*H*4H`` FLOPs against
``w_hh`` (8 MB in bf16 at H=1024) — at B=16 about 34 MFLOP per step, far too
little to fill the card, so the least time for a layer is set by reading
``w_hh`` once and streaming the per-step tensors, or by the FLOPs at the
card's peak, whichever is larger (``chip_smoke.py`` computes both). The
steps are sequential, so the real limit is per-step latency. As the Pallas
kernels keep ``w_hh`` resident in VMEM, each kernel here is one cooperative
launch per layer that keeps ``w_hh`` resident in the SMs' shared memory,
split by hidden units over the blocks, with one grid-wide barrier a step
(``csrc/lstm_persist.cuh``). :func:`lstm_plan` chooses the split; where a
block's rows do not all fit (fp32 at H=1536), the rows that fit stay
resident and the rest are read from L2 every step: the partly resident
mode.

Every wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from typing import Tuple

import torch

from caiman_asr_tpu_torch.ops.cuda_build import (
    DTYPE_CODE, MAX_SMEM_BYTES, I, P, check, check_operands, counted, load, stream_of,
)
from caiman_asr_tpu_torch.ops.lstm import cell_activation, gate_activations, gate_math

Pair = Tuple[torch.Tensor, torch.Tensor]
logger = logging.getLogger(__name__)

Z = ctypes.c_size_t


FWD_SIGNATURES = {
    "lstm_recurrence_fwd": ([P] * 8 + [I] * 12 + [Z, P], I),
    "lstm_recurrence_smem_bytes": ([I] * 8, Z),
    "lstm_barrier_loop": ([P, I, I, I, Z, P], I),
}
BWD_SIGNATURES = {"lstm_recurrence_bwd": ([P] * 10 + [I] * 11 + [Z, P], I)}


@functools.cache
def _fwd_lib():
    return load("lstm_recurrence", FWD_SIGNATURES)


@functools.cache
def _bwd_lib():
    return load("lstm_recurrence_bwd", BWD_SIGNATURES)


# ---------------------------------------------------------------- the plan
# The kernels' layout constants (csrc/lstm_persist.cuh): bf16's partial
# sums per row of their buffer and batch rows a group holds; fp32's chunk
# stages of the contraction and the chunks a plan may take (longest
# first); and the codes their launch returns when the grid cannot all be
# resident or a plan does not fit the shape.
RED_FLOATS_BF16 = 256
MAX_PIECES = 128  # 4-unit pieces of a staged batch row
X_STAGES = 4
CHUNKS = (256, 128, 64, 32)
NOT_CO_RESIDENT, BAD_PLAN = -1, -2
H100_SMS = 132
MAX_BATCH_SPLIT = 4
# The fewest batch rows a slice keeps, forward and backward: the backward's
# exchange (B x 4H a step) is 4x the forward's, and a split paid off there
# from 8 rows (one mma tile) up, in the forward only at 32 (timed with
# bench_lstm.py on an H100 at splits of 1 and 4; PERF.md §6).
MIN_SLICE_ROWS = {False: 32, True: 8}


def _resident_ld(K: int, esize: int) -> int:
    return K + (32 - K) % 64 if esize == 2 else K + 4


def fp32_ksplit(rows: int, group: int) -> int:
    """fp32's parts of the contraction (``fp32_ksplit`` of the kernels):
    256 threads over tiles of 8, 6 or 4 rows (the first that divides the
    rows into a power of two, else 8 or 4) by 8 batch rows of the group
    where that makes at least 8 tiles, else 4."""
    tile = next((t for t in (8, 6, 4) if rows % t == 0 and (rows // t) & (rows // t - 1) == 0),
                8 if rows % 8 == 0 else 4)
    row_tiles = -(-rows // tile)
    tiles = row_tiles * group // (8 if row_tiles * group // 8 >= 8 else 4)
    return 256 // tiles if tiles < 256 else 1


def smem_bytes(rows: int, res_rows: int, K: int, stage_elems: int, esize: int, carry: int,
               chunk: int, group: int) -> int:
    """A block's shared memory, as the kernels compute it (``smem_bytes`` of
    ``csrc/lstm_persist.cuh``): res_rows resident rows of length K, two
    stages of ``stage_elems`` per-step inputs a batch row of a group of
    ``group`` rows, the scratch (bf16's partial sums of ``rows`` rows; in
    fp32 the larger of the chunk stages, the group's rows of the exchange
    and the rows not resident at ``chunk`` floats each, and the partial sums
    they make room for) and ``carry`` fp32 values."""
    if esize == 2:
        scratch = 4 * RED_FLOATS_BF16 * (-(-rows // 16) * 16 + 4)
    else:
        xstage = X_STAGES * (group + rows - res_rows) * (chunk + 4) * 4
        scratch = max(xstage, 4 * fp32_ksplit(rows, group) * (group * rows + 1))
    return (res_rows * _resident_ld(K, esize) * esize + 2 * group * stage_elems * esize
            + scratch + 4 * carry)


def lstm_plan(B: int, H: int, dtype, backward: bool = False, sms: int = H100_SMS) -> dict:
    """How the persistent kernel (K1/K3a forward, K3b ``backward``) splits a
    layer of width H at batch B over the card's ``sms`` SMs, one block each.

    The grid is ``blocks`` x ``bsplit``: each block owns ``units`` hidden
    units (a multiple of 4, the fewest that give at most ``sms`` blocks) and
    one of ``bsplit`` slices of the batch, and keeps its rows of w_hh in
    shared memory: the forward 4 * units rows of w_hh (length H), the
    backward units rows of w_hh^T (length 4H). fp32 also stages the
    contraction through shared memory in chunks of ``chunk`` floats (the
    first of ``CHUNKS`` at which every row stays resident, else the first
    after it at which the block's buffers fit; 0 in bf16), in groups of
    ``group`` batch rows (64 in bf16; in fp32 the slice rounded up to 8 and
    at most 64, or 32, 16 or 8 where that keeps every row resident or reads
    fewer bytes a step), its threads in ``ksplit`` parts of k (fp32; a plan
    whose chunk gives a part no step is taken only where no other fits). ``mode`` is "resident" when all rows fit beside the partial
    sums, the staged inputs and the fp32 carry, else "partial": the first
    ``resident_rows`` stay resident and the rest are read from L2 every
    step (in fp32 staged with the exchange, once a batch group of
    ``group`` rows). The batch split ``bsplit`` is one of ``MAX_BATCH_SPLIT``,
    ..., 2, 1 (powers of two) whose slices hold at least ``MIN_SLICE_ROWS``
    rows each: a block then reads only its slice of the exchange, at the
    cost of twice the units and rows per block. It is the largest whose
    rows all stay resident, else (partly resident) the one that reads the
    fewest bytes from L2 a step; fp32's group likewise. Also returns the
    bytes of shared memory a block asks for (``smem_bytes``), of resident
    rows per block, and per step: the weight bytes read from L2, the
    exchanged state the grid reads (h_{t-1} [B, H] forward, dgates[t+1]
    [B, 4H] backward, once per block of a slice), and their sum with the
    step's own inputs and outputs (``l2_bytes_per_step``).
    """
    if H % 8 or H <= 0:
        raise ValueError(f"hidden size must be a positive multiple of 8, got {H}")
    plans = []
    for bsplit in (MAX_BATCH_SPLIT >> i for i in range(MAX_BATCH_SPLIT.bit_length())):
        slice_rows = -(-B // bsplit)
        if bsplit > 1 and (slice_rows < MIN_SLICE_ROWS[backward]
                           or (bsplit - 1) * slice_rows >= B):
            continue
        top = min(64, -(-slice_rows // 8) * 8)
        groups = {g for g in (top, 32, 16, 8) if g <= top} if dtype.itemsize == 4 else {64}
        for group in sorted(groups, reverse=True):
            try:
                plans.append(_plan_split(B, H, dtype.itemsize, backward, sms, bsplit, group))
            except ValueError:  # these buffers alone do not fit
                pass
    if not plans:
        raise ValueError(f"H={H}, B={B}: no plan fits a block's shared memory")
    # fp32: a chunk short of a 4-column step for each part of k idles threads
    plans = [plan for plan in plans if plan["chunk"] >= 4 * plan["ksplit"]] or plans
    resident = [plan for plan in plans if plan["mode"] == "resident"]
    if resident:
        return resident[0]
    return min(plans, key=lambda plan: plan["l2_bytes_per_step"])


def _plan_split(B: int, H: int, esize: int, backward: bool, sms: int, bsplit: int,
                group: int) -> dict:
    units = 4
    while -(-H // units) * bsplit > sms:
        units += 4
    blocks = -(-H // units)
    rows, K, stage = (units, 4 * H, 8 * units) if backward else (4 * units, H, 4 * units)
    if stage // 4 > MAX_PIECES:
        raise ValueError(f"H={H}: {units} units a block is more than the kernels stage")
    slice_rows = -(-B // bsplit)
    carry = slice_rows * units

    def size(res_rows: int, chunk: int) -> int:
        return smem_bytes(rows, res_rows, K, stage, esize, carry, chunk, group)

    chunks = CHUNKS if esize == 4 else (0,)
    chunk = next((c for c in chunks if size(rows, c) <= MAX_SMEM_BYTES), None)
    if chunk is None:  # partly resident
        chunk = next((c for c in chunks[1:] if size(0, c) <= MAX_SMEM_BYTES), chunks[-1])
    res_rows = next((r for r in range(rows, -1, -1) if size(r, chunk) <= MAX_SMEM_BYTES), None)
    if res_rows is None:
        raise ValueError(f"H={H}, B={B}: a block's buffers alone need {size(0, chunk)} bytes "
                         "of shared memory")
    ld = _resident_ld(K, esize)
    groups = -(-slice_rows // group)
    exchange = blocks * B * K * esize
    weights = blocks * bsplit * groups * (rows - res_rows) * K * esize
    own = B * (8 * H if backward else 6 * H) * esize  # gx, ys, cs / gates, 4 states, dgates
    return {"blocks": blocks, "bsplit": bsplit, "units": units, "rows": rows,
            "resident_rows": res_rows, "mode": "resident" if res_rows == rows else "partial",
            "chunk": chunk, "group": group,
            "ksplit": fp32_ksplit(rows, group) if esize == 4 else 0,
            "smem_bytes": size(res_rows, chunk), "row_bytes": ld * esize, "carry_floats": carry, "resident_bytes": res_rows * K * esize,
            "l2_weight_bytes_per_step": weights, "exchange_bytes_per_step": exchange,
            "l2_bytes_per_step": weights + exchange + own}


@functools.cache
def batch_slices(B: int, H: int, dtype, sms: int = H100_SMS) -> int:
    """The fewest slices of a batch of B rows, each of ``ceil(B / n)`` rows
    but the last, for which :func:`lstm_plan` finds a forward plan: K1 then
    runs once per slice. A block's fp32 carry holds its slice's rows of its
    units (``slice_rows * units * 4`` bytes of shared memory), which a split
    of the grid's batch does not shrink, so past a few thousand rows at
    H=1,024 (on 132 SMs, bf16 above 5,856 rows, fp32 above 6,172) the
    launch must be cut. Raises when not even a slice of one row has a
    plan."""
    for n in range(1, B + 1):
        rows = -(-B // n)
        if n > 1 and (n - 1) * rows >= B:
            continue
        try:
            lstm_plan(rows, H, dtype, False, sms)
            return n
        except ValueError:
            if rows == 1:
                raise
    raise ValueError(f"B={B}: no batch to slice")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _plan(B: int, H: int, dtype, backward: bool, sms: int) -> dict:
    """lstm_plan, logged where it is partly resident."""
    plan = lstm_plan(B, H, dtype, backward, sms)
    if plan["mode"] == "partial":
        logger.info("lstm %s B=%d H=%d %s: %d of %d rows of a block resident, %d bytes of "
                    "w_hh read from L2 a step", "backward" if backward else "forward", B, H,
                    dtype, plan["resident_rows"], plan["rows"],
                    plan["l2_weight_bytes_per_step"])
    return plan


def _plan_on(t: torch.Tensor, B: int, H: int, backward: bool) -> dict:
    return _plan(B, H, t.dtype, backward, _sm_count(t.device.index or 0))


def barrier_loop(T: int, plan: dict, device="cuda") -> None:
    """The step floor of a plan's grid: one cooperative launch of
    ``plan["blocks"]`` x ``plan["bsplit"]`` blocks with its shared memory that only passes T - 1
    step barriers. For timing; no model path runs it."""
    ctr = torch.zeros(1, dtype=torch.int32, device=device)
    err = _fwd_lib().lstm_barrier_loop(ctr.data_ptr(), T, plan["blocks"], plan["bsplit"],
                                       plan["smem_bytes"], stream_of(ctr))
    _check_launch(err, "lstm_barrier_loop", plan)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels read 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_launch(err: int, what: str, plan: dict) -> None:
    if err == NOT_CO_RESIDENT:
        raise ValueError(f"{what}: {plan['blocks']} blocks of {plan['smem_bytes']} bytes of "
                         "shared memory cannot all be resident on this card")
    if err == BAD_PLAN:
        raise ValueError(f"{what}: the kernel refused the plan {plan}")
    check(err, what)


# ------------------------------------------------------------ plain versions
def _recurrence_plain(gates_x, w_hh, h0, c0, hard, store_gates):
    dtype = gates_x.dtype
    w_t = w_hh.float().t()
    h = h0.float()
    c = c0.float()
    ys, cs, gs = [], [], []
    for t in range(gates_x.shape[0]):
        gates = gates_x[t].float() + h.to(w_hh.dtype).float() @ w_t
        if store_gates:
            gs.append(gates.to(dtype))
        h, c = gate_math(gates, c, hard)
        ys.append(h.to(dtype))
        cs.append(c.to(dtype))
    if not ys:
        empty = gates_x.new_empty((0,) + tuple(h0.shape))
        return (empty, empty.clone()) + ((gates_x.new_empty(gates_x.shape),) if store_gates else ())
    out = (torch.stack(ys), torch.stack(cs))
    return out + ((torch.stack(gs),) if store_gates else ())


def lstm_recurrence_plain(gates_x, w_hh, h0, c0, hard: bool) -> Pair:
    """K1's contract in plain PyTorch.

    gates_x: [T, B, 4H] pre-activations (x-projection + bias) in the compute
    dtype; w_hh: [4H, H] in the compute dtype; h0, c0: [B, H]. h and c are
    carried in fp32, h is cast to the weight dtype for the product, which
    accumulates in fp32 (the bf16 products are exact in fp32). Returns
    (ys, cs), each [T, B, H] in the compute dtype.
    """
    return _recurrence_plain(gates_x, w_hh, h0, c0, hard, False)


def lstm_recurrence_sg_plain(gates_x, w_hh, h0, c0, hard: bool):
    """K3a's contract: K1's, also returning gs [T, B, 4H], the full
    pre-activations ``gates_x + h_{t-1} @ w_hh^T`` in the compute dtype."""
    return _recurrence_plain(gates_x, w_hh, h0, c0, hard, True)


def lstm_recurrence_bwd_plain(gates, c_prev, cs, dys, dcs, w_hh, hard: bool):
    """K3b's contract in plain PyTorch (``pallas_lstm.py:182-256``).

    gates: [T, B, 4H] pre-activations; c_prev, cs: [T, B, H] the cell states
    before and after each step; dys, dcs: [T, B, H] cotangents of ys and cs;
    all in the compute dtype; w_hh: [4H, H]. dh and dc are carried in fp32;
    dgates is rounded to the compute dtype, and that rounded value (cast to
    the weight dtype) feeds the next step's ``dgates @ w_hh``, accumulated in
    fp32. Returns (dgates [T, B, 4H] in the compute dtype, dh0, dc0 [B, H]
    fp32).
    """
    T, B, H4 = gates.shape
    H = H4 // 4
    dtype = gates.dtype
    w = w_hh.float()
    dh_next = gates.new_zeros((B, H), dtype=torch.float32)
    dc = torch.zeros_like(dh_next)
    out = [None] * T
    for t in reversed(range(T)):
        (i_a, f_a, g_a, o_a), (di_a, df_a, dg_a, do_a) = gate_activations(
            gates[t].float(), hard)
        tanh_c, dtanh_c = cell_activation(cs[t].float(), hard)
        dh = dys[t].float() + dh_next
        dc = dc + dcs[t].float() + dh * o_a * dtanh_c
        dg = torch.cat([dc * g_a * di_a, dc * c_prev[t].float() * df_a,
                        dc * i_a * dg_a, dh * tanh_c * do_a], dim=-1).to(dtype)
        out[t] = dg
        dh_next = dg.to(w_hh.dtype).float() @ w
        dc = dc * f_a
    dgates = torch.stack(out) if T else gates.new_empty(gates.shape)
    return dgates, dh_next, dc


# ------------------------------------------------------------------ kernels
def _check_fwd(gates_x, w_hh, h0, c0, what):
    T, B, H4 = gates_x.shape
    H = H4 // 4
    dtype = gates_x.dtype
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    check_operands(gates_x, {"gates_x": (gates_x, (T, B, H4), dtype),
                             "w_hh": (w_hh, (H4, H), dtype), "h0": (h0, (B, H), dtype),
                             "c0": (c0, (B, H), dtype)}, what)
    return T, B, H


def _launch_fwd(gates_x, w_hh, h0, c0, hard, store_gates, slices: int = 1):
    """One cooperative launch for the layer (none when T is 0), or one per
    batch slice of ``ceil(B / slices)`` rows, each reading and writing its
    rows of the whole batch's tensors in place. Returns (ys, cs, gs,
    launches)."""
    what = "lstm_recurrence_fwd_sg" if store_gates else "lstm_recurrence_fwd"
    T, B, H = _check_fwd(gates_x, w_hh, h0, c0, what)
    dtype = gates_x.dtype
    ys = torch.empty((T, B, H), dtype=dtype, device=gates_x.device)
    cs = torch.empty_like(ys)
    gs = torch.empty_like(gates_x) if store_gates else None
    if T == 0 or B == 0:
        return ys, cs, gs, 0
    gx, w, h0, c0 = (_aligned(t) for t in (gates_x, w_hh, h0, c0))
    es, rows = gates_x.element_size(), -(-B // slices)
    starts = range(0, B, rows)
    ctr = torch.zeros(len(starts), dtype=torch.int32, device=gates_x.device)
    for i, s in enumerate(starts):
        n = min(rows, B - s)
        plan = _plan_on(gates_x, n, H, backward=False)
        # row s of a step: 4H elements into gx and gs, H into the others
        err = _fwd_lib().lstm_recurrence_fwd(
            gx.data_ptr() + s * 4 * H * es, w.data_ptr(), h0.data_ptr() + s * H * es,
            c0.data_ptr() + s * H * es, ys.data_ptr() + s * H * es, cs.data_ptr() + s * H * es,
            gs.data_ptr() + s * 4 * H * es if store_gates else None, ctr[i].data_ptr(), T, n,
            B, H, int(hard), DTYPE_CODE[dtype], plan["blocks"], plan["bsplit"],
            plan["units"], plan["resident_rows"], plan["chunk"], plan["group"],
            plan["smem_bytes"], stream_of(gates_x))
        _check_launch(err, what, plan)
    return ys, cs, gs, len(starts)


@counted
def lstm_recurrence(gates_x, w_hh, h0, c0, hard: bool = False) -> Pair:
    """K1: one layer's forward recurrence; same contract as
    :func:`lstm_recurrence_plain`.

    CPU tensors take the plain version. CUDA tensors launch the persistent
    kernel, once per layer (T > 0), or once per slice where the batch is
    larger than a plan takes (:func:`batch_slices`; the slices read and
    write their rows of the layer's tensors in place), and add one to
    ``lstm_recurrence.launches`` a launch; anything the kernel does not take
    raises.
    """
    if gates_x.device.type == "cpu":
        return lstm_recurrence_plain(gates_x, w_hh, h0, c0, hard)
    if gates_x.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x.device}")
    T, B, H = _check_fwd(gates_x, w_hh, h0, c0, "lstm_recurrence_fwd")
    n = batch_slices(B, H, gates_x.dtype, _sm_count(gates_x.device.index or 0)) if B else 1
    ys, cs, _, launches = _launch_fwd(gates_x, w_hh, h0, c0, hard, False, n)
    lstm_recurrence.launches += launches
    return ys, cs


@counted
def lstm_recurrence_sg(gates_x, w_hh, h0, c0, hard: bool = False):
    """K3a: K1 that also returns the pre-activations gs; same contract as
    :func:`lstm_recurrence_sg_plain`. One launch per layer, counted in
    ``lstm_recurrence_sg.launches``."""
    if gates_x.device.type == "cpu":
        return lstm_recurrence_sg_plain(gates_x, w_hh, h0, c0, hard)
    if gates_x.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x.device}")
    ys, cs, gs, launches = _launch_fwd(gates_x, w_hh, h0, c0, hard, True)
    lstm_recurrence_sg.launches += launches
    return ys, cs, gs


@counted
def lstm_recurrence_bwd(gates, c_prev, cs, dys, dcs, w_hh, hard: bool = False):
    """K3b: the reverse recurrence; same contract as
    :func:`lstm_recurrence_bwd_plain`. One launch per layer, dh0 included
    (none when T is 0), counted in ``lstm_recurrence_bwd.launches``."""
    if gates.device.type == "cpu":
        return lstm_recurrence_bwd_plain(gates, c_prev, cs, dys, dcs, w_hh, hard)
    if gates.device.type != "cuda":
        raise ValueError(f"unsupported device {gates.device}")
    what = "lstm_recurrence_bwd"
    T, B, H4 = gates.shape
    H = H4 // 4
    dtype = gates.dtype
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    state = ((T, B, H), dtype)
    check_operands(gates, {"gates": (gates, (T, B, H4), dtype), "c_prev": (c_prev, *state),
                           "cs": (cs, *state), "dys": (dys, *state), "dcs": (dcs, *state),
                           "w_hh": (w_hh, (H4, H), dtype)}, what)
    dgates = torch.empty_like(gates)
    dh0 = torch.zeros((B, H), dtype=torch.float32, device=gates.device)
    dc0 = torch.zeros_like(dh0)
    if T == 0:
        return dgates, dh0, dc0
    plan = _plan_on(gates, B, H, backward=True)
    w_t = w_hh.t().contiguous()  # [H, 4H]: a unit's contraction is contiguous
    ctr = torch.zeros(1, dtype=torch.int32, device=gates.device)
    err = _bwd_lib().lstm_recurrence_bwd(
        *(_aligned(t).data_ptr() for t in (gates, c_prev, cs, dys, dcs)), w_t.data_ptr(),
        dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), ctr.data_ptr(), T, B, H, int(hard),
        DTYPE_CODE[dtype], plan["blocks"], plan["bsplit"], plan["units"],
        plan["resident_rows"], plan["chunk"], plan["group"], plan["smem_bytes"],
        stream_of(gates))
    _check_launch(err, what, plan)
    lstm_recurrence_bwd.launches += 1
    return dgates, dh0, dc0


# ----------------------------------------------------------------- autograd
class LSTMRecurrence(torch.autograd.Function):
    """Differentiable recurrence (inputs gates_x, w_hh, h0, c0 as for
    :func:`lstm_recurrence`; returns (ys, cs)).

    With ``store_gates`` (the default, as in the JAX package) the forward
    runs K3a and saves its pre-activations; without, it runs K1 and the
    backward recomputes the gates with one matmul (``pallas_lstm.py:384-391``).
    The backward runs K3b and forms ``dW_hh`` with one matmul.
    """

    @staticmethod
    def forward(ctx, gates_x, w_hh, h0, c0, hard: bool, store_gates: bool):
        ctx.hard, ctx.store_gates = hard, store_gates
        if store_gates:
            ys, cs, gs = lstm_recurrence_sg(gates_x, w_hh, h0, c0, hard)
            ctx.save_for_backward(gs, w_hh, h0, c0, ys, cs)
        else:
            ys, cs = lstm_recurrence(gates_x, w_hh, h0, c0, hard)
            ctx.save_for_backward(gates_x, w_hh, h0, c0, ys, cs)
        return ys, cs

    @staticmethod
    def backward(ctx, dys, dcs):
        g, w_hh, h0, c0, ys, cs = ctx.saved_tensors
        T, B, H = ys.shape
        h_prev = torch.cat([h0[None].to(ys.dtype), ys[:-1]])
        c_prev = torch.cat([c0[None].to(cs.dtype), cs[:-1]])
        if ctx.store_gates:
            gates = g
        else:
            rec = h_prev.reshape(T * B, H).to(w_hh.dtype).float() @ w_hh.float().t()
            gates = (g.float() + rec.reshape(T, B, 4 * H)).to(g.dtype)
        dgates, dh0, dc0 = lstm_recurrence_bwd(
            gates, c_prev, cs, dys.contiguous(), dcs.contiguous(), w_hh, ctx.hard)
        dw = torch.matmul(dgates.reshape(T * B, 4 * H).t().to(w_hh.dtype),
                          h_prev.reshape(T * B, H).to(w_hh.dtype))
        return dgates, dw, dh0.to(h0.dtype), dc0.to(c0.dtype), None, None


def recurrence(gates_x, w_hh, h0, c0, hard: bool = False, store_gates: bool = True) -> Pair:
    """One layer's recurrence: through ``LSTMRecurrence`` when a gradient is
    wanted, else K1 alone (the undifferentiated call never pays for storing
    the gates, ``pallas_lstm.py:341-344``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gates_x, w_hh, h0, c0)):
        return LSTMRecurrence.apply(gates_x, w_hh, h0, c0, hard, store_gates)
    return lstm_recurrence(gates_x, w_hh, h0, c0, hard)
