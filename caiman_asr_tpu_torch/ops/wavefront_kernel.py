"""Wavefront multi-layer LSTM kernels: the hand-written Hopper kernels, their
plain PyTorch versions, their plan and their launch counts.

Replaces the Pallas TPU kernels of ``caiman_asr_tpu/ops/pallas_wavefront.py``:

- K8-fwd ``_fwd_kernel``: G stacked layers run as a (layer, time) wavefront,
  layer ``l`` taking step ``t = s - l`` at superstep ``s`` (``lstm_wavefront``,
  and ``lstm_wavefront_sg``, which also stores the pre-activations, the
  forward of a call that needs gradients; one CUDA source,
  ``csrc/lstm_wavefront.cu``, under a compile-time flag);
- K8-bwd ``_bwd_kernel``: the mirrored reverse wavefront
  (``lstm_wavefront_bwd``, ``csrc/lstm_wavefront_bwd.cu``).

Layouts are the port's torch ones: ``w0_hh`` [4H, H]; ``w_cats`` [G-1, 4H,
2H], row r of layer l being ``[w_ih^l[r] ; w_hh^l[r]]``; every stream
[G, T, B, *] (layer-major, no shifted superstep layout).

What bounds them on an H100: one superstep reads every layer's recurrent
weights once, ``4H·H + (G-1)·4H·2H`` values forward and ``(2G-1)·4H·H``
backward (92 MB in bf16 at G=6, H=1024, more than the 50 MB L2 and three
times the 132 × 227 KB of shared memory), against ``2·B`` FLOPs a value,
so at B=16 a superstep is bound by the bytes. As the TPU kernel keeps the
weights in VMEM, each kernel here is one cooperative launch per call
(``csrc/lstm_wavefront.cuh``): the layers' rows split over the SMs in
proportion to their weights, as many of a block's rows as fit resident in
shared memory for the whole call, the rest streamed once a superstep
through a ring that runs ahead across the grid barrier (from an image of
them that each block packs into a scratch buffer before its first
superstep, in the same launch), the carries in shared memory.
:func:`wavefront_plan` makes that split; the kernels check it.

Every wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from typing import Optional

import torch

from caiman_asr_tpu_torch.ops.cuda_build import (
    DTYPE_CODE, MAX_SMEM_BYTES, I, P, check_operands, counted, load, stream_of,
)
from caiman_asr_tpu_torch.ops.lstm import cell_activation, gate_activations, gate_math
from caiman_asr_tpu_torch.ops.lstm_kernel import H100_SMS, _check_launch, _resident_ld, _sm_count

logger = logging.getLogger(__name__)

Z = ctypes.c_size_t
IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _fwd_lib():
    return load("lstm_wavefront", {
        "lstm_wavefront_fwd": ([P] * 14 + [I] * 6 + [IP, Z, P], I),
        "lstm_wavefront_smem_bytes": ([IP] + [I] * 5, Z),
    })


@functools.cache
def _bwd_lib():
    return load("lstm_wavefront_bwd", {"lstm_wavefront_bwd": ([P] * 14 + [I] * 6 + [IP, Z, P], I)})


# ---------------------------------------------------------------- the plan
# The kernels' layout constants (csrc/lstm_wavefront.cuh): the rings'
# stages, a block's warps, the mma tiles a bf16 warp accumulates, fp32's
# 8 x 8 thread tile, and the order of a type's numbers in the plan the
# kernels take.
STAGES = 3
MAX_X_STAGES = 8
BF16_WARPS, MAX_PAIRS = 8, 16
F32_THREADS, TILE = 256, 8
TYPE_KEYS = ("blocks", "units", "res", "kc", "xs", "pairs", "wk", "tk")
# The chunks a type may stream in: bf16 odd multiples of 32 (a stage's rows
# then need no padding against bank conflicts), fp32 multiples of 8. The
# plan prices a superstep of a block as its streamed bytes at SM_BYTES_PER_US
# (an SM's share of the memory's 3.35 TB/s) plus a price a chunk (its waits
# and block barrier): it takes the chunk whose block is cheapest at
# CHUNK_US (forward, backward), and the split of the grid between the two
# types whose dearest block is cheapest at SPLIT_CHUNK_US a chunk, of splits
# priced alike the one giving type A the most blocks. The prices follow
# timings on an H100 of every split the search visits (phase 9's shapes,
# fp32 at base-85M's post-stack): within a block a backward chunk is worth
# the higher price (shorter chunks for more resident rows ran slower at
# base), between splits the lower one (the top layer's one-segment chunks
# cost less than the lower layers' two-segment ones; the higher price put
# large-196M's backward on a slower split); chunks of one k block (32
# columns) are the slowest choice and taken only where nothing else fits.
CHUNKS = {2: (32, 96, 160, 224, 288, 352, 416, 480), 4: (8, 16, 32, 48, 64, 96, 128)}
SM_BYTES_PER_US = 25e3
CHUNK_US = {False: 0.5, True: 1.0}
SPLIT_CHUNK_US = 0.5
# X's ring: as many stages of a chunk's batch rows as fit X_RING_BYTES, 3 to
# MAX_X_STAGES (X comes from L2, whose latency under the weights' stream
# is microseconds: a chunk waits on the copy issued xs - 1 chunks before).
X_RING_BYTES = 12 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stage_ld(kc: int, esize: int) -> int:
    return _resident_ld(kc, 2) if esize == 2 else kc + 4


def _shape(type_: int, units: int, H: int, backward: bool):
    """(rows, row length K, segments, gate-math input ranges a batch row) of
    a block of a type (``shape_of``)."""
    if backward:
        return (units, 4 * H, 1, 8) if type_ == 0 else (units, 8 * H, 2, 9)
    return 4 * units, (H if type_ == 0 else 2 * H), 1, (5 if type_ == 0 else 1)


def type_smem_bytes(ty: dict, rows: int, K: int, nseg: int, naux: int, B: int,
                    esize: int) -> int:
    """A block's shared memory, as the kernels compute it (``layout`` of
    ``csrc/lstm_wavefront.cuh``): the resident rows, the ring of STAGES
    stages (the streamed rows and the batch rows of X, ``kc`` columns
    each) and X's ring of ``xs`` stages, the sums of the warps' k parts, the
    backward's own sums (two segments), the fp32 carry, the forward's fp32
    bias of its rows, a step's gate-math inputs (``naux`` ranges of the
    units a batch row) and the ring's mbarriers."""
    rows_pad, bp = _round_up(rows, 16), _round_up(B, 8)
    parts = ty["wk"] if esize == 2 else 1
    rs = rows_pad + 4
    ld = _stage_ld(ty["kc"], esize)
    return (ty["res"] * _resident_ld(K, esize) * esize
            + (STAGES * (rows_pad - ty["res"]) + ty["xs"] * bp) * ld * esize
            + 4 * parts * bp * rs + (4 * bp * rs if nseg == 2 else 0) + 4 * ty["units"] * B
            + (4 * rows if nseg == 1 and rows == 4 * ty["units"] else 0)
            + _round_up(naux * ty["units"] * B * esize, 16) + 8 * STAGES)


def _warps(rows: int, B: int, esize: int) -> dict:
    """How a block's threads split its product: bf16's 8 warps of ``pairs``
    mma tiles (16 rows by 8 batch rows) in ``wk`` parts of k, the most warps
    busy and then the fewest parts; fp32's 256 threads of one 8 x 8 tile in
    ``tk`` parts of k (adjacent lanes, a power of two up to 32)."""
    rows_pad, bp = _round_up(rows, 16), _round_up(B, 8)
    if esize == 2:
        tiles = rows_pad // 16 * (bp // 8)
        best = None
        for pairs in range(1, MAX_PAIRS + 1):
            groups = -(-tiles // pairs)
            if groups > BF16_WARPS:
                continue
            wk = BF16_WARPS // groups
            key = (groups * wk, -wk, -pairs)
            if best is None or key > best[0]:
                best = (key, {"pairs": pairs, "wk": wk, "tk": 0})
        if best is None:
            raise ValueError(f"{rows} rows by {B} batch rows are more mma tiles than a block "
                             f"holds ({BF16_WARPS} warps of {MAX_PAIRS})")
        return best[1]
    tiles = rows_pad // TILE * (bp // TILE)
    if tiles > F32_THREADS:
        raise ValueError(f"{rows} rows by {B} batch rows are more fp32 tiles than a block has "
                         f"threads ({F32_THREADS})")
    tk = 1
    while tk < 32 and tiles * tk * 2 <= F32_THREADS:
        tk *= 2
    return {"pairs": 0, "wk": 0, "tk": tk}


def _type_plan(type_: int, target: int, G: int, B: int, H: int, esize: int,
               backward: bool, narrow: bool = False) -> dict:
    units = _round_up(-(-H // target), 2)  # even: the gate inputs move in 4-byte copies
    blocks = -(-H // units)
    rows, K, nseg, naux = _shape(type_, units, H, backward)
    ty = {"blocks": blocks, "units": units, **_warps(rows, B, esize)}
    fits = []
    for kc in CHUNKS[esize]:
        xstage = _round_up(B, 8) * _stage_ld(kc, esize) * esize
        xs = min(MAX_X_STAGES, max(3, X_RING_BYTES // xstage))
        for xs in range(xs, 1, -1):  # fewer X stages where the longer chunk needs the room
            res = next((r for r in range(rows, -1, -1)
                        if type_smem_bytes(dict(ty, res=r, kc=kc, xs=xs), rows, K, nseg, naux, B,
                                           esize) <= MAX_SMEM_BYTES), None)
            if res is not None:
                fits.append(dict(ty, res=res, kc=kc, xs=xs))
                break
    if not fits:
        raise ValueError(f"G={G} B={B} H={H}: a block's ring and sums alone need more shared "
                         "memory than a block has")
    if esize == 2 and not narrow:  # bf16's shortest chunk, one k block, only if asked
        fits = [t for t in fits if t["kc"] > 32]
    if not fits:
        raise ValueError(f"G={G} B={B} H={H}: no chunk of more than one k block fits")
    # the cheapest, and of those within 5% of it the one keeping most rows resident
    cost = {id(t): _cost_us(t, rows, K, nseg, esize, CHUNK_US[backward]) for t in fits}
    least = min(cost.values())
    return max((t for t in fits if cost[id(t)] <= 1.05 * least),
               key=lambda t: (t["res"], -cost[id(t)]))


def _chunks(ty: dict, K: int, nseg: int) -> int:
    return nseg * -(-(K // nseg) // ty["kc"])


def _cost_us(ty: dict, rows: int, K: int, nseg: int, esize: int, chunk_us: float) -> float:
    """The plan's price of a superstep of a type's fullest block, µs: its
    streamed rows' bytes at SM_BYTES_PER_US and ``chunk_us`` a chunk."""
    return (rows - ty["res"]) * K * esize / SM_BYTES_PER_US + _chunks(ty, K, nseg) * chunk_us


def _layer_types(G: int, backward: bool) -> list:
    """Type A (0) is the forward's layer 0 and the backward's top layer."""
    return [(0 if l == G - 1 else 1) if backward else (0 if l == 0 else 1) for l in range(G)]


def _split_cost_us(types: list, H: int, esize: int, backward: bool) -> float:
    """The plan's price of a superstep of a split of the grid, µs: its
    dearest block's (``_cost_us`` at SPLIT_CHUNK_US a chunk)."""
    return max(_cost_us(t, *_shape(i, t["units"], H, backward)[:3], esize, SPLIT_CHUNK_US)
               for i, t in enumerate(types))


def wavefront_plan(G: int, B: int, H: int, dtype, backward: bool = False,
                   sms: int = H100_SMS) -> dict:
    """How the wavefront kernel (K8-fwd, or K8-bwd with ``backward``) splits
    G layers of width H at batch B over the card's ``sms`` SMs, one block
    each.

    Two types of block: type A holds the forward's layer 0 (4H rows of
    w0_hh, length H) or the backward's top layer (H rows of w_hh^T, length
    4H); type B each other layer (the forward's 4H rows of ``[w_ih ; w_hh]``,
    length 2H; the backward's H rows of ``[w_hh^T ; w_ih^T of the layer
    above]``, length 8H), so twice the weights. Type A gets from its share
    of the weights (one of 2G - 1) up to an equal share of the grid (one of
    G), the rest split evenly over the type-B layers: ``blocks`` blocks of
    ``units`` hidden units (even; the fewest that give at most that many
    blocks), each block all four gates of its units. A block keeps its
    first ``res`` rows resident in shared memory and streams the rest once
    a superstep in chunks of ``kc`` columns through a ring of STAGES stages
    (X in a ring of ``xs``): the most rows resident that the rings, the
    sums, the carry and the gate inputs leave room for. Of the chunks that
    fit the plan takes the cheapest by ``_cost_us`` (within 5%, the chunk
    keeping most rows resident), of the splits the one whose dearest block
    is cheapest (``_split_cost_us``; of those priced alike, the one giving
    type A the most blocks). ``pairs``, ``wk``, ``tk`` split the block's
    product over its threads (``_warps``).

    Returns the types (``types``: A, then B or None when G = 1) and per
    layer ``blocks_per_layer``, ``units_per_block``, ``rows_per_block`` and
    ``resident_rows``; ``blocks`` (the grid), ``smem_bytes`` a block (the
    larger type's layout, what the launch asks for), the weight bytes, the
    resident ones and, a superstep with every layer in its window, the
    weight bytes streamed (``streamed_bytes_per_superstep``, weights less
    resident) and the exchanged state staged by every block
    (``exchange_bytes_per_superstep``: B rows of its row length). Raises
    ValueError where no plan fits.
    """
    if H % 8 or H <= 0:
        raise ValueError(f"hidden size must be a positive multiple of 8, got {H}")
    if G < 1 or B < 1:
        raise ValueError(f"G={G}, B={B}: the wavefront needs a layer and a batch row")
    esize = torch.empty((), dtype=dtype).element_size()
    # type A's blocks from its share of the weights (sms / (2G - 1)) up to an
    # equal share of the grid (sms / G, rows as short as type B's): the
    # cheapest split by _split_cost_us, the last of those priced alike; past
    # that only where type A's rows do not fit at all. bf16 chunks of one k
    # block (32 columns) only where no split avoids them.
    types, why, best = None, None, None
    lo = max(1, sms // (2 * G - 1))
    hi = max(lo, sms // G)
    for narrow in (False, True):
        for target_a in range(lo, sms - (G - 1) + 1):
            if target_a > hi and best is not None:
                break
            try:
                cand = [_type_plan(0, target_a, G, B, H, esize, backward, narrow)]
                if G > 1:
                    cand.append(_type_plan(1, max(1, (sms - cand[0]["blocks"]) // (G - 1)), G,
                                           B, H, esize, backward, narrow))
            except ValueError as err:
                why = err
                continue
            cost = _split_cost_us(cand, H, esize, backward)
            if best is None or cost <= best:
                types, best = cand, cost
        if types is not None:
            break
    if types is None:
        raise why
    blocks = types[0]["blocks"] + (G - 1) * (types[1]["blocks"] if G > 1 else 0)
    if blocks > sms:
        raise ValueError(f"G={G} B={B} H={H}: {blocks} blocks, more than the card's {sms} SMs")
    layer_type = _layer_types(G, backward)
    sizes = [type_smem_bytes(ty, *_shape(i, ty["units"], H, backward), B, esize)
             for i, ty in enumerate(types)]
    weight = resident = exchange = 0
    for l in range(G):
        ty = types[layer_type[l]]
        rows, K, _, _ = _shape(layer_type[l], ty["units"], H, backward)
        per_unit = rows // ty["units"]
        weight += per_unit * H * K * esize
        exchange += ty["blocks"] * B * K * esize
        for b in range(ty["blocks"]):  # rows past H hold nothing
            real = min(ty["units"], H - b * ty["units"])
            gates_res = [min(max(ty["res"] - q * ty["units"], 0), real) for q in range(per_unit)]
            resident += sum(gates_res) * K * esize
    return {
        "G": G, "B": B, "H": H, "backward": backward, "esize": esize, "stages": STAGES,
        "types": types + ([None] if G == 1 else []), "type_smem_bytes": sizes,
        "blocks": blocks, "smem_bytes": max(sizes),
        "blocks_per_layer": [types[k]["blocks"] for k in layer_type],
        "units_per_block": [types[k]["units"] for k in layer_type],
        "rows_per_block": [_shape(k, types[k]["units"], H, backward)[0] for k in layer_type],
        "resident_rows": [types[k]["res"] for k in layer_type],
        "weight_bytes": weight, "resident_bytes": resident,
        "streamed_bytes_per_superstep": weight - resident,
        "exchange_bytes_per_superstep": exchange,
    }


@functools.cache
def _plan(G: int, B: int, H: int, dtype, backward: bool, sms: int) -> dict:
    plan = wavefront_plan(G, B, H, dtype, backward, sms)
    logger.info("wavefront %s G=%d B=%d H=%d %s: %d blocks, %d of %d weight bytes resident, "
                "%d streamed a superstep", "backward" if backward else "forward", G, B, H,
                dtype, plan["blocks"], plan["resident_bytes"], plan["weight_bytes"],
                plan["streamed_bytes_per_superstep"])
    return plan


def packed_elems(plan: dict) -> list:
    """Per type, the elements of the scratch buffer into which the kernels
    pack its blocks' streamed rows before the first superstep: per block
    (grid order: layer by layer, block by block) and chunk, the image of a
    stage, [srows, ld_stage] in the weights' dtype; 0 for a type that
    streams none (or is absent)."""
    H, backward, esize = plan["H"], plan["backward"], plan["esize"]
    out = []
    for type_, ty in enumerate(plan["types"][:2]):
        if ty is None:
            out.append(0)
            continue
        rows, K, nseg, _ = _shape(type_, ty["units"], H, backward)
        srows = _round_up(rows, 16) - ty["res"]
        layers = _layer_types(plan["G"], backward).count(type_)
        out.append(layers * ty["blocks"] * _chunks(ty, K, nseg) * srows
                   * _stage_ld(ty["kc"], esize))
    return out


def _scratch(plan: dict, like: torch.Tensor) -> list:
    """The kernels' packing scratch (uninitialised: the kernels write all of
    it), None for a type that streams none."""
    return [like.new_empty(n) if n else None for n in packed_elems(plan)]


def plan_ints(plan: dict):
    """The plan as the kernels take it: 16 ints, type A's then type B's
    (zeros when G = 1), in TYPE_KEYS order."""
    vals = [ty[k] if ty else 0 for ty in plan["types"][:2] + [None] * (2 - len(plan["types"]))
            for k in TYPE_KEYS]
    return (ctypes.c_int * len(vals))(*vals)


# ------------------------------------------------------------ plain versions
def lstm_wavefront_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks=None,
                         hard: bool = False, store_gates: bool = False):
    """K8-fwd's contract in plain PyTorch, superstep by superstep
    (``pallas_wavefront.py:114-148``).

    gates_x0: [T, B, 4H] layer 0's input projection plus bias, already in the
    compute dtype; biases: [max(G-1, 1), 4H] fp32, the inner layers'
    ``b_ih + b_hh``; w0_hh: [4H, H]; w_cats: [G-1, 4H, 2H]; h0, c0: [G, B, H];
    masks: None or [G-1, T, B, H], the dropout scale entering layers 1..G-1;
    all but the biases in the compute dtype. At superstep s layer l takes
    step t = s - l:

    - layer 0: ``gates_x0[t] + h^0_{t-1} @ w0_hh^T``;
    - layer l > 0: ``[x ; h^l_{t-1}] @ w_cats[l-1]^T + biases[l-1]``, x being
      layer l-1's step-t output times ``masks[l-1, t]``, rounded to the
      compute dtype.

    Products of compute-dtype values accumulate in fp32, the bias adds to
    the fp32 sum; h and c are carried in fp32 (h enters a product in the
    compute dtype, which is its stored output). Returns (ys, cs) or, with
    ``store_gates``, (ys, cs, gs), each [G, T, B, H] ([G, T, B, 4H] for gs)
    in the compute dtype.
    """
    T, B, H4 = gates_x0.shape
    H = H4 // 4
    G = h0.shape[0]
    dtype = gates_x0.dtype
    ws = [w0_hh.float().t()] + [w_cats[l].float().t() for l in range(G - 1)]
    c = [c0[l].float() for l in range(G)]
    ys = gates_x0.new_empty((G, T, B, H))
    cs = torch.empty_like(ys)
    gs = gates_x0.new_empty((G, T, B, H4)) if store_gates else None
    for s in range(T + G - 1):
        for l in range(G):
            t = s - l
            if not 0 <= t < T:
                continue
            h_prev = (h0[l] if t == 0 else ys[l, t - 1]).float()
            if l == 0:
                gates = gates_x0[t].float() + h_prev @ ws[0]
            else:
                x = ys[l - 1, t]
                if masks is not None:
                    x = (x.float() * masks[l - 1, t].float()).to(dtype)
                gates = torch.cat([x.float(), h_prev], dim=-1) @ ws[l] + biases[l - 1]
            h, c[l] = gate_math(gates, c[l], hard)
            ys[l, t] = h.to(dtype)
            cs[l, t] = c[l].to(dtype)
            if store_gates:
                gs[l, t] = gates.to(dtype)
    return (ys, cs, gs) if store_gates else (ys, cs)


def lstm_wavefront_sg_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks=None,
                            hard: bool = False):
    """:func:`lstm_wavefront_plain` storing the gates: (ys, cs, gs)."""
    return lstm_wavefront_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, True)


def lstm_wavefront_bwd_plain(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard: bool = False):
    """K8-bwd's contract in plain PyTorch, reverse superstep by reverse
    superstep (``pallas_wavefront.py:262-352``).

    gs: [G, T, B, 4H] pre-activations; cs, c_prev: [G, T, B, H] the cell
    states after and before each step; dys, dcs: [G, T, B, H] cotangents of
    ys and cs; masks: None or [G-1, T, B, H] (``masks[l]`` enters layer l+1);
    w_hh: [G, 4H, H]; w_ih: [G-1, 4H, H] the inner layers' input weights
    (``w_ih[l]`` is layer l+1's); all in the compute dtype. Layer l takes
    step t at reverse superstep ``(T-1-t) + (G-1-l)``, with

        dh^l_t = dys^l_t + dgates^l_{t+1} @ w_hh^l
                 + masks[l, t] * (dgates^{l+1}_t @ w_ih^{l+1})

    (a step outside [0, T) or a layer past G-1 contributes nothing; without
    masks the two products are one fp32 sum, the stacked [8H, H] product),
    then the gate backward of ``lstm_recurrence_bwd_plain`` with dc carried
    in fp32. dgates is rounded to the compute dtype, and that rounded value
    feeds both products. Returns (dgates [G, T, B, 4H] in the compute dtype,
    dh0 = dgates^l_0 @ w_hh^l and dc0, each [G, B, H] fp32).
    """
    G, T, B, H4 = gs.shape
    H = H4 // 4
    dtype = gs.dtype
    w_own = [w_hh[l].float() for l in range(G)]
    w_stack = [torch.cat([w_hh[l], w_ih[l]]).float() for l in range(G - 1)]
    dgates = gs.new_empty(gs.shape)
    dc = [gs.new_zeros((B, H), dtype=torch.float32) for _ in range(G)]
    zero = gs.new_zeros((B, H4))
    for r in range(T + G - 1):
        for l in range(G):
            t = T - 1 - (r - (G - 1 - l))
            if not 0 <= t < T:
                continue
            own = dgates[l, t + 1] if t + 1 < T else zero
            if l == G - 1:
                dh_mat = own.float() @ w_own[l]
            elif masks is None:
                dh_mat = torch.cat([own, dgates[l + 1, t]], dim=-1).float() @ w_stack[l]
            else:
                above = dgates[l + 1, t].float() @ w_ih[l].float()
                dh_mat = own.float() @ w_own[l] + above * masks[l, t].float()
            (i_a, f_a, g_a, o_a), (di_a, df_a, dg_a, do_a) = gate_activations(
                gs[l, t].float(), hard)
            tanh_c, dtanh_c = cell_activation(cs[l, t].float(), hard)
            dh = dys[l, t].float() + dh_mat
            d = dc[l] + dcs[l, t].float() + dh * o_a * dtanh_c
            dgates[l, t] = torch.cat([d * g_a * di_a, d * c_prev[l, t].float() * df_a,
                                      d * i_a * dg_a, dh * tanh_c * do_a], dim=-1).to(dtype)
            dc[l] = d * f_a
    dh0 = torch.stack([(dgates[l, 0] if T else zero).float() @ w_own[l] for l in range(G)])
    return dgates, dh0, torch.stack(dc)


# ------------------------------------------------------------------ kernels
def _check_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, what):
    T, B, H4 = gates_x0.shape
    H = H4 // 4
    G = h0.shape[0] if h0.dim() == 3 else 0
    dtype = gates_x0.dtype
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    if G < 1:
        raise ValueError(f"{what}: h0 must be [G, B, H] with G >= 1, got {tuple(h0.shape)}")
    ops = {"gates_x0": (gates_x0, (T, B, H4), dtype),
           "biases": (biases, (max(G - 1, 1), H4), torch.float32),
           "w0_hh": (w0_hh, (H4, H), dtype), "w_cats": (w_cats, (G - 1, H4, 2 * H), dtype),
           "h0": (h0, (G, B, H), dtype), "c0": (c0, (G, B, H), dtype)}
    if masks is not None:
        ops["masks"] = (masks, (G - 1, T, B, H), dtype)
    check_operands(gates_x0, ops, what)
    vectors = [gates_x0, w0_hh, h0] + ([w_cats] if G > 1 else [])
    if any(t.data_ptr() % 16 for t in vectors):
        raise ValueError(f"{what}: gates_x0, w0_hh, w_cats and h0 must be 16-byte aligned")
    return T, B, H, G


def _launch_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, store_gates,
                plan: Optional[dict] = None):
    """One cooperative launch for the call (none when T is 0), on ``plan``
    (by default :func:`wavefront_plan`'s for the shape and the card)."""
    what = "lstm_wavefront_fwd_sg" if store_gates else "lstm_wavefront_fwd"
    T, B, H, G = _check_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, what)
    dtype, dev = gates_x0.dtype, gates_x0.device
    ys = torch.empty((G, T, B, H), dtype=dtype, device=dev)
    cs = torch.empty_like(ys)
    gs = torch.empty((G, T, B, 4 * H), dtype=dtype, device=dev) if store_gates else None
    if T == 0:
        return ys, cs, gs, 0
    plan = plan or _plan(G, B, H, dtype, False, _sm_count(dev.index or 0))
    # the masked handoff's two slots (only with masks: the layer above reads
    # the rounded x * mask a superstep after the layer below writes it)
    xm = torch.empty((G - 1, 2, B, H), dtype=dtype, device=dev) if masks is not None and G > 1 \
        else None
    packed = _scratch(plan, w0_hh)
    ctr = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _fwd_lib().lstm_wavefront_fwd(
        gates_x0.data_ptr(), biases.data_ptr(), w0_hh.data_ptr(), w_cats.data_ptr(),
        None if masks is None else masks.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), cs.data_ptr(), gs.data_ptr() if store_gates else None,
        None if xm is None else xm.data_ptr(), *(None if t is None else t.data_ptr()
                                                for t in packed),
        ctr.data_ptr(), T, B, H, G, int(hard),
        DTYPE_CODE[dtype], plan_ints(plan), plan["smem_bytes"], stream_of(gates_x0))
    _check_launch(err, what, plan)
    return ys, cs, gs, 1


@counted
def lstm_wavefront(gates_x0, biases, w0_hh, w_cats, h0, c0, masks: Optional[torch.Tensor] = None,
                   hard: bool = False):
    """K8-fwd: the G-layer wavefront forward; same contract as
    :func:`lstm_wavefront_plain` without stored gates, returning (ys, cs).

    CPU tensors take the plain version. CUDA tensors launch the persistent
    kernel once per call (T > 0), counted in ``lstm_wavefront.launches``;
    anything the kernel does not take raises.
    """
    if gates_x0.device.type == "cpu":
        return lstm_wavefront_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, False)
    if gates_x0.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x0.device}")
    ys, cs, _, n = _launch_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, False)
    lstm_wavefront.launches += n
    return ys, cs


@counted
def lstm_wavefront_sg(gates_x0, biases, w0_hh, w_cats, h0, c0,
                      masks: Optional[torch.Tensor] = None, hard: bool = False):
    """K8-fwd storing the pre-activations: returns (ys, cs, gs), the contract
    of :func:`lstm_wavefront_plain` with ``store_gates``. One launch per
    call, counted in ``lstm_wavefront_sg.launches``."""
    if gates_x0.device.type == "cpu":
        return lstm_wavefront_sg_plain(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard)
    if gates_x0.device.type != "cuda":
        raise ValueError(f"unsupported device {gates_x0.device}")
    ys, cs, gs, n = _launch_fwd(gates_x0, biases, w0_hh, w_cats, h0, c0, masks, hard, True)
    lstm_wavefront_sg.launches += n
    return ys, cs, gs


def _launch_bwd(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard, plan: Optional[dict] = None):
    """K8-bwd's checks and its one cooperative launch (none when T is 0)."""
    what = "lstm_wavefront_bwd"
    G, T, B, H4 = gs.shape
    H = H4 // 4
    dtype = gs.dtype
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if H4 != 4 * H or H % 8 != 0:
        raise ValueError(f"hidden size must be a multiple of 8, got 4H={H4}")
    state = ((G, T, B, H), dtype)
    ops = {"gs": (gs, (G, T, B, H4), dtype), "cs": (cs, *state), "c_prev": (c_prev, *state),
           "dys": (dys, *state), "dcs": (dcs, *state), "w_hh": (w_hh, (G, H4, H), dtype),
           "w_ih": (w_ih, (G - 1, H4, H), dtype)}
    if masks is not None:
        ops["masks"] = (masks, (G - 1, T, B, H), dtype)
    check_operands(gs, ops, what)
    dgates = torch.empty_like(gs)
    if T == 0:
        zero = torch.zeros((G, B, H), dtype=torch.float32, device=gs.device)
        return dgates, zero, zero.clone(), 0
    # every layer reaches its dh0 step, which writes all of dh0 and dc0
    dh0 = torch.empty((G, B, H), dtype=torch.float32, device=gs.device)
    dc0 = torch.empty_like(dh0)
    plan = plan or _plan(G, B, H, dtype, True, _sm_count(gs.device.index or 0))
    packed = _scratch(plan, w_hh)
    ctr = torch.zeros(1, dtype=torch.int32, device=gs.device)
    err = _bwd_lib().lstm_wavefront_bwd(
        gs.data_ptr(), cs.data_ptr(), c_prev.data_ptr(), dys.data_ptr(), dcs.data_ptr(),
        None if masks is None else masks.data_ptr(), w_hh.data_ptr(), w_ih.data_ptr(),
        dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        *(None if t is None else t.data_ptr() for t in packed), ctr.data_ptr(),
        T, B, H, G, int(hard), DTYPE_CODE[dtype], plan_ints(plan), plan["smem_bytes"],
        stream_of(gs))
    _check_launch(err, what, plan)
    return dgates, dh0, dc0, 1


@counted
def lstm_wavefront_bwd(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard: bool = False):
    """K8-bwd: the reverse wavefront; same contract as
    :func:`lstm_wavefront_bwd_plain`. One launch per call, every reverse
    superstep and layer 0's dh0 included (none when T is 0), counted in
    ``lstm_wavefront_bwd.launches``."""
    if gs.device.type == "cpu":
        return lstm_wavefront_bwd_plain(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard)
    if gs.device.type != "cuda":
        raise ValueError(f"unsupported device {gs.device}")
    dgates, dh0, dc0, n = _launch_bwd(gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard)
    lstm_wavefront_bwd.launches += n
    return dgates, dh0, dc0
