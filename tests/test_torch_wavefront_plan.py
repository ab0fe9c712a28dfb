"""The persistent wavefront kernels' plan (``wavefront_kernel.wavefront_plan``),
on the CPU: how the G layers' rows are split over the card's SMs, how many of
each block's rows stay resident in shared memory, what streams a superstep,
how the split of the grid is priced, and the scratch into which the kernels
pack the streamed rows (``packed_elems``). The kernels
(``csrc/lstm_wavefront*.cu``) check the same layout at launch and pack the
rows themselves; their tests on the card are in ``tests/test_torch_kernel.py``.
"""

import numpy as np
import pytest
import torch

from caiman_asr_tpu_torch.ops import wavefront_kernel as wk
from caiman_asr_tpu_torch.ops.cuda_build import MAX_SMEM_BYTES
from caiman_asr_tpu_torch.ops.wavefront_kernel import wavefront_plan

# phase 9's three shapes (G, H, B), the full-width kernel tests' and the
# kernel tests' small ones: G=1, B=5, 33, 96 (not a multiple of 8, more
# than 64), H=136 (a multiple of 8 only)
SHAPES = [(6, 1024, 16), (6, 1536, 32), (2, 1536, 96), (1, 32, 8), (2, 32, 8), (3, 32, 8),
          (3, 136, 5), (1, 136, 5), (3, 1024, 33), (2, 136, 96), (3, 136, 96), (6, 1024, 2)]
DTYPES = (torch.float32, torch.bfloat16)
CASES = [(G, H, B, dtype, backward) for G, H, B in SHAPES for dtype in DTYPES
         for backward in (False, True)]


def _layer_types(G, backward):
    """Type A is the forward's layer 0 and the backward's top layer."""
    return [(0 if l == G - 1 else 1) if backward else (0 if l == 0 else 1) for l in range(G)]


@pytest.mark.parametrize("G,H,B,dtype,backward", CASES)
def test_plan_gives_every_row_of_every_layer_to_one_block(G, H, B, dtype, backward):
    plan = wavefront_plan(G, B, H, dtype, backward)
    assert plan["blocks"] == sum(plan["blocks_per_layer"]) <= wk.H100_SMS
    for l, type_ in enumerate(_layer_types(G, backward)):
        ty = plan["types"][type_]
        u, blocks = ty["units"], ty["blocks"]
        assert plan["units_per_block"][l] == u and plan["blocks_per_layer"][l] == blocks
        gates = 1 if backward else 4
        owned = sorted(q * H + b * u + j for b in range(blocks) for q in range(gates)
                       for j in range(u) if b * u + j < H)
        assert owned == list(range(gates * H))  # each row of the layer exactly once
        assert (blocks - 1) * u < H  # no block without a unit
        assert plan["rows_per_block"][l] == gates * u


@pytest.mark.parametrize("G,H,B,dtype,backward", CASES)
def test_plan_fits_shared_memory_and_streams_what_is_not_resident(G, H, B, dtype, backward):
    plan = wavefront_plan(G, B, H, dtype, backward)
    es = dtype.itemsize
    assert plan["smem_bytes"] <= MAX_SMEM_BYTES
    sizes = [wk.type_smem_bytes(ty, *wk._shape(i, ty["units"], H, backward), B, es)
             for i, ty in enumerate(plan["types"]) if ty]
    assert plan["smem_bytes"] == max(sizes)
    assert plan["weight_bytes"] == (2 * G - 1) * 4 * H * H * es
    assert plan["streamed_bytes_per_superstep"] == plan["weight_bytes"] - plan["resident_bytes"]
    assert 0 <= plan["resident_bytes"] <= plan["weight_bytes"]
    for l, type_ in enumerate(_layer_types(G, backward)):
        assert 0 <= plan["resident_rows"][l] <= plan["rows_per_block"][l]
    K = [wk._shape(t, plan["types"][t]["units"], H, backward)[1]
         for t in _layer_types(G, backward)]
    assert plan["exchange_bytes_per_superstep"] == sum(
        nb * B * k * es for nb, k in zip(plan["blocks_per_layer"], K))
    for ty in plan["types"]:
        if ty:
            assert ty["kc"] in wk.CHUNKS[es] and 2 <= ty["xs"] <= wk.MAX_X_STAGES
            assert ty["units"] % 2 == 0  # the gate inputs move in 4-byte copies


@pytest.mark.parametrize("dtype", DTYPES)
def test_small_layers_stay_resident_and_full_width_streams(dtype):
    """The kernel tests' small shapes keep every row resident; at base-85M's
    post-stack most of the weights stream a superstep."""
    for backward in (False, True):
        small = wavefront_plan(3, 5, 136, dtype, backward)
        assert small["resident_bytes"] == small["weight_bytes"]
        wide = wavefront_plan(6, 16, 1024, dtype, backward)
        assert wide["streamed_bytes_per_superstep"] > wide["weight_bytes"] // 2


def test_plan_splits_the_grid_by_the_layers_weights():
    """Type B's rows are twice as long: type A's layer gets from its share of
    the weights (one of 2G - 1) up to an equal share of the grid, and no
    more blocks than a type-B layer (at base-85M's post-stack, bf16)."""
    G, sms = 6, wk.H100_SMS
    for backward in (False, True):
        plan = wavefront_plan(G, 16, 1024, torch.bfloat16, backward, sms)
        a, b = plan["types"]
        assert sms // (2 * G - 1) <= a["blocks"] <= sms // G
        assert b["blocks"] >= a["blocks"] and b["units"] <= a["units"]
        assert plan["blocks"] == a["blocks"] + (G - 1) * b["blocks"] <= sms


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_shape_that_cannot_fit_raises(dtype):
    with pytest.raises(ValueError, match="batch rows"):  # more tiles than a block holds
        wavefront_plan(2, 2048, 32, dtype)
    with pytest.raises(ValueError, match="multiple of 8"):
        wavefront_plan(2, 8, 12, dtype)
    with pytest.raises(ValueError):
        wavefront_plan(0, 8, 32, dtype)


@pytest.mark.parametrize("G,H,B,dtype,backward", CASES)
def test_packing_scratch_holds_every_streamed_chunk(G, H, B, dtype, backward):
    """packed_elems: per type, a stage's image ([srows, ld_stage]) for every
    chunk of every block of its layers, enough for every streamed value;
    none for a type that streams nothing."""
    plan = wavefront_plan(G, B, H, dtype, backward)
    es = dtype.itemsize
    elems = wk.packed_elems(plan)
    assert len(elems) == 2
    for type_, ty in enumerate(plan["types"][:2]):
        if ty is None:
            assert elems[type_] == 0
            continue
        rows, K, nseg, _ = wk._shape(type_, ty["units"], H, backward)
        srows = -(-rows // 16) * 16 - ty["res"]
        stage = srows * wk._stage_ld(ty["kc"], es)
        chunks = nseg * -(-(K // nseg) // ty["kc"])
        layers = _layer_types(G, backward).count(type_)
        assert elems[type_] == layers * ty["blocks"] * chunks * stage
        assert elems[type_] * es >= layers * ty["blocks"] * (rows - ty["res"]) * K * es
    assert sum(elems) * es >= plan["streamed_bytes_per_superstep"]


@pytest.mark.parametrize("G,H,B,dtype,backward", [c for c in CASES if c[0] > 1])
def test_plan_takes_the_cheapest_split_of_the_grid(G, H, B, dtype, backward):
    """The split is priced by its dearest block (``_split_cost_us``): no
    split from type A's share of the weights to an equal share is cheaper,
    and none priced alike gives type A more blocks."""
    plan = wavefront_plan(G, B, H, dtype, backward)
    es, sms = dtype.itemsize, wk.H100_SMS
    cost = wk._split_cost_us(plan["types"], H, es, backward)
    assert cost == max(wk._cost_us(t, *wk._shape(i, t["units"], H, backward)[:3], es,
                                   wk.SPLIT_CHUNK_US) for i, t in enumerate(plan["types"]))
    narrow = any(es == 2 and t["kc"] == 32 for t in plan["types"])
    for target in range(max(1, sms // (2 * G - 1)), sms // G + 1):
        try:
            a = wk._type_plan(0, target, G, B, H, es, backward, narrow)
            b = wk._type_plan(1, max(1, (sms - a["blocks"]) // (G - 1)), G, B, H, es, backward,
                              narrow)
        except ValueError:
            continue
        other = wk._split_cost_us([a, b], H, es, backward)
        assert cost <= other
        if other == cost:
            assert a["blocks"] <= plan["types"][0]["blocks"]
