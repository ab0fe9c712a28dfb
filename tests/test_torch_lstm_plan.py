"""The persistent LSTM kernels' plan (``lstm_kernel.lstm_plan``), on the CPU:
how a layer's hidden units and batch are split over the card's SMs, and how
much of w_hh each block keeps resident in shared memory. The kernels
(``csrc/lstm_recurrence*.cu``) check the same numbers at launch; their
tests on the card are in ``tests/test_torch_kernel.py``.
"""

import pytest
import torch

from caiman_asr_tpu_torch.ops import lstm_kernel
from caiman_asr_tpu_torch.ops.cuda_build import MAX_SMEM_BYTES
from caiman_asr_tpu_torch.ops.lstm_kernel import lstm_plan

# the encoder and predictor widths of base-85M (1024, 512) and large-196M
# (1536, 768)
WIDTHS = (512, 768, 1024, 1536)
DTYPES = (torch.float32, torch.bfloat16)
CASES = [(B, H, dtype, backward) for H in WIDTHS for dtype in DTYPES
         for backward in (False, True) for B in (1, 16, 64)]


@pytest.mark.parametrize("B,H,dtype,backward", CASES)
def test_plan_covers_every_hidden_unit_once(B, H, dtype, backward):
    plan = lstm_plan(B, H, dtype, backward)
    units, blocks, bsplit = plan["units"], plan["blocks"], plan["bsplit"]
    assert units % 4 == 0 and blocks * bsplit <= lstm_kernel.H100_SMS
    owned = [u for x in range(blocks) for u in range(x * units, min(H, (x + 1) * units))]
    assert owned == list(range(H))
    assert (blocks - 1) * units < H  # no block without a unit
    slice_rows = -(-B // bsplit)
    rows = [b for y in range(bsplit) for b in range(y * slice_rows, min(B, (y + 1) * slice_rows))]
    assert rows == list(range(B)) and (bsplit - 1) * slice_rows < B  # no empty slice
    assert plan["rows"] == (units if backward else 4 * units)


@pytest.mark.parametrize("B,H,dtype,backward", CASES)
def test_plan_fits_shared_memory_and_is_partial_only_where_it_must_be(B, H, dtype, backward):
    plan = lstm_plan(B, H, dtype, backward)
    assert plan["smem_bytes"] <= MAX_SMEM_BYTES
    assert 0 <= plan["resident_rows"] <= plan["rows"]
    K = 4 * H if backward else H
    assert plan["resident_bytes"] == plan["resident_rows"] * K * dtype.itemsize
    assert plan["resident_bytes"] <= plan["smem_bytes"]
    es, rows, u = dtype.itemsize, plan["rows"], plan["units"]
    stage = 8 * u if backward else 4 * u

    def size(res_rows, chunk):
        return lstm_kernel.smem_bytes(rows, res_rows, K, stage, es, plan["carry_floats"], chunk,
                                      plan["group"])

    assert size(plan["resident_rows"], plan["chunk"]) == plan["smem_bytes"]
    # fp32 stages the contraction in chunks, bf16 does not
    chunks = lstm_kernel.CHUNKS if es == 4 else (0,)
    assert plan["chunk"] in chunks
    # partial exactly where no chunk lets every row stay resident
    fits = [c for c in chunks if size(rows, c) <= MAX_SMEM_BYTES]
    assert (plan["mode"] == "partial") == (not fits)
    if plan["mode"] == "partial":  # at the longest chunk after the first that fits
        assert plan["chunk"] == next(c for c in chunks[1:] if size(0, c) <= MAX_SMEM_BYTES)
        assert size(plan["resident_rows"] + 1, plan["chunk"]) > MAX_SMEM_BYTES
        assert plan["l2_weight_bytes_per_step"] > 0
    else:  # at the first chunk that fits
        assert plan["chunk"] == fits[0]
        assert plan["l2_weight_bytes_per_step"] == 0


def test_fp32_at_1536_is_the_only_partly_resident_model_width():
    for H in WIDTHS:
        for dtype in DTYPES:
            for backward in (False, True):
                plan = lstm_plan(64, H, dtype, backward)
                want = "partial" if (H, dtype) == (1536, torch.float32) else "resident"
                assert plan["mode"] == want, (H, dtype, backward, plan)
    fwd = lstm_plan(16, 1536, torch.float32)
    assert (fwd["blocks"], fwd["units"], fwd["rows"]) == (128, 12, 48)
    assert 0 < fwd["resident_rows"] < 48


def test_the_plan_at_the_encoders_widths():
    # 128 blocks of 8 units at H=1024 and of 12 at H=1536, as the TPU kernel
    # keeps a layer's w_hh resident: bf16, 64 KiB and 144 KiB of rows a block
    for H, units in ((1024, 8), (1536, 12)):
        plan = lstm_plan(16, H, torch.bfloat16)
        assert (plan["blocks"], plan["bsplit"], plan["units"]) == (128, 1, units)
        assert plan["resident_bytes"] == 4 * units * H * 2


def test_the_batch_split():
    # the backward splits base's B=16 in two slices of 8 (16 units a block)
    bwd = lstm_plan(16, 1024, torch.bfloat16, backward=True)
    assert (bwd["blocks"], bwd["bsplit"], bwd["units"]) == (64, 2, 16)
    # the forward splits only slices of 32 rows or more
    assert lstm_plan(16, 1024, torch.bfloat16)["bsplit"] == 1
    assert lstm_plan(64, 768, torch.bfloat16)["bsplit"] == 2
    # large-196M's encoder: a second copy of its rows would not fit
    assert lstm_plan(64, 1536, torch.bfloat16, backward=True)["bsplit"] == 1
    # the exchange a step: each block reads its slice's rows
    p = lstm_plan(16, 1024, torch.bfloat16, backward=True)
    assert p["exchange_bytes_per_step"] == p["blocks"] * 16 * 4096 * 2


def test_the_split_follows_the_cards_sms():
    assert lstm_plan(16, 1024, torch.bfloat16, sms=66)["units"] == 16
    assert lstm_plan(16, 1024, torch.bfloat16, sms=1000)["units"] == 4


def test_the_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        lstm_plan(16, 1020, torch.bfloat16)  # H not a multiple of 8
    with pytest.raises(ValueError):  # more units a block than the backward stages
        lstm_plan(16, 16384, torch.bfloat16, backward=True)


def test_fp32_stages_its_contraction_in_chunks():
    # base-85M's encoder: every row resident at chunks of 256 floats, in one
    # group of its 16 batch rows; large-196M's partly resident, its other
    # rows read once a step for a group of up to 64 batch rows
    base = lstm_plan(16, 1024, torch.float32)
    assert (base["mode"], base["chunk"], base["group"]) == ("resident", 256, 16)
    for backward in (False, True):
        large = lstm_plan(64, 1536, torch.float32, backward)
        assert large["mode"] == "partial" and large["chunk"] >= 4 * large["ksplit"]
        K = 4 * 1536 if backward else 1536
        slice_rows = -(-64 // large["bsplit"])
        assert large["group"] == min(64, slice_rows)
        assert large["l2_weight_bytes_per_step"] == (
            large["blocks"] * large["bsplit"] * (large["rows"] - large["resident_rows"]) * K * 4)
    bf16 = lstm_plan(64, 1536, torch.bfloat16)
    assert (bf16["chunk"], bf16["group"]) == (0, 64)
    # where a pass's staged rows would not fit at 128 floats, shorter chunks:
    # H=4,096's forward stages 125 of its 128 rows
    wide = lstm_plan(16, 4096, torch.float32)
    assert (wide["rows"], wide["chunk"]) == (128, 64) and wide["smem_bytes"] <= MAX_SMEM_BYTES


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B", [16, 32, 64])
def test_partly_resident_plans_read_the_fewest_bytes(B, backward):
    # fp32 at H=1,536: of every batch split and group that fits and gives
    # each part of k a step a chunk, the plan reads the fewest bytes a step
    plan = lstm_plan(B, 1536, torch.float32, backward)
    others = []
    for bsplit in (1, 2, 4):
        slice_rows = -(-B // bsplit)
        if bsplit > 1 and slice_rows < lstm_kernel.MIN_SLICE_ROWS[backward]:
            continue
        for group in {g for g in (min(64, -(-slice_rows // 8) * 8), 32, 16, 8)
                      if g <= min(64, -(-slice_rows // 8) * 8)}:
            try:
                other = lstm_kernel._plan_split(B, 1536, 4, backward, lstm_kernel.H100_SMS,
                                                bsplit, group)
            except ValueError:
                continue
            if other["chunk"] >= 4 * other["ksplit"]:
                others.append(other["l2_bytes_per_step"])
    assert plan["mode"] == "partial" and plan["l2_bytes_per_step"] == min(others)


# (B, dtype) -> the fewest slices lstm_plan takes at the encoder's H=1,024
# on the H100's 132 SMs (the serving tick's batches; bench_serving's ladder)
SPLITS = {(4096, torch.bfloat16): 1, (6144, torch.bfloat16): 2, (8192, torch.bfloat16): 2,
          (16384, torch.bfloat16): 3, (4096, torch.float32): 1, (6144, torch.float32): 1,
          (8192, torch.float32): 2, (16384, torch.float32): 3}


@pytest.mark.parametrize("B,dtype", sorted(SPLITS, key=str))
def test_batch_slices_are_the_fewest_the_plan_takes(B, dtype):
    n = lstm_kernel.batch_slices(B, 1024, dtype)
    assert n == SPLITS[B, dtype]
    rows = -(-B // n)
    assert (n - 1) * rows < B  # no empty slice
    lstm_plan(rows, 1024, dtype)  # a slice has a plan
    if n > 1:  # and one slice fewer has none
        with pytest.raises(ValueError, match="no plan fits"):
            lstm_plan(-(-B // (n - 1)), 1024, dtype)


def test_batch_slices_raise_where_no_slice_fits():
    with pytest.raises(ValueError):
        lstm_kernel.batch_slices(64, 1020, torch.bfloat16)  # H not a multiple of 8
