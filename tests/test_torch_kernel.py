"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card: the LSTM recurrence forward (K1), its store-gates variant (K3a)
and backward (K3b) (``caiman_asr_tpu_torch/ops/csrc/lstm_recurrence*.cu``),
the joint's forward (K2, K5-store, K7-store8), its backward passes over a
stored slab as calls of their own (K5-A, K5-B, K7-A8, K7-B8), its one-call
backwards over the bf16 slab (K5-fused-u), over the int8 slab (K7-fused-u8)
and with no slab (K6-fused), and the backwards that derive again per pass
(K6-derive-a for the rechunked route, K4-A and K4-B over a column range)
(``csrc/joint_fwd.cu``, ``csrc/joint_bwd.cu``, ``csrc/joint_bwd_fused.cu``,
``csrc/joint_bwd_recompute.cu``), the bf16 passes A and B under all of them
on each of their staging paths (``csrc/joint_bwd.cuh``,
``csrc/joint_sm90.cuh``), the bf16 forward (its three modes) and the
derivation alone on each of theirs (``csrc/joint_prod_sm90.cuh``), and the
wavefront multi-layer LSTM's
forward, without and with stored gates (K8-fwd), and backward (K8-bwd)
(``csrc/lstm_wavefront.cu``, ``csrc/lstm_wavefront_bwd.cu``); K1 also at the
serving tick's batch of 8,192, where it runs once per batch slice; the
fused LAMB finish's three passes (``csrc/lamb_finish.cu``) at unaligned
leaves, with a None gradient, an overwrite leaf and NaN and inf entries,
pass 0's persistent grid at layouts that cross its runs, hold many tiny
leaves, empty leaves and gradients at 4-byte offsets, and ``Lamb.update``
on the card through them.

A CUDA kernel has no interpret mode, so these tests need a GPU and nvcc and
skip elsewhere; run them on the card with
``python -m pytest tests/test_torch_kernel.py -q --noconftest``.

Tolerances, each from the arithmetic that differs between kernel and plain
version: fp32 1e-4 (sums in another order); bf16 LSTM 2e-2 (h or dgates
rounded to bf16 for the product, sums in another order over H or 4H, and a
bf16 rounding that falls the other way carried through later steps); the
joint GEMMs 1e-4 relative to the result's scale (fp32 accumulation in
another order; both sides round the same fp32 values to bf16); the stored
slab u one bf16 ulp (2^-7 relative: z differs in its last fp32 bits);
gradients through the bf16 slab atol 2e-3 / rtol 1e-3 against a dense
fp32 reference, the JAX package's own tolerance for that route
(``tests/ops/test_pallas_joint.py``), and 5e-2 / 5e-2 through the int8 slab,
likewise; the int8 slab itself equal to the plain version's or one step
apart on at most 0.1% of the entries (where ``u * (127 / m)`` differs in its
last bit at a rounding boundary), its scales, each one value of u = exp(z), at rtol
5e-5 (z, up to ~15 at these inputs, differs in its last fp32 bits between
the kernel's product and the plain version's). K6-fused with bf16 inputs:
1e-3 of the result's scale, since u and dz are rounded to bf16 inside from
values that differ in their last fp32 bits, and a rounding that falls the
other way moves one term by 2^-8; the same for K6-derive-a, K4-A and K4-B,
which round what they derive to bf16 for their second product. The LAMB
finish: the moments equal to the bit (the plain version's operation order,
no FMA contraction), the squared norms 1e-6 relative (sums in another
order), the parameters and EMA 1e-6 of each leaf's largest magnitude (the
trust ratio from norms summed in another order).
"""

import ctypes

import numpy as np
import pytest
import torch

from caiman_asr_tpu_torch.ops import finish_kernel as fk
from caiman_asr_tpu_torch.ops import joint_kernel as jk
from caiman_asr_tpu_torch.ops import lstm_kernel
from caiman_asr_tpu_torch.ops import wavefront_kernel as wk
from caiman_asr_tpu_torch.ops.wavefront import WavefrontLSTM, stack_operands

pytestmark = pytest.mark.gpu

LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *shape, s=1.0: torch.from_numpy(
        (rng.normal(size=shape) * s).astype(np.float32)).to(device, dtype)
    return (mk(T, B, 4 * H, s=0.5), mk(4 * H, H, s=1 / np.sqrt(3 * H)),
            mk(B, H, s=0.1), mk(B, H, s=0.1))


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


SHAPES = [(10, 8, 32), (7, 5, 40), (3, 33, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_kernel_matches_plain(cuda, dtype, hard, T, B, H):
    args = _inputs(T, B, H, dtype, cuda)
    before = lstm_kernel.lstm_recurrence.launches
    ys, cs = lstm_kernel.lstm_recurrence(*args, hard)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_recurrence.launches == before + 1  # one launch per layer
    ys_ref, cs_ref = lstm_kernel.lstm_recurrence_plain(*args, hard)
    assert ys.dtype == cs.dtype == dtype
    _close(ys, ys_ref, LSTM_TOL[dtype])
    _close(cs, cs_ref, LSTM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_store_gates_kernel_matches_plain(cuda, dtype, hard, T, B, H):
    args = _inputs(T, B, H, dtype, cuda, seed=1)
    before = lstm_kernel.lstm_recurrence_sg.launches
    got = lstm_kernel.lstm_recurrence_sg(*args, hard)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_recurrence_sg.launches == before + 1
    want = lstm_kernel.lstm_recurrence_sg_plain(*args, hard)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close(g, w, LSTM_TOL[dtype])
    # K3a's ys and cs are K1's
    ys, cs = lstm_kernel.lstm_recurrence(*args, hard)
    assert torch.equal(ys, got[0]) and torch.equal(cs, got[1])


def _bwd_inputs(T, B, H, dtype, device, hard, seed=2):
    gx, w_hh, h0, c0 = _inputs(T, B, H, dtype, device, seed)
    ys, cs, gs = lstm_kernel.lstm_recurrence_sg_plain(gx, w_hh, h0, c0, hard)
    c_prev = torch.cat([c0[None], cs[:-1]])
    rng = np.random.default_rng(seed + 1)
    dys = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(device, dtype)
    dcs = torch.from_numpy((rng.normal(size=(T, B, H)) * 0.3).astype(np.float32)).to(device, dtype)
    return gs, c_prev, cs, dys, dcs, w_hh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_backward_kernel_matches_plain(cuda, dtype, hard, T, B, H):
    args = _bwd_inputs(T, B, H, dtype, cuda, hard)
    before = lstm_kernel.lstm_recurrence_bwd.launches
    dg, dh0, dc0 = lstm_kernel.lstm_recurrence_bwd(*args, hard)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_recurrence_bwd.launches == before + 1  # dh0 in the same launch
    dg_ref, dh0_ref, dc0_ref = lstm_kernel.lstm_recurrence_bwd_plain(*args, hard)
    assert dg.dtype == dtype and dh0.dtype == dc0.dtype == torch.float32
    scale = max(1.0, dg_ref.float().abs().max().item())
    for g, w in ((dg, dg_ref), (dh0, dh0_ref), (dc0, dc0_ref)):
        _close(g, w, LSTM_TOL[dtype] * scale)


@pytest.mark.parametrize("store_gates", [True, False])
def test_recurrence_vjp_on_the_card_matches_the_cpu(cuda, store_gates):
    gx, w_hh, h0, c0 = _inputs(9, 6, 40, torch.float32, "cpu", seed=3)
    wy = torch.randn(9, 6, 40, generator=torch.Generator().manual_seed(0))

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in (gx, w_hh, h0, c0)]
        ys, cs = lstm_kernel.recurrence(*leaves, False, store_gates)
        loss = (ys * wy.to(device)).sum() + 0.3 * (cs ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    for g, w in zip(grads(cuda), grads("cpu")):
        _close(g.cpu(), w, 1e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    gx, w, h0, c0 = _inputs(4, 2, 32, torch.float32, cuda)
    with pytest.raises(TypeError):
        lstm_kernel.lstm_recurrence(gx.half(), w.half(), h0.half(), c0.half())
    with pytest.raises(ValueError):
        lstm_kernel.lstm_recurrence(gx, w.t().contiguous().t(), h0, c0)
    with pytest.raises(ValueError):
        lstm_kernel.lstm_recurrence(gx, w, h0.cpu(), c0)
    gx, w, h0, c0 = _inputs(4, 2, 12, torch.float32, cuda)
    with pytest.raises(ValueError):  # H not a multiple of 8
        lstm_kernel.lstm_recurrence(gx, w, h0, c0)


# The persistent kernels at the model's widths (the predictor's 512 and
# 768, the encoders' 1024 and 1536) and batches; fp32 at 1536 takes the
# partly resident mode. T=1 and T=2: the greedy predictor and the serving
# tick.
PLAN_SHAPES = [(4, B, H) for H in (512, 1024, 1536) for B in (8, 16, 64)] + [
    (1, 8, 512), (2, 16, 1024), (1, 64, 768), (2, 5, 1536)]


def _check_layer(cuda, dtype, hard, T, B, H, seed):
    args = _inputs(T, B, H, dtype, cuda, seed)
    kept = [a.clone() for a in args]
    counts = (lstm_kernel.lstm_recurrence_sg.launches, lstm_kernel.lstm_recurrence_bwd.launches)
    got = lstm_kernel.lstm_recurrence_sg(*args, hard)
    torch.cuda.synchronize()
    want = lstm_kernel.lstm_recurrence_sg_plain(*args, hard)
    for g, w in zip(got, want):
        _close(g, w, LSTM_TOL[dtype])
    ys, cs = lstm_kernel.lstm_recurrence(*args, hard)
    assert torch.equal(ys, got[0]) and torch.equal(cs, got[1])
    bwd_args = _bwd_inputs(T, B, H, dtype, cuda, hard, seed + 1)
    dg, dh0, dc0 = lstm_kernel.lstm_recurrence_bwd(*bwd_args, hard)
    torch.cuda.synchronize()
    ref = lstm_kernel.lstm_recurrence_bwd_plain(*bwd_args, hard)
    scale = max(1.0, ref[0].float().abs().max().item())
    for g, w in zip((dg, dh0, dc0), ref):
        _close(g, w, LSTM_TOL[dtype] * scale)
    assert (lstm_kernel.lstm_recurrence_sg.launches,
            lstm_kernel.lstm_recurrence_bwd.launches) == (counts[0] + 1, counts[1] + 1)
    for a, k in zip(args, kept):  # h0 and c0 (and every input) are not written
        assert torch.equal(a, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("T,B,H", PLAN_SHAPES)
def test_persistent_kernels_at_model_widths(cuda, dtype, hard, T, B, H):
    _check_layer(cuda, dtype, hard, T, B, H, seed=5)


@pytest.mark.parametrize("B", [5, 20])
@pytest.mark.parametrize("H", [2048, 4096])
def test_fp32_tiles_past_the_model_widths(cuda, B, H):
    # fp32's threads sum tiles of 8 rows at H=2,048 (64 rows forward, 16
    # backward) and at H=4,096 (128 rows forward, staged in chunks of 64
    # floats, and 32 backward); B=5 leaves most of a batch group empty,
    # B=20 takes two
    for backward in (False, True):
        plan = lstm_kernel.lstm_plan(B, H, torch.float32, backward,
                                     lstm_kernel._sm_count(cuda.index or 0))
        assert plan["rows"] == (H // plan["blocks"] if backward else 4 * H // plan["blocks"])
    _check_layer(cuda, torch.float32, False, 3, B, H, seed=12)


@pytest.mark.parametrize("backward", [False, True])
def test_fp32_at_1536_is_partly_resident(cuda, backward):
    plan = lstm_kernel.lstm_plan(16, 1536, torch.float32, backward,
                                 lstm_kernel._sm_count(cuda.index or 0))
    assert plan["mode"] == "partial" and 0 < plan["resident_rows"] < plan["rows"]
    _check_layer(cuda, torch.float32, False, 6, 16, 1536, seed=7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 2])
def test_batch_split_kernel_matches_plain(cuda, dtype, T):
    # the serving tick's shapes past one launch's batch: B=8,192 at the
    # encoder's H=1,024 runs K1 once per slice (2 x 4,096 in both dtypes)
    B, H = 8192, 1024
    n = lstm_kernel.batch_slices(B, H, dtype, lstm_kernel._sm_count(cuda.index or 0))
    assert n == 2
    args = _inputs(T, B, H, dtype, cuda, seed=13)
    before = lstm_kernel.lstm_recurrence.launches
    ys, cs = lstm_kernel.lstm_recurrence(*args)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_recurrence.launches == before + n
    ys_ref, cs_ref = lstm_kernel.lstm_recurrence_plain(*args, False)
    _close(ys, ys_ref, LSTM_TOL[dtype])
    _close(cs, cs_ref, LSTM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_uneven_batch_split_kernel_matches_plain(cuda, dtype):
    # slices of 5,001 and 5,000 rows, each launch reading and writing its
    # rows of the layer's tensors in place through the kernel's row stride
    B, H = 10001, 1024
    assert lstm_kernel.batch_slices(B, H, dtype, lstm_kernel._sm_count(cuda.index or 0)) == 2
    args = _inputs(2, B, H, dtype, cuda, seed=14)
    ys, cs = lstm_kernel.lstm_recurrence(*args)
    torch.cuda.synchronize()
    ys_ref, cs_ref = lstm_kernel.lstm_recurrence_plain(*args, False)
    _close(ys, ys_ref, LSTM_TOL[dtype])
    _close(cs, cs_ref, LSTM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_persistent_kernels_are_deterministic(cuda, dtype):
    args = _inputs(12, 33, 1024, dtype, cuda, seed=8)
    a, b = (lstm_kernel.lstm_recurrence_sg(*args) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    bwd_args = _bwd_inputs(12, 33, 1024, dtype, cuda, False, seed=9)
    a, b = (lstm_kernel.lstm_recurrence_bwd(*bwd_args) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_grid_that_cannot_be_resident_raises(cuda, monkeypatch):
    # as if the card had 1,000 SMs: the plan takes 512 blocks of 8 units at
    # H=4096, each with nearly all of an SM's shared memory
    monkeypatch.setattr(lstm_kernel, "_sm_count", lambda index: 1000)
    gx, w, h0, c0 = _inputs(2, 2, 4096, torch.bfloat16, cuda, seed=10)
    assert lstm_kernel.lstm_plan(2, 4096, torch.bfloat16, sms=1000)["blocks"] == 512
    with pytest.raises(ValueError, match="cannot all be resident"):
        lstm_kernel.lstm_recurrence(gx, w, h0, c0)
    bwd_args = _bwd_inputs(2, 2, 4096, torch.bfloat16, cuda, False, seed=11)
    with pytest.raises(ValueError, match="cannot all be resident"):
        lstm_kernel.lstm_recurrence_bwd(*bwd_args)


def test_the_kernels_shared_memory_matches_the_plan(cuda):
    lib = lstm_kernel._fwd_lib()
    for H in (512, 768, 1024, 1536, 2048):
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                plan = lstm_kernel.lstm_plan(16, H, dtype, backward)
                u, es = plan["units"], dtype.itemsize
                K, stage = (4 * H, 8 * u) if backward else (H, 4 * u)
                assert lib.lstm_recurrence_smem_bytes(
                    plan["rows"], plan["resident_rows"], K, stage, es,
                    plan["carry_floats"], plan["chunk"], plan["group"]) == plan["smem_bytes"]


# ---------------------------------------------------------------- the joint
def _joint_inputs(N, Hj, K, dtype, device, seed=4):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(N, Hj)).astype(np.float32)).to(device, dtype)
    wt = torch.from_numpy((rng.normal(size=(K, Hj)) * 0.1).astype(np.float32)).to(device, dtype)
    b = torch.from_numpy((rng.normal(size=(K,)) * 0.1).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, K - 1, N).astype(np.int32)).to(device)
    cs = torch.from_numpy((rng.normal(size=(N,)) * 1e-2).astype(np.float32)).to(device)
    cl = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)).to(device)
    return h, wt, b, labels, cs, cl


def _rel_close(got, want, rtol=1e-4):
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=rtol * scale)


# the last: a long pass-B contraction (20,000 rows), where tensor-core
# accumulation drifts unless it is flushed
JOINT_SHAPES = [(70, 32, 600), (300, 96, 1000), (513, 768, 8704), (20000, 128, 384)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K", JOINT_SHAPES)
def test_joint_forward_kernels_match_plain(cuda, dtype, N, Hj, K):
    h, wt, b, *_ = _joint_inputs(N, Hj, K, dtype, cuda)
    before = (jk.joint_fwd.launches, jk.joint_fwd_store.launches)
    sums, none = jk.joint_fwd(h, wt, b)
    sums_s, u = jk.joint_fwd_store(h, wt, b)
    torch.cuda.synchronize()
    assert (jk.joint_fwd.launches, jk.joint_fwd_store.launches) == (before[0] + 1, before[1] + 1)
    ref_sums, ref_u = jk.joint_fwd_store_plain(h, wt, b)
    assert none is None and u.dtype == torch.bfloat16 and u.shape == (N, K)
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=0)
    assert torch.equal(sums, sums_s)
    torch.testing.assert_close(u.float(), ref_u.float(), rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K", JOINT_SHAPES)
def test_joint_backward_kernels_match_plain(cuda, dtype, N, Hj, K):
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, dtype, cuda)
    _, u = jk.joint_fwd_store_plain(h, wt, b)
    w = wt.t().contiguous()
    before = (jk.joint_bwd_dh.launches, jk.joint_bwd_dw.launches)
    smear = jk.joint_bwd_dh(u, w, cs)
    dw, db = jk.joint_bwd_dw(h, u, cs, cl, labels)
    torch.cuda.synchronize()
    assert (jk.joint_bwd_dh.launches, jk.joint_bwd_dw.launches) == (before[0] + 1, before[1] + 1)
    _rel_close(smear, jk.joint_bwd_dh_plain(u, w, cs))
    ref_dw, ref_db = jk.joint_bwd_dw_plain(h, u, cs, cl, labels)
    _rel_close(dw, ref_dw)
    _rel_close(db, ref_db)


@pytest.mark.parametrize("blank", [599, 100])
def test_fused_joint_lse_on_the_card_matches_a_dense_reference(cuda, blank):
    """The whole forward + backward (blank in the last and in a non-final
    tile, N and K unaligned) against dense autograd in fp32."""
    N, Hj, K = 70, 32, 600
    h, wt, b, labels, _, _ = _joint_inputs(N, Hj, K, torch.float32, cuda, seed=5)
    w = wt.t().contiguous()
    rng = np.random.default_rng(6)
    cb, cl = (torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)).to(cuda)
              for _ in range(2))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (h, w, b)]
        lb, ll = fn(*leaves)
        loss = (lb * cb).sum() + (ll * cl).sum()
        return (lb, ll) + torch.autograd.grad(loss, leaves)

    def dense(h, w, b):
        z = h @ w + b
        d = torch.logsumexp(z, 1)
        return z[:, blank] - d, z.gather(1, labels.long()[:, None])[:, 0] - d

    got = run(lambda h, w, b: jk.fused_joint_lse(h, w, b, labels, blank))
    want = run(dense)
    for g, r in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    for g, r in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=2e-3)


def test_joint_kernels_reject_what_they_do_not_take(cuda):
    h, wt, b, labels, cs, cl = _joint_inputs(16, 8, 40, torch.float32, cuda)
    with pytest.raises(TypeError):
        jk.joint_fwd(h.half(), wt.half(), b)
    with pytest.raises(TypeError):
        jk.joint_fwd(h, wt, b.double())
    with pytest.raises(ValueError):
        jk.joint_fwd(h, wt.t().contiguous().t(), b)
    _, u = jk.joint_fwd_store(h, wt, b)
    with pytest.raises(TypeError):
        jk.joint_bwd_dw(h, u, cs, cl, labels.long())
    with pytest.raises(ValueError):
        jk.joint_bwd_dh(u, wt, cs)  # w must be [Hj, K]


# ------------------------------------------- the int8 slab and no slab
# (N, Hj, K, kt): one scale tile; three with a ragged last one; large-196M's
# widths (8.5 tiles of 2,048); scale tiles as narrow as the kernel's own
I8_SHAPES = [(70, 32, 600, 1024), (300, 96, 2500, 1024), (513, 1024, 17408, 2048),
             (260, 64, 1000, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K,kt", I8_SHAPES)
def test_joint_store8_kernel_matches_plain(cuda, dtype, N, Hj, K, kt):
    h, wt, b, *_ = _joint_inputs(N, Hj, K, dtype, cuda, seed=8)
    before = jk.joint_fwd_store8.launches
    sums, q, s = jk.joint_fwd_store8(h, wt, b, kt)
    torch.cuda.synchronize()
    assert jk.joint_fwd_store8.launches == before + 1
    ref_sums, ref_q, ref_s = jk.joint_fwd_store8_plain(h, wt, b, kt)
    assert q.dtype == torch.int8 and q.shape == (N, K) and s.shape == (-(-K // kt), N)
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=0)
    assert torch.equal(sums, jk.joint_fwd(h, wt, b)[0])
    torch.testing.assert_close(s, ref_s, rtol=5e-5, atol=0)
    diff = (q.int() - ref_q.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() <= 1e-3
    assert q.max().item() == 127 and q.min().item() >= 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K,kt", I8_SHAPES + [(20000, 128, 384, 128)])
def test_joint_fused_u8_kernel_matches_plain(cuda, dtype, N, Hj, K, kt):
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, dtype, cuda, seed=9)
    _, q, s = jk.joint_fwd_store8_plain(h, wt, b, kt)
    w = wt.t().contiguous()
    before = jk.joint_bwd_fused_u8.launches
    got = jk.joint_bwd_fused_u8(h, q, s, w, cs, cl, labels, kt)
    torch.cuda.synchronize()
    assert jk.joint_bwd_fused_u8.launches == before + 2
    for g, r in zip(got, jk.joint_bwd_fused_u8_plain(h, q, s, w, cs, cl, labels, kt)):
        _rel_close(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K", JOINT_SHAPES + [(513, 1024, 17408)])
@pytest.mark.parametrize("ws_rows", [None, 256], ids=["one-chunk", "chunks"])
def test_joint_fused_kernel_matches_plain(cuda, monkeypatch, dtype, N, Hj, K, ws_rows):
    """``chunks``: a workspace of 256 rows, so the rows are walked in several
    chunks and pass B adds into dw and db in place."""
    if ws_rows is not None:
        monkeypatch.setattr(jk, "FUSED_WS_BYTES", ws_rows * K * 4)
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, dtype, cuda, seed=10)
    w = wt.t().contiguous()
    chunks = -(-N // jk.fused_workspace_rows(N, K))
    assert chunks == (1 if ws_rows is None else -(-N // ws_rows))
    before = jk.joint_bwd_fused.launches
    got = jk.joint_bwd_fused(h, w, b, cs, cl, labels)
    torch.cuda.synchronize()
    assert jk.joint_bwd_fused.launches == before + 3 * chunks
    for g, r in zip(got, jk.joint_bwd_fused_plain(h, w, b, cs, cl, labels)):
        _rel_close(g, r, 1e-4 if dtype == torch.float32 else 1e-3)


# ------------- each pass a call of its own; the bf16 slab behind one call
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K,kt", I8_SHAPES + [(20000, 128, 384, 128)])
def test_joint_int8_pass_kernels_match_plain(cuda, dtype, N, Hj, K, kt):
    """K7-A8 and K7-B8: the halves of K7-fused-u8, bit for bit."""
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, dtype, cuda, seed=9)
    _, q, s = jk.joint_fwd_store8_plain(h, wt, b, kt)
    w = wt.t().contiguous()
    before = (jk.joint_bwd_dh_u8.launches, jk.joint_bwd_dw_u8.launches)
    smear = jk.joint_bwd_dh_u8(q, s, w, cs, kt)
    dw, db = jk.joint_bwd_dw_u8(h, q, s, cs, cl, labels, kt)
    torch.cuda.synchronize()
    assert (jk.joint_bwd_dh_u8.launches, jk.joint_bwd_dw_u8.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    _rel_close(smear, jk.joint_bwd_dh_u8_plain(q, s, w, cs, kt))
    for g, r in zip((dw, db), jk.joint_bwd_dw_u8_plain(h, q, s, cs, cl, labels, kt)):
        _rel_close(g, r)
    for g, r in zip((smear, dw, db), jk.joint_bwd_fused_u8(h, q, s, w, cs, cl, labels, kt)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K", JOINT_SHAPES)
def test_joint_fused_u_kernel_matches_plain(cuda, dtype, N, Hj, K):
    """K5-fused-u: K5-A and K5-B behind one call, bit for bit."""
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, dtype, cuda, seed=11)
    _, u = jk.joint_fwd_store_plain(h, wt, b)
    w = wt.t().contiguous()
    before = jk.joint_bwd_fused_u.launches
    got = jk.joint_bwd_fused_u(h, u, w, cs, cl, labels)
    torch.cuda.synchronize()
    assert jk.joint_bwd_fused_u.launches == before + 2
    for g, r in zip(got, jk.joint_bwd_fused_u_plain(h, u, w, cs, cl, labels)):
        _rel_close(g, r)
    for g, r in zip(got, (jk.joint_bwd_dh(u, w, cs), *jk.joint_bwd_dw(h, u, cs, cl, labels))):
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [300, 7000])
def test_joint_pass_b_adds_across_row_chunks(cuda, dtype, rows):
    """K5-B with ``out``: 20,000 rows in chunks that are no multiple of the
    256 rows the tensor-core partial sums are flushed at."""
    N, Hj, K = 20000, 128, 384
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, dtype, cuda, seed=12)
    _, u = jk.joint_fwd_store_plain(h, wt, b)
    out = (torch.zeros(Hj, K, device=cuda), torch.zeros(K, device=cuda))
    for lo in range(0, N, rows):
        sl = slice(lo, lo + rows)
        jk.joint_bwd_dw(h[sl], u[sl], cs[sl], cl[sl], labels[sl], out=out)
    for g, r in zip(out, jk.joint_bwd_dw_plain(h, u, cs, cl, labels)):
        _rel_close(g, r)


# ----------------------- pass B on Hopper (wgmma behind asynchronous staging)
def _labels_partly_outside(labels, K):
    """Every fifth label moved below 0 and every seventh to K or past it:
    those meet no column."""
    out = labels.clone()
    out[::5] = -1 - out[::5] % 3
    out[3::7] = K + out[3::7] % 5
    return out


# (N, Hj, K, how h is staged, how u is staged): N no multiple of the 64-row
# slice or of the 256 rows between flushes, Hj and K no multiple of the
# 128-wide tile; rows of 16-byte multiples take TMA, of 8 or 4 bytes
# cp.async, of an odd number of bf16 element copies
PASS_B_SHAPES = [
    (70, 32, 600, "TMA", "TMA"),
    (777, 96, 1004, "TMA", "cp.async, 8 bytes"),
    (1000, 200, 1002, "TMA", "cp.async, 4 bytes"),
    (301, 33, 1001, "element copies", "element copies"),
    (513, 36, 384, "cp.async, 8 bytes", "TMA"),
    (2049, 34, 8704, "cp.async, 4 bytes", "TMA"),
    (257, 256, 1152, "TMA", "TMA"),
]


@pytest.mark.parametrize("N,Hj,K,h_staging,u_staging", PASS_B_SHAPES)
def test_pass_b_kernel_crosses_every_tail(cuda, N, Hj, K, h_staging, u_staging):
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=16)
    labels = _labels_partly_outside(labels, K)
    _, u = jk.joint_fwd_store_plain(h, wt, b)
    plan = jk.pass_b_plan(h, u)
    assert (plan["h"], plan["u"]) == (h_staging, u_staging)
    assert plan["grid"] == (-(-Hj // 128), -(-K // 128))
    dw, db = jk.joint_bwd_dw(h, u, cs, cl, labels)
    torch.cuda.synchronize()
    ref_dw, ref_db = jk.joint_bwd_dw_plain(h, u, cs, cl, labels)
    _rel_close(dw, ref_dw)
    _rel_close(db, ref_db)


# the int8 slab's rows are K bytes: K = 600 and 1,000 take 8-byte cp.async,
# 1,004 4-byte, 1,001 element copies, 1,024 TMA
@pytest.mark.parametrize("K,staging", [(600, "cp.async, 8 bytes"), (1000, "cp.async, 8 bytes"),
                                       (1004, "cp.async, 4 bytes"), (1001, "element copies"),
                                       (1024, "TMA")])
def test_pass_b_int8_slab_takes_each_staging(cuda, K, staging):
    N, Hj, kt = 300, 96, 128
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=17)
    labels = _labels_partly_outside(labels, K)
    _, q, s = jk.joint_fwd_store8_plain(h, wt, b, kt)
    assert jk.pass_b_plan(h, q)["u"] == staging
    got = jk.joint_bwd_dw_u8(h, q, s, cs, cl, labels, kt)
    torch.cuda.synchronize()
    for g, r in zip(got, jk.joint_bwd_dw_u8_plain(h, q, s, cs, cl, labels, kt)):
        _rel_close(g, r)


@pytest.mark.parametrize("rows", [300, 4096])
def test_pass_b_in_row_chunks_equals_one_call(cuda, rows):
    """``out`` added to over row chunks against one call over all the rows
    (the flushes fall at other rows, so not bit for bit)."""
    N, Hj, K = 9000, 160, 700
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=18)
    _, u = jk.joint_fwd_store_plain(h, wt, b)
    out = (torch.zeros(Hj, K, device=cuda), torch.zeros(K, device=cuda))
    for lo in range(0, N, rows):
        sl = slice(lo, lo + rows)
        jk.joint_bwd_dw(h[sl], u[sl], cs[sl], cl[sl], labels[sl], out=out)
    for g, r in zip(out, jk.joint_bwd_dw(h, u, cs, cl, labels)):
        _rel_close(g, r)


def test_pass_b_is_deterministic(cuda):
    """Two calls on the same inputs are bit for bit equal (no atomics)."""
    N, Hj, K, kt = 3000, 256, 1536, 1024
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=19)
    _, u = jk.joint_fwd_store_plain(h, wt, b)
    _, q, s = jk.joint_fwd_store8_plain(h, wt, b, kt)
    for call in (lambda: jk.joint_bwd_dw(h, u, cs, cl, labels),
                 lambda: jk.joint_bwd_dw_u8(h, q, s, cs, cl, labels, kt)):
        first, second = call(), call()
        for g, r in zip(first, second):
            assert torch.equal(g, r)


def test_pass_b_over_a_long_contraction(cuda):
    """66,000 rows: the tensor cores' truncating fp32 sums must be flushed
    into round-to-nearest ones to stay within 1e-4 of the plain version."""
    N, Hj, K = 66000, 256, 1024
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=20)
    _, u = jk.joint_fwd_store_plain(h, wt, b)
    got = jk.joint_bwd_dw(h, u, cs, cl, labels)
    for g, r in zip(got, jk.joint_bwd_dw_plain(h, u, cs, cl, labels)):
        _rel_close(g, r)


# ------------------- pass A on Hopper (wgmma over K-major operands, by TMA)
def _at_offset(t, elems: int):
    """A contiguous copy of ``t`` whose base lies ``elems`` elements past the
    start of its allocation (allocations are 512-byte aligned): an offset of
    8, 4 or 2 bytes (or one bf16) takes the operand off TMA."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


def _pass_a_operands(N, Hj, K, device, seed):
    """The bf16 slab u [N, K], w [Hj, K] bf16 and cs [N]."""
    h, wt, b, _, cs, _ = _joint_inputs(N, Hj, K, torch.bfloat16, device, seed=seed)
    return h, wt, b, jk.joint_fwd_store_plain(h, wt, b)[1], wt.t().contiguous(), cs


# N no multiple of the 128-row tile, Hj none of the 256-wide tile (but 768
# and 1,024, base's and large's), K none of the 64-wide slice
@pytest.mark.parametrize("Hj", [200, 768, 1024])
@pytest.mark.parametrize("K", [600, 1000, 8704])
def test_pass_a_kernel_crosses_every_tail(cuda, Hj, K):
    N = 333
    _, _, _, u, w, cs = _pass_a_operands(N, Hj, K, cuda, seed=21)
    plan = jk.pass_a_plan(u, w)
    assert (plan["u"], plan["w"]) == ("TMA", "TMA")
    assert plan["grid"] == (-(-N // 128), -(-Hj // 256))
    before = jk.joint_bwd_dh.launches
    smear = jk.joint_bwd_dh(u, w, cs)
    torch.cuda.synchronize()
    assert jk.joint_bwd_dh.launches == before + 1
    _rel_close(smear, jk.joint_bwd_dh_plain(u, w, cs))


# (u's offset, w's offset, in bf16 elements; K; how u is staged, how w is):
# rows of 16-byte multiples on 16-byte bases take TMA, of 8 or 4 bytes
# cp.async, of an odd number of bf16 element copies
PASS_A_STAGING = [
    (0, 4, 1000, "TMA", "cp.async, 8 bytes"),
    (4, 0, 1000, "cp.async, 8 bytes", "TMA"),
    (2, 2, 1000, "cp.async, 4 bytes", "cp.async, 4 bytes"),
    (1, 0, 1000, "element copies", "TMA"),
    (0, 1, 600, "TMA", "element copies"),
    (0, 0, 1001, "element copies", "element copies"),
    (0, 0, 1002, "cp.async, 4 bytes", "cp.async, 4 bytes"),
    (0, 0, 1004, "cp.async, 8 bytes", "cp.async, 8 bytes"),
]


@pytest.mark.parametrize("u_off,w_off,K,u_staging,w_staging", PASS_A_STAGING)
def test_pass_a_kernel_takes_each_staging(cuda, u_off, w_off, K, u_staging, w_staging):
    N, Hj = 301, 520
    _, _, _, u, w, cs = _pass_a_operands(N, Hj, K, cuda, seed=22)
    u, w = _at_offset(u, u_off), _at_offset(w, w_off)
    plan = jk.pass_a_plan(u, w)
    assert (plan["u"], plan["w"]) == (u_staging, w_staging)
    smear = jk.joint_bwd_dh(u, w, cs)
    torch.cuda.synchronize()
    _rel_close(smear, jk.joint_bwd_dh_plain(u, w, cs))


# the int8 slab: scale tiles of 8 (eight in every slice), 40 (slices that
# straddle two) and 2,048 (ragged last tile); its rows are K bytes, so
# K = 1,000 takes 8-byte cp.async, 4,500 4-byte, 1,001 element copies,
# 1,024 and 4,608 TMA
@pytest.mark.parametrize("K,kt,staging", [
    (1000, 8, "cp.async, 8 bytes"), (1024, 8, "TMA"), (1000, 40, "cp.async, 8 bytes"),
    (1001, 40, "element copies"), (4500, 2048, "cp.async, 4 bytes"), (4608, 2048, "TMA"),
])
def test_pass_a_int8_slab_matches_plain(cuda, K, kt, staging):
    N, Hj = 300, 200
    h, wt, b, _, cs, _ = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=23)
    _, q, s = jk.joint_fwd_store8_plain(h, wt, b, kt)
    w = wt.t().contiguous()
    assert jk.pass_a_plan(q, w)["u"] == staging
    before = jk.joint_bwd_dh_u8.launches
    smear = jk.joint_bwd_dh_u8(q, s, w, cs, kt)
    torch.cuda.synchronize()
    assert jk.joint_bwd_dh_u8.launches == before + 1
    _rel_close(smear, jk.joint_bwd_dh_u8_plain(q, s, w, cs, kt))


# the fp32 workspace: the no-slab routes derive each row chunk into it and
# hand pass A the chunk's rows of smear and cs (smear + r0 Hj, cs + r0).
# Chunked and whole agree bit for bit (each row's sums are its own); against
# the plain versions 1e-3 of scale, as for those routes' other tests (u is
# rounded to bf16 from values that differ in their last fp32 bits). Hj = 201
# takes the scalar stores.
@pytest.mark.parametrize("Hj", [200, 201, 768])
def test_pass_a_over_the_fp32_workspace_in_row_chunks(cuda, monkeypatch, Hj):
    N, K = 1000, 1000
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=24)
    w = wt.t().contiguous()
    denom = jk.joint_fwd_plain(h, wt, b)[0].log()
    assert jk.pass_a_plan(torch.empty((N, K), device=cuda), w)["u"] == "TMA"
    whole = (jk.joint_bwd_dh_recompute(h, w, b, denom, cs),
             jk.joint_bwd_fused(h, w, b, cs, cl, labels)[0])
    monkeypatch.setattr(jk, "FUSED_WS_BYTES", 256 * K * 4)
    assert -(-N // jk.fused_workspace_rows(N, K)) == 4
    chunked = (jk.joint_bwd_dh_recompute(h, w, b, denom, cs),
               jk.joint_bwd_fused(h, w, b, cs, cl, labels)[0])
    torch.cuda.synchronize()
    for g, r in zip(chunked, whole):
        assert torch.equal(g, r)
    _rel_close(whole[0], jk.joint_bwd_dh_recompute_plain(h, w, b, denom, cs),
               RECOMPUTE_TOL[torch.bfloat16])
    _rel_close(whole[1], jk.joint_bwd_fused_plain(h, w, b, cs, cl, labels)[0],
               RECOMPUTE_TOL[torch.bfloat16])


def test_pass_a_is_deterministic(cuda):
    """Two calls on the same inputs are bit for bit equal (no atomics)."""
    N, Hj, K, kt = 3000, 768, 1536, 1024
    h, wt, b, u, w, cs = _pass_a_operands(N, Hj, K, cuda, seed=25)
    _, q, s = jk.joint_fwd_store8_plain(h, wt, b, kt)
    for call in (lambda: jk.joint_bwd_dh(u, w, cs), lambda: jk.joint_bwd_dh_u8(q, s, w, cs, kt)):
        assert torch.equal(call(), call())


@pytest.mark.parametrize("source", ["bf16 slab", "int8 slab"])
def test_pass_a_over_a_long_contraction(cuda, source):
    """K = 17,408 (large-196M's vocabulary, 1,088 k16 steps): the tensor
    cores' truncating fp32 sums, never flushed, stay within 1e-4 of the
    plain version's scale."""
    N, Hj, K, kt = 2000, 1024, 17408, 2048
    h, wt, b, u, w, cs = _pass_a_operands(N, Hj, K, cuda, seed=26)
    if source == "bf16 slab":
        got, want = jk.joint_bwd_dh(u, w, cs), jk.joint_bwd_dh_plain(u, w, cs)
    else:
        _, q, s = jk.joint_fwd_store8_plain(h, wt, b, kt)
        got, want = jk.joint_bwd_dh_u8(q, s, w, cs, kt), jk.joint_bwd_dh_u8_plain(q, s, w, cs, kt)
    _rel_close(got, want)


def test_pass_a_rejects_what_it_does_not_take(cuda):
    h, wt, b, u, w, cs = _pass_a_operands(300, 200, 600, cuda, seed=27)
    _, q, s = jk.joint_fwd_store8_plain(h, wt, b, 40)
    with pytest.raises(TypeError):
        jk.joint_bwd_dh(u.float(), w, cs)  # the slab is bf16
    with pytest.raises(TypeError):
        jk.joint_bwd_dh(u, w.half(), cs)
    with pytest.raises(ValueError):
        jk.joint_bwd_dh(u, w[:, :599].contiguous(), cs)
    with pytest.raises(ValueError):
        jk.joint_bwd_dh(u.t().contiguous().t(), w, cs)  # not contiguous
    with pytest.raises(ValueError):
        jk.joint_bwd_dh_u8(q, s, w, cs, 12)  # the scale tile is no multiple of 8
    with pytest.raises(RuntimeError):
        jk.pass_a_plan(u.double(), w)  # no source of u has 8-byte elements


# ------------------------------------- the backwards that derive per pass
RECOMPUTE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K", JOINT_SHAPES + [(513, 1024, 17408)])
@pytest.mark.parametrize("ws_rows", [None, 256], ids=["one-chunk", "chunks"])
def test_joint_derive_a_kernel_matches_plain(cuda, monkeypatch, dtype, N, Hj, K, ws_rows):
    """K6-derive-a: the bf16 tile and the smear. With fp32 inputs the smear
    comes through the fp32 workspace (``chunks``: 256 rows of it)."""
    if ws_rows is not None:
        monkeypatch.setattr(jk, "FUSED_WS_BYTES", ws_rows * K * 4)
    h, wt, b, _, cs, _ = _joint_inputs(N, Hj, K, dtype, cuda, seed=13)
    w = wt.t().contiguous()
    chunks = -(-N // jk.fused_workspace_rows(N, K)) if dtype == torch.float32 else 1
    before = jk.joint_derive_a.launches
    u, smear = jk.joint_derive_a(h, w, b, cs)
    torch.cuda.synchronize()
    assert jk.joint_derive_a.launches == before + 2 * chunks
    ref_u, ref_smear = jk.joint_derive_a_plain(h, w, b, cs)
    assert u.dtype == torch.bfloat16 and u.shape == (N, K)
    torch.testing.assert_close(u.float(), ref_u.float(), rtol=2 ** -7, atol=0)
    _rel_close(smear, ref_smear, RECOMPUTE_TOL[dtype])


# column ranges as (first column, columns left out at the end)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hj,K", JOINT_SHAPES + [(513, 1024, 17408)])
@pytest.mark.parametrize("lo,cut", [(0, 0), (128, 0), (0, 57), (200, 31)])
@pytest.mark.parametrize("ws_rows", [None, 256], ids=["one-chunk", "chunks"])
def test_joint_recompute_kernels_match_plain(cuda, monkeypatch, dtype, N, Hj, K, lo, cut,
                                             ws_rows):
    """K4-A and K4-B over the columns [lo, K - cut), the labels relative to
    ``lo`` (some negative, some past the range's end)."""
    hi = K - cut
    if ws_rows is not None:
        monkeypatch.setattr(jk, "FUSED_WS_BYTES", ws_rows * (hi - lo) * 4)
    h, wt, b, labels, c, cl = _joint_inputs(N, Hj, K, dtype, cuda, seed=14)
    w = wt.t().contiguous()
    denom = jk.joint_fwd_plain(h, wt, b)[0].log()
    rel = labels - lo
    chunks = -(-N // jk.fused_workspace_rows(N, hi - lo))
    before = (jk.joint_bwd_dh_recompute.launches, jk.joint_bwd_dw_recompute.launches)
    smear = jk.joint_bwd_dh_recompute(h, w, b, denom, c, lo, hi)
    dw, db = jk.joint_bwd_dw_recompute(h, w, b, denom, c, cl, rel, lo, hi)
    torch.cuda.synchronize()
    assert (jk.joint_bwd_dh_recompute.launches, jk.joint_bwd_dw_recompute.launches) == (
        before[0] + 2 * chunks, before[1] + 2 * chunks)
    assert dw.shape == (Hj, hi - lo) and db.shape == (hi - lo,)
    _rel_close(smear, jk.joint_bwd_dh_recompute_plain(h, w, b, denom, c, lo, hi),
               RECOMPUTE_TOL[dtype])
    for g, r in zip((dw, db),
                    jk.joint_bwd_dw_recompute_plain(h, w, b, denom, c, cl, rel, lo, hi)):
        _rel_close(g, r, RECOMPUTE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rechunked_backward_on_the_card_matches_plain(cuda, monkeypatch, dtype):
    """Three chunks of 512 rows (a budget of 1 MiB at N=1,100, K=600): the
    kernels against the plain versions on the whole rows at once."""
    monkeypatch.setattr(jk, "RECHUNK_LIMIT_BYTES", 1 << 20)
    N, Hj, K = 1100, 16, 600
    assert jk.rechunk_rows(N, Hj, K) == 512
    h, wt, b, labels, cs, cl = _joint_inputs(N, Hj, K, dtype, cuda, seed=15)
    w = wt.t().contiguous()
    before = (jk.joint_derive_a.launches, jk.joint_bwd_dw.launches)
    got = jk.joint_bwd_rechunked(h, w, b, cs, cl, labels)
    torch.cuda.synchronize()
    assert (jk.joint_derive_a.launches, jk.joint_bwd_dw.launches) == (before[0] + 6,
                                                                      before[1] + 3)
    u, smear = jk.joint_derive_a_plain(h, w, b, cs)
    for g, r in zip(got, (smear, *jk.joint_bwd_dw_plain(h, u, cs, cl, labels))):
        _rel_close(g, r, RECOMPUTE_TOL[dtype])


# route -> (policy attributes, the plan's backward, launches of (forward kernels, backward
# kernels) by wrapper, tolerance against dense autograd); N=70, K=600, or for
# the hybrid split K=2,560 with a budget of one 1,024-wide vocab tile
_EXACT, _LOSSY = dict(rtol=1e-3, atol=2e-3), dict(rtol=5e-2, atol=5e-2)
ROUTES = {
    "K5-fused-u": (dict(Z_STORE_LIMIT_BYTES=1 << 62, FUSED_BWD=True), "K5-fused-u",
                   dict(joint_fwd_store=1, joint_bwd_fused_u=2), _EXACT),
    "K7-fused-u8": (dict(Z_STORE_LIMIT_BYTES=1 << 62, _ZSTORE_DTYPE="i8", FUSED_BWD=True),
                    "K7-fused-u8", dict(joint_fwd_store8=1, joint_bwd_fused_u8=2), _LOSSY),
    "K7-A8 + K7-B8": (dict(Z_STORE_LIMIT_BYTES=1 << 62, _ZSTORE_DTYPE="i8", FUSED_BWD=False),
                      "K7-A8 + K7-B8",
                      dict(joint_fwd_store8=1, joint_bwd_dh_u8=1, joint_bwd_dw_u8=1), _LOSSY),
    "K6-fused": (dict(Z_STORE_LIMIT_BYTES=0, FUSED_BWD=True), "K6-fused",
                 dict(joint_fwd=1, joint_bwd_fused=3), _EXACT),
    "rechunked": (dict(Z_STORE_LIMIT_BYTES=0, FUSED_BWD=False), "K6-derive-a + K5-B",
                  dict(joint_fwd=1, joint_derive_a=2, joint_bwd_dw=1), _EXACT),
    "recompute": (dict(Z_STORE_LIMIT_BYTES=0, FUSED_BWD=False, RECHUNK_LIMIT_BYTES=0),
                  "K4-A + K4-B",
                  dict(joint_fwd=1, joint_bwd_dh_recompute=2, joint_bwd_dw_recompute=2), _EXACT),
    "hybrid": (dict(Z_STORE_LIMIT_BYTES=2 << 20, Z_STORE_PARTIAL=True),
               "K5-A + K5-B over [0, 1024) and K4-A + K4-B over [1024, 2560) (the hybrid split)",
               dict(joint_fwd_store=1, joint_fwd=1, joint_bwd_dh=1, joint_bwd_dw=1,
                    joint_bwd_dh_recompute=2, joint_bwd_dw_recompute=2), _EXACT),
}
COUNTED = ("joint_fwd", "joint_fwd_store", "joint_fwd_store8", "joint_bwd_dh", "joint_bwd_dw",
           "joint_bwd_dh_u8", "joint_bwd_dw_u8", "joint_bwd_fused_u", "joint_bwd_fused_u8",
           "joint_bwd_fused", "joint_derive_a", "joint_bwd_dh_recompute",
           "joint_bwd_dw_recompute")


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("blank", ["last", 100])
def test_fused_joint_lse_routes_on_the_card_match_a_dense_reference(cuda, monkeypatch, route,
                                                                    blank):
    """Every route the knobs reach, fp32: the kernels it launches, by the
    counters, and its values and gradients against dense autograd."""
    attrs, backward, launches, tol = ROUTES[route]
    for name, value in attrs.items():
        monkeypatch.setattr(jk, name, value)
    N, Hj, K = (70, 32, 600) if route != "hybrid" else (70, 16, 2560)
    blank = K - 1 if blank == "last" else blank
    assert jk.store_plan(N, Hj, K)["backward"] == backward
    h, wt, b, labels, _, _ = _joint_inputs(N, Hj, K, torch.float32, cuda, seed=5)
    w = wt.t().contiguous()
    rng = np.random.default_rng(6)
    cb, cl = (torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)).to(cuda)
              for _ in range(2))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (h, w, b)]
        lb, ll = fn(*leaves)
        loss = (lb * cb).sum() + (ll * cl).sum()
        return (lb, ll) + torch.autograd.grad(loss, leaves)

    def dense(h, w, b):
        z = h @ w + b
        d = torch.logsumexp(z, 1)
        return z[:, blank] - d, z.gather(1, labels.long()[:, None])[:, 0] - d

    before = {name: getattr(jk, name).launches for name in COUNTED}
    got = run(lambda h, w, b: jk.fused_joint_lse(h, w, b, labels, blank))
    added = {name: getattr(jk, name).launches - before[name] for name in COUNTED}
    assert {name: n for name, n in added.items() if n} == launches
    want = run(dense)
    for g, r in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    for g, r in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, r, **tol)


def test_new_joint_kernels_reject_what_they_do_not_take(cuda):
    h, wt, b, labels, cs, cl = _joint_inputs(16, 8, 40, torch.float32, cuda)
    w = wt.t().contiguous()
    with pytest.raises(ValueError):
        jk.joint_fwd_store8(h, wt, b, 100)  # the scale tile is not a multiple of 128
    _, q, s = jk.joint_fwd_store8(h, wt, b, 128)
    with pytest.raises(TypeError):
        jk.joint_bwd_fused_u8(h, q.float(), s, w, cs, cl, labels, 128)
    with pytest.raises(ValueError):
        jk.joint_bwd_fused_u8(h, q, s.t().contiguous(), w, cs, cl, labels, 128)
    with pytest.raises(TypeError):
        jk.joint_bwd_fused(h, w, b, cs, cl, labels.long())
    with pytest.raises(ValueError):
        jk.joint_bwd_fused(h, wt, b, cs, cl, labels)  # w must be [Hj, K]
    _, u = jk.joint_fwd_store(h, wt, b)
    with pytest.raises(ValueError):
        jk.joint_bwd_dh_u8(q, s, w, cs, 100)  # the scale tile is not a multiple of 8
    with pytest.raises(TypeError):
        jk.joint_bwd_dw_u8(h, q, s, cs, cl, labels.long(), 128)
    with pytest.raises(TypeError):
        jk.joint_bwd_fused_u(h, u.float(), w, cs, cl, labels)
    with pytest.raises(ValueError):
        jk.joint_derive_a(h, wt, b, cs)  # w must be [Hj, K]
    denom = jk.joint_fwd(h, wt, b)[0].log()
    with pytest.raises(ValueError, match="column range"):
        jk.joint_bwd_dh_recompute(h, w, b, denom, cs, 8, 41)
    with pytest.raises(TypeError):
        jk.joint_bwd_dw_recompute(h, w, b, denom, cs, cl, labels.long(), 8, 40)
    with pytest.raises(ValueError):  # dw to add into has another shape
        jk.joint_bwd_dw(h, u, cs, cl, labels, out=(torch.zeros(8, 39, device=cuda),
                                                   torch.zeros(40, device=cuda)))


# ---------------- the forward and the derivation on Hopper (one wgmma product)
def _check_forward(h, wt, b, kt):
    """K2, K5-store and K7-store8 on the same inputs: their sums equal bit for
    bit, each output against the plain versions at the tolerances above."""
    before = (jk.joint_fwd.launches, jk.joint_fwd_store.launches, jk.joint_fwd_store8.launches)
    sums, _ = jk.joint_fwd(h, wt, b)
    sums_u, u = jk.joint_fwd_store(h, wt, b)
    sums_q, q, s = jk.joint_fwd_store8(h, wt, b, kt)
    torch.cuda.synchronize()
    assert (jk.joint_fwd.launches, jk.joint_fwd_store.launches,
            jk.joint_fwd_store8.launches) == tuple(n + 1 for n in before)
    assert torch.equal(sums, sums_u) and torch.equal(sums, sums_q)
    ref_sums, ref_u = jk.joint_fwd_store_plain(h, wt, b)
    _, ref_q, ref_s = jk.joint_fwd_store8_plain(h, wt, b, kt)
    torch.testing.assert_close(sums, ref_sums, rtol=1e-5, atol=0)
    torch.testing.assert_close(u.float(), ref_u.float(), rtol=2 ** -7, atol=0)
    torch.testing.assert_close(s, ref_s, rtol=5e-5, atol=0)
    diff = (q.int() - ref_q.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() <= 1e-3
    assert q.max().item() == 127 and q.min().item() >= 0
    return sums, u, q, s


# (N, Hj, K, kt): Hj from 8 (one slice, mostly zeros past Hj) to large-196M's
# 1,024, 96 and 768 no multiple of the 64-wide slice; N no multiple of the
# 128-row tile; K none of the 256-column tile, or large-196M's 17,408
# (8.5 rounds of 2,048: half the cluster idle in the last); every scale tile
# the kernel takes
FWD_SHAPES = [(200, 8, 1000, 128), (333, 96, 2500, 1024), (129, 768, 8704, 1024),
              (300, 1024, 17408, 2048), (77, 96, 300, 2048), (260, 1024, 4000, 256),
              (140, 768, 4100, 512)]


@pytest.mark.parametrize("N,Hj,K,kt", FWD_SHAPES)
def test_forward_kernel_crosses_every_tail(cuda, N, Hj, K, kt):
    h, wt, b, *_ = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=31)
    plan = jk.fwd_plan(h, wt, kt)
    assert (plan["h"], plan["wt"]) == ("TMA", "TMA")
    assert plan["cluster"] == 8 and plan["grid"] == 8 * -(-N // 128)
    assert plan["rounds"] == -(-K // 2048) and plan["clusters_resident"] >= 1
    _check_forward(h, wt, b, kt)


# (h's offset, wt's offset, in bf16 elements; Hj; how h is staged, how wt
# is): rows of 16-byte multiples on 16-byte bases take TMA, of 8 or 4 bytes
# cp.async, of an odd number of bf16 element copies
FWD_STAGING = [
    (0, 4, 96, "TMA", "cp.async, 8 bytes"),
    (4, 0, 96, "cp.async, 8 bytes", "TMA"),
    (2, 2, 96, "cp.async, 4 bytes", "cp.async, 4 bytes"),
    (1, 0, 96, "element copies", "TMA"),
    (0, 1, 96, "TMA", "element copies"),
    (0, 0, 100, "cp.async, 8 bytes", "cp.async, 8 bytes"),
    (0, 0, 98, "cp.async, 4 bytes", "cp.async, 4 bytes"),
    (0, 0, 99, "element copies", "element copies"),
]


@pytest.mark.parametrize("h_off,w_off,Hj,h_staging,w_staging", FWD_STAGING)
def test_forward_kernel_takes_each_staging(cuda, h_off, w_off, Hj, h_staging, w_staging):
    N, K = 301, 1000
    h, wt, b, *_ = _joint_inputs(N, Hj, K, torch.bfloat16, cuda, seed=32)
    h, wt = _at_offset(h, h_off), _at_offset(wt, w_off)
    plan = jk.fwd_plan(h, wt, 128)
    assert (plan["h"], plan["wt"]) == (h_staging, w_staging)
    _check_forward(h, wt, b, 128)


# the slab's own alignment: an odd K takes the element stores of u and q
@pytest.mark.parametrize("K", [999, 1001])
def test_forward_kernel_stores_an_odd_width(cuda, K):
    h, wt, b, *_ = _joint_inputs(150, 96, K, torch.bfloat16, cuda, seed=33)
    _check_forward(h, wt, b, 1024)


def test_forward_kernel_is_deterministic(cuda):
    """Two calls of each mode on the same inputs are bit for bit equal."""
    h, wt, b, *_ = _joint_inputs(1000, 768, 4000, torch.bfloat16, cuda, seed=34)
    calls = (lambda: jk.joint_fwd(h, wt, b)[:1], lambda: jk.joint_fwd_store(h, wt, b),
             lambda: jk.joint_fwd_store8(h, wt, b, 1024))
    for call in calls:
        assert all(torch.equal(x, y) for x, y in zip(call(), call()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kt", [64, 100, 384, 640, 4096])
def test_forward_kernel_rejects_a_scale_tile_it_does_not_take(cuda, dtype, kt):
    """The scale tile is a multiple of 128 that divides 2,048, for both
    dtypes; the plain version takes any."""
    h, wt, b, *_ = _joint_inputs(100, 96, 1000, dtype, cuda, seed=35)
    before = jk.joint_fwd_store8.launches
    with pytest.raises(ValueError, match="scale tile"):
        jk.joint_fwd_store8(h, wt, b, kt)
    with pytest.raises(ValueError, match="scale tile"):
        jk.fwd_plan(h.bfloat16(), wt.bfloat16(), kt)
    assert jk.joint_fwd_store8.launches == before
    assert jk.joint_fwd_store8_plain(h, wt, b, kt)[2].shape == (-(-1000 // kt), 100)


# The derivation alone. fp32 v = exp(z + b - shift) inherits the absolute
# error of z (fp32 sums over Hj in another order, truncated by the tensor
# cores: up to ~1e-4 at |z| ~ 15) as a relative one: rtol 1e-3. The bf16 v
# one bf16 step (2^-7 relative), as the slab u above.
DERIVE_SHAPES = [(200, 8, 300), (333, 96, 1000), (129, 1024, 17408), (1000, 768, 8704)]


def _derive_operands(N, Hj, K, seed):
    h, wt, b, *_ = _joint_inputs(N, Hj, K, torch.bfloat16, "cuda", seed=seed)
    shift = jk.joint_fwd_plain(h, wt, b)[0].log()
    return h, wt, b, shift


def _check_derive(h, wt, b, shift, out32, out16):
    before = jk.joint_derive.launches
    v32, v16 = jk.joint_derive(h, wt, b, shift, out32, out16)
    torch.cuda.synchronize()
    assert jk.joint_derive.launches == before + 1
    r32, r16 = jk.joint_derive_plain(h, wt, b, shift, out32, out16)
    assert (v32 is None) == (not out32) and (v16 is None) == (not out16)
    if out32:
        torch.testing.assert_close(v32, r32, rtol=1e-3, atol=0)
    if out16:
        assert v16.dtype == torch.bfloat16
        torch.testing.assert_close(v16.float(), r16.float(), rtol=2 ** -7, atol=0)
    if out32 and out16:  # both from the same fp32 value
        assert torch.equal(v16, v32.to(torch.bfloat16))


@pytest.mark.parametrize("N,Hj,K", DERIVE_SHAPES)
@pytest.mark.parametrize("out", ["fp32", "bf16", "both"])
@pytest.mark.parametrize("shifted", [False, True])
def test_derive_kernel_crosses_every_tail(cuda, N, Hj, K, out, shifted):
    """fp32 only (K6-fused, K4), bf16 only (K6-derive-a with bf16 weights),
    both (the fp32 derive_a's outputs, here through the bf16 kernel), with
    the row's log-sum-exp as the shift (K4) or none (K6)."""
    h, wt, b, shift = _derive_operands(N, Hj, K, seed=36)
    plan = jk.derive_plan(h, wt)
    assert (plan["h"], plan["wt"]) == ("TMA", "TMA")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles = -(-N // 128) * -(-K // 256)
    assert plan["tiles"] == (-(-N // 128), -(-K // 256)) and plan["blocks"] == min(tiles, sms)
    _check_derive(h, wt, b, shift if shifted else None, out != "bf16", out != "fp32")


@pytest.mark.parametrize("h_off,w_off,Hj,h_staging,w_staging", FWD_STAGING)
def test_derive_kernel_takes_each_staging(cuda, h_off, w_off, Hj, h_staging, w_staging):
    h, wt, b, shift = _derive_operands(301, Hj, 1000, seed=37)
    h, wt = _at_offset(h, h_off), _at_offset(wt, w_off)
    plan = jk.derive_plan(h, wt)
    assert (plan["h"], plan["wt"]) == (h_staging, w_staging)
    _check_derive(h, wt, b, shift, True, True)


@pytest.mark.parametrize("K", [999, 1001])
def test_derive_kernel_stores_an_odd_width(cuda, K):
    h, wt, b, shift = _derive_operands(150, 96, K, seed=38)
    _check_derive(h, wt, b, shift, True, True)


def test_derive_kernel_is_deterministic(cuda):
    """Two calls on the same inputs are bit for bit equal, on a grid of more
    tiles than blocks (each block walks several)."""
    h, wt, b, shift = _derive_operands(3000, 768, 8704, seed=39)
    assert jk.derive_plan(h, wt)["waves"] > 1
    one, two = (jk.joint_derive(h, wt, b, shift, True, True) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(one, two))


def test_derive_kernel_rejects_what_it_does_not_take(cuda):
    h, wt, b, shift = _derive_operands(100, 96, 600, seed=40)
    with pytest.raises(ValueError, match="output"):
        jk.joint_derive(h, wt, b, shift, False, False)
    with pytest.raises(ValueError):
        jk.joint_derive(h, wt, b, shift[:99])
    with pytest.raises(TypeError):
        jk.joint_derive(h, wt.float(), b)


# ------------------------------------------------------------ the wavefront
def _wf_inputs(G, T, B, H, dtype, device, with_masks, seed=10):
    rng = np.random.default_rng(seed)
    mk = lambda *shape, s=1.0, dt=dtype: torch.from_numpy(
        (rng.normal(size=shape) * s).astype(np.float32)).to(device, dt)
    masks = (torch.from_numpy(np.where(rng.random((G - 1, T, B, H)) < 0.8, 1.25, 0.0)
                              .astype(np.float32)).to(device, dtype) if with_masks else None)
    return (mk(T, B, 4 * H, s=0.5), mk(max(G - 1, 1), 4 * H, s=0.1, dt=torch.float32),
            mk(4 * H, H, s=1 / np.sqrt(3 * H)), mk(G - 1, 4 * H, 2 * H, s=1 / np.sqrt(6 * H)),
            mk(G, B, H, s=0.1), mk(G, B, H, s=0.1), masks)


# aligned; unaligned B and H (H only a multiple of 8); wide, with B past one batch tile;
# B=96, more batch rows than a group of 64
WF_SHAPES = [(6, 8, 32), (11, 5, 136), (3, 33, 1024), (4, 96, 136)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("T,B,H", WF_SHAPES)
def test_wavefront_kernels_match_plain(cuda, dtype, hard, G, with_masks, T, B, H):
    """K8-fwd without and with stored gates, then K8-bwd on those gates."""
    args = _wf_inputs(G, T, B, H, dtype, cuda, with_masks)
    before = (wk.lstm_wavefront.launches, wk.lstm_wavefront_sg.launches,
              wk.lstm_wavefront_bwd.launches)
    ys, cs = wk.lstm_wavefront(*args, hard)
    sg = wk.lstm_wavefront_sg(*args, hard)
    torch.cuda.synchronize()
    want = wk.lstm_wavefront_plain(*args, hard, True)
    for g, w in zip(sg, want):  # the pre-activations to an ulp of their own scale
        assert g.dtype == dtype
        _close(g, w, LSTM_TOL[dtype] * max(1.0, w.float().abs().max().item()))
    assert torch.equal(ys, sg[0]) and torch.equal(cs, sg[1])  # K8-fwd's outputs are K8-sg's

    gx, biases, w0, w_cats, h0, c0, masks = args
    gs, cs = want[2], want[1]
    c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    rng = np.random.default_rng(11)
    dys = torch.from_numpy(rng.normal(size=(G, T, B, H)).astype(np.float32)).to(cuda, dtype)
    dcs = torch.from_numpy((rng.normal(size=(G, T, B, H)) * 0.3).astype(np.float32)).to(
        cuda, dtype)
    w_hh = torch.cat([w0[None], w_cats[:, :, H:]])
    w_ih = w_cats[:, :, :H].contiguous()
    bwd_args = (gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard)
    got = wk.lstm_wavefront_bwd(*bwd_args)
    torch.cuda.synchronize()
    # one cooperative launch per call, every superstep inside it
    assert (wk.lstm_wavefront.launches, wk.lstm_wavefront_sg.launches,
            wk.lstm_wavefront_bwd.launches) == (before[0] + 1, before[1] + 1, before[2] + 1)
    ref = wk.lstm_wavefront_bwd_plain(*bwd_args)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    scale = max(1.0, ref[0].float().abs().max().item())
    for g, w in zip(got, ref):
        _close(g, w, LSTM_TOL[dtype] * scale)


@pytest.mark.parametrize("store_gates", [True, False])
def test_wavefront_on_the_card_matches_the_cpu(cuda, store_gates):
    """``WavefrontLSTM`` (K8-fwd, K8-bwd) fp32 with dropout masks: outputs
    and every gradient on the card against the CPU (the plain versions)."""
    G, T, B, H, I0 = 3, 9, 6, 40, 24
    rng = np.random.default_rng(12)
    mk = lambda *shape, s=1.0: torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))
    layers = [{"w_ih": mk(4 * H, I0 if l == 0 else H, s=0.15), "w_hh": mk(4 * H, H, s=0.15),
               "b_ih": mk(4 * H, s=0.1), "b_hh": mk(4 * H, s=0.1)} for l in range(G)]
    x, h0, c0, wy = mk(T, B, I0), mk(G, B, H, s=0.1), mk(G, B, H, s=0.1), mk(G, T, B, H)
    masks = torch.from_numpy(np.where(rng.random((G - 1, T, B, H)) < 0.7, 1 / 0.7, 0.0)
                             .astype(np.float32))

    def run(device):
        ls = [{k: v.to(device).requires_grad_() for k, v in p.items()} for p in layers]
        xd = x.to(device).requires_grad_()
        ys, cs = WavefrontLSTM.apply(*stack_operands(ls, xd, h0.to(device), c0.to(device)),
                                     masks.to(device), False, store_gates)
        loss = (ys * wy.to(device)).sum() + 0.3 * (cs ** 2).sum()
        leaves = [v for p in ls for v in p.values()] + [xd]
        return [ys.detach(), cs.detach()] + list(torch.autograd.grad(loss, leaves))

    for g, w in zip(run(cuda), run("cpu")):
        _close(g.cpu(), w, 1e-4 * max(1.0, w.abs().max().item()))


def test_wavefront_kernels_reject_what_they_do_not_take(cuda):
    args = _wf_inputs(3, 4, 2, 32, torch.float32, cuda, True)
    gx, biases, w0, w_cats, h0, c0, masks = args
    with pytest.raises(TypeError):
        wk.lstm_wavefront(*(a.half() if a is not biases else a for a in args))
    with pytest.raises(ValueError):  # w_cats not contiguous
        wk.lstm_wavefront(gx, biases, w0, w_cats.transpose(1, 2).contiguous().transpose(1, 2),
                          h0, c0, masks)
    with pytest.raises(ValueError):
        wk.lstm_wavefront(gx, biases, w0, w_cats, h0.cpu(), c0, masks)
    with pytest.raises(ValueError):  # masks for another G
        wk.lstm_wavefront(gx, biases, w0, w_cats, h0, c0, masks[:1])
    with pytest.raises(TypeError):  # the biases are fp32
        wk.lstm_wavefront(gx, biases.bfloat16(), w0, w_cats, h0, c0, masks)
    with pytest.raises(ValueError):  # H not a multiple of 8
        wk.lstm_wavefront(*_wf_inputs(2, 4, 2, 12, torch.float32, cuda, False))
    with pytest.raises(ValueError):  # 2,048 batch rows: more fp32 tiles than a block has threads
        wk.lstm_wavefront(*_wf_inputs(2, 1, 2048, 32, torch.float32, cuda, False))
    ys, cs, gs = wk.lstm_wavefront_sg(*args)
    c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    w_hh = torch.cat([w0[None], w_cats[:, :, 32:]])
    w_ih = w_cats[:, :, :32]
    with pytest.raises(ValueError):  # w_ih not contiguous
        wk.lstm_wavefront_bwd(gs, cs, c_prev, ys, cs, masks, w_hh, w_ih)
    with pytest.raises(ValueError):  # w_hh for another G
        wk.lstm_wavefront_bwd(gs, cs, c_prev, ys, cs, masks, w_hh[:2], w_ih.contiguous())
    with pytest.raises(TypeError):
        wk.lstm_wavefront_bwd(gs, cs, c_prev, ys, cs.bfloat16(), masks, w_hh, w_ih.contiguous())


def test_the_wavefront_benchmark_runs_on_the_card(cuda):
    from caiman_asr_tpu_torch import bench_wavefront

    r = bench_wavefront.ab(2, 64, 48, 5, 7, reps=1)
    assert r["fwd_max_abs_diff"] <= 2e-2 and r["grad_max_rel_diff"] <= 2e-2
    assert all(r[k] > 0 for k in ("fwd_perlayer_ms", "fwd_wavefront_ms", "fb_perlayer_ms",
                                  "fb_wavefront_ms"))


def _wf_bwd_args(args, hard, seed=11):
    """K8-bwd's operands for K8-fwd's ``args``: the plain forward's gates and
    states, random cotangents from ``seed``."""
    gx, biases, w0, w_cats, h0, c0, masks = args
    G, B, H = h0.shape
    T = gx.shape[0]
    dtype = gx.dtype
    _, cs, gs = wk.lstm_wavefront_plain(*args, hard, True)
    c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    rng = np.random.default_rng(seed)
    dys = torch.from_numpy(rng.normal(size=(G, T, B, H)).astype(np.float32)).to(gx.device, dtype)
    dcs = torch.from_numpy((rng.normal(size=(G, T, B, H)) * 0.3).astype(np.float32)).to(
        gx.device, dtype)
    w_hh = torch.cat([w0[None], w_cats[:, :, H:]])
    w_ih = w_cats[:, :, :H].contiguous()
    return (gs, cs, c_prev, dys, dcs, masks, w_hh, w_ih, hard)


# full width, few steps: base-85M's and large-196M's post-stacks (G=6), whose
# weights do not all fit the SMs' shared memory, so most rows stream
WF_WIDE = [(3, 16, 1024), (2, 32, 1536)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("T,B,H", WF_WIDE)
def test_wavefront_partly_resident_at_full_width(cuda, dtype, hard, with_masks, T, B, H):
    """K8-fwd, K8-bwd at G=6 and full width: the plan keeps only part of
    each block's rows resident in both directions; every output against
    the plain versions, one launch a call."""
    G = 6
    for backward in (False, True):  # most rows stream (bf16 keeps some resident)
        plan = wk.wavefront_plan(G, B, H, dtype, backward)
        assert plan["streamed_bytes_per_superstep"] > plan["weight_bytes"] // 2
        assert plan["resident_bytes"] > 0 or dtype == torch.float32
    args = _wf_inputs(G, T, B, H, dtype, cuda, with_masks, seed=20)
    before = wk.lstm_wavefront_sg.launches, wk.lstm_wavefront_bwd.launches
    got = wk.lstm_wavefront_sg(*args, hard)
    torch.cuda.synchronize()
    want = wk.lstm_wavefront_plain(*args, hard, True)
    for g, w in zip(got, want):
        _close(g, w, LSTM_TOL[dtype] * max(1.0, w.float().abs().max().item()))
    bwd_args = _wf_bwd_args(args, hard)
    got = wk.lstm_wavefront_bwd(*bwd_args)
    torch.cuda.synchronize()
    ref = wk.lstm_wavefront_bwd_plain(*bwd_args)
    scale = max(1.0, ref[0].float().abs().max().item())
    for g, w in zip(got, ref):
        _close(g, w, LSTM_TOL[dtype] * scale)
    assert (wk.lstm_wavefront_sg.launches, wk.lstm_wavefront_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wavefront_kernels_are_deterministic_and_leave_inputs_unwritten(cuda, dtype):
    """Two calls on the same inputs are bit for bit equal (the sums meet in a
    fixed order, no atomics), and no input, c0 included, is written."""
    args = _wf_inputs(6, 4, 16, 1024, dtype, cuda, True, seed=21)
    bwd_args = _wf_bwd_args(args, False)
    copies = [a.clone() for a in args + bwd_args[:-1] if a is not None]
    runs = [(wk.lstm_wavefront(*args), wk.lstm_wavefront_sg(*args),
             wk.lstm_wavefront_bwd(*bwd_args)) for _ in range(2)]
    torch.cuda.synchronize()
    for one, two in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(one, two))
    assert all(torch.equal(a, c) for a, c in
               zip([a for a in args + bwd_args[:-1] if a is not None], copies))


def test_wavefront_kernels_reject_a_plan_that_does_not_fit(cuda):
    """The kernels recompute the plan's layout and refuse one that does not
    fit the shape (ValueError), and agree with the host on its bytes."""
    args = _wf_inputs(3, 4, 8, 256, torch.bfloat16, cuda, False, seed=22)
    H, B = 256, 8
    for backward in (False, True):
        plan = wk.wavefront_plan(3, B, H, torch.bfloat16, backward)
        for i, ty in enumerate(plan["types"]):
            vals = (ctypes.c_int * len(wk.TYPE_KEYS))(*(ty[k] for k in wk.TYPE_KEYS))
            assert wk._fwd_lib().lstm_wavefront_smem_bytes(vals, i, H, B, 2, int(backward)) == \
                wk.type_smem_bytes(ty, *wk._shape(i, ty["units"], H, backward), B, 2)
    plan = wk.wavefront_plan(3, B, H, torch.bfloat16)
    bad = [dict(plan, smem_bytes=plan["smem_bytes"] - 16),  # not the layout's bytes
           dict(plan, types=[dict(plan["types"][0], units=plan["types"][0]["units"] - 1),
                             plan["types"][1]]),  # the blocks miss a unit
           dict(plan, types=[plan["types"][0], dict(plan["types"][1], kc=48)])]  # not k blocks
    for p in bad:
        with pytest.raises(ValueError, match="refused"):
            wk._launch_fwd(*args, False, False, plan=p)
    bplan = wk.wavefront_plan(3, B, H, torch.bfloat16, True)
    bwd_args = _wf_bwd_args(args, False)
    with pytest.raises(ValueError, match="refused"):
        wk._launch_bwd(*bwd_args, plan=dict(bplan, types=[
            bplan["types"][0], dict(bplan["types"][1], pairs=wk.MAX_PAIRS + 1)]))


# ------------------------------------------------------------- the LAMB finish
FINISH_SIZES = (1, 3, 4097, 2 ** 20 + 5)


def _finish_inputs(device, nonfinite, seed=30):
    """Leaves of FINISH_SIZES elements (parameters, EMA, moments), their
    gradients (leaf 1 none; NaN and inf entries where asked) and an
    overwrite source for leaf 0."""
    rng = np.random.default_rng(seed)
    mk = lambda n, s=1.0: torch.from_numpy((rng.normal(size=n) * s).astype(np.float32)).to(device)
    leaves = fk.Leaves(p=tuple(mk(n) for n in FINISH_SIZES), e=tuple(mk(n) for n in FINISH_SIZES),
                       m=tuple(mk(n, 0.1) for n in FINISH_SIZES),
                       v=tuple(mk(n, 0.01).abs() for n in FINISH_SIZES),
                       factor=(1.0, 2.0, 0.5, 0.243), sharded=(False,) * len(FINISH_SIZES))
    grads = [mk(n) for n in FINISH_SIZES]
    grads[1] = None
    if nonfinite:
        grads[2][5], grads[2][4096], grads[3][-1] = float("nan"), float("inf"), -float("inf")
    return leaves, grads, [mk(1), None, None, None]


def _clone_leaves(leaves):
    return fk.Leaves(*(tuple(t.clone() for t in ts) for ts in (leaves.p, leaves.e, leaves.m,
                                                             leaves.v)),
                     leaves.factor, leaves.sharded)


FINISH_CONSTS = dict(beta1=0.9, beta2=0.999, bc1=float(1 - np.float32(0.9) ** 3),
                     bc2=float(1 - np.float32(0.999) ** 3), eps=1e-9, weight_decay=1e-2)


@pytest.mark.parametrize("clip_norm", [1.0, None])
@pytest.mark.parametrize("nonfinite", [False, True])
def test_lamb_finish_kernels_match_plain(cuda, clip_norm, nonfinite):
    leaves, grads, sources = _finish_inputs(cuda, nonfinite)
    got, want = _clone_leaves(leaves), _clone_leaves(leaves)
    c = fk.Consts(clip_norm=clip_norm, **FINISH_CONSTS)
    before = [fk.lamb_finish_norms.launches, fk.lamb_finish_moments.launches,
              fk.lamb_finish_apply.launches]
    sq, grad_sq = fk.lamb_finish_norms(got, grads)
    sq_w, grad_sq_w = fk.lamb_finish_norms_plain(want, grads)
    torch.testing.assert_close(sq, sq_w, rtol=1e-6, atol=0)
    torch.testing.assert_close(grad_sq, grad_sq_w, rtol=1e-6, atol=0)
    assert sq[1] == 0  # no gradient
    norm = torch.sqrt(grad_sq_w)
    pu = fk.lamb_finish_moments(got, grads, norm, c)
    pu_w = fk.lamb_finish_moments_plain(want, grads, norm, c)
    for a, b in zip(got.m + got.v, want.m + want.v):
        assert torch.equal(a, b)
    torch.testing.assert_close(pu, pu_w, rtol=1e-6, atol=0)
    fk.lamb_finish_apply(got, pu_w, c, 4e-3, 0.999, sources)
    fk.lamb_finish_apply_plain(want, pu_w, c, 4e-3, 0.999, sources)
    for a, b in zip(got.p + got.e, want.p + want.e):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
    assert torch.equal(got.p[0], sources[0])  # the overwrite leaf
    assert [fk.lamb_finish_norms.launches, fk.lamb_finish_moments.launches,
            fk.lamb_finish_apply.launches] == [n + 1 for n in before]


def _norms_leaves(sizes, device, seed, offset=0, none=(), nonfinite=False):
    """Leaves of ``sizes`` elements and their gradients (None at ``none``),
    each gradient a contiguous view ``offset`` elements into one flat
    buffer past the one before it (offset 0: a tensor of its own)."""
    rng = np.random.default_rng(seed)
    zeros = lambda n: torch.zeros(n, device=device)
    leaves = fk.Leaves(*(tuple(zeros(n) for n in sizes) for _ in range(4)),
                       factor=(1.0,) * len(sizes), sharded=(False,) * len(sizes))
    vals = [torch.from_numpy(rng.normal(size=n).astype(np.float32)) for n in sizes]
    if nonfinite:
        big = max(range(len(sizes)), key=lambda i: sizes[i])
        vals[big][[3, sizes[big] // 2, -1]] = torch.tensor([float("nan"), float("inf"),
                                                            -float("inf")])
    if offset:
        flat = torch.zeros(sum(sizes) + offset * len(sizes) + 1, device=device)
        grads, at = [], offset
        for v in vals:
            grads.append(flat[at:at + v.numel()])
            grads[-1].copy_(v.to(device))
            at += v.numel() + offset
    else:
        grads = [v.to(device) for v in vals]
    return leaves, [None if i in none else g for i, g in enumerate(grads)]


def _runs(sizes, blocks):
    """Pass 0's runs of chunks: (first, past the last) for each block."""
    chunks = sum(-(-n // fk.CHUNK) for n in sizes)
    blocks = min(blocks, chunks)
    return [(chunks * b // blocks, chunks * (b + 1) // blocks) for b in range(blocks)]


NORMS_CASES = {
    # a leaf over many runs, and leaves on both sides of run boundaries
    "leaves_cross_runs": ([5, 3 * fk.CHUNK * 264 + 3, fk.CHUNK, 1, 2 ** 20 + 5], {}),
    # 2,000 leaves of 1-7 elements (their table past 48 KB of shared memory)
    # and one of a chunk and one element: several tiny leaves a run
    "many_tiny_leaves": ([1 + i % 7 for i in range(2000)] + [fk.CHUNK + 1], {}),
    # leaves without elements or without a gradient
    "empty_and_none": ([0, fk.CHUNK + 1, 0, 3, fk.CHUNK, 0], dict(none=(3,))),
    # gradients at 4-byte offsets, as the all-reduce's flat buffer hands them
    "offset_views": ([1, 3, fk.CHUNK + 1, 2 ** 20 + 5, 7 * fk.CHUNK - 1], dict(offset=1)),
    "offset_views_3": ([2, fk.CHUNK + 2, 5 * fk.CHUNK + 7, 1], dict(offset=3, none=(3,))),
    "nan_and_inf": ([fk.CHUNK + 1, 3 * fk.CHUNK + 2], dict(nonfinite=True, offset=2)),
}


@pytest.mark.parametrize("case", sorted(NORMS_CASES))
def test_lamb_finish_norms_matches_plain_at_awkward_layouts(cuda, case):
    """Pass 0's persistent grid: each leaf's sum and the total against the
    plain version, and two launches equal to the bit."""
    sizes, kw = NORMS_CASES[case]
    leaves, grads = _norms_leaves(sizes, cuda, seed=40, **kw)
    blocks = fk._lib().lamb_finish_norms_grid(len(sizes))
    assert blocks > 0
    runs = _runs(sizes, blocks)
    if case == "leaves_cross_runs":
        first = np.cumsum([0] + [-(-n // fk.CHUNK) for n in sizes])
        cut = [i for i in range(len(sizes)) if any(first[i] < lo < first[i + 1]
                                                   for lo, _ in runs)]
        assert 1 in cut and len(cut) >= 2, cut
    if case == "many_tiny_leaves":
        first = np.cumsum([0] + [-(-n // fk.CHUNK) for n in sizes])
        assert max(sum(lo <= f < hi for f in first[:-1]) for lo, hi in runs) >= 4
    if "offset" in kw:
        assert any(g is not None and g.data_ptr() % 16 for g in grads)
    before = fk.lamb_finish_norms.launches
    sq, grad_sq = fk.lamb_finish_norms(leaves, grads)
    sq2, grad_sq2 = fk.lamb_finish_norms(leaves, list(grads))
    assert fk.lamb_finish_norms.launches == before + 2
    want_sq, want_grad_sq = fk.lamb_finish_norms_plain(leaves, grads)
    torch.testing.assert_close(sq, want_sq, rtol=1e-6, atol=0)
    torch.testing.assert_close(grad_sq, want_grad_sq, rtol=1e-6, atol=0)
    assert torch.equal(sq, sq2) and torch.equal(grad_sq, grad_sq2)
    for i, n in enumerate(sizes):
        if n == 0 or grads[i] is None:
            assert sq[i] == 0
    if kw.get("nonfinite"):
        assert torch.isinf(grad_sq)


def test_lamb_finish_refuses_more_leaves_than_its_parameter_holds(cuda):
    """The pointers a call takes are one kernel parameter of at most
    MAX_LEAVES entries (the library agrees); one leaf more raises."""
    assert fk._lib().lamb_finish_max_leaves() == fk.MAX_LEAVES
    sizes = [1] * (fk.MAX_LEAVES + 1)
    leaves, grads = _norms_leaves(sizes, cuda, seed=41)
    with pytest.raises(ValueError, match="at most"):
        fk.lamb_finish_norms(leaves, grads)


def test_lamb_finish_kernels_are_deterministic(cuda):
    runs = []
    for _ in range(2):
        leaves, grads, sources = _finish_inputs(cuda, False, seed=31)
        c = fk.Consts(clip_norm=1.0, **FINISH_CONSTS)
        sq, grad_sq = fk.lamb_finish_norms(leaves, grads)
        pu = fk.lamb_finish_moments(leaves, grads, torch.sqrt(grad_sq), c)
        fk.lamb_finish_apply(leaves, pu, c, 4e-3, 0.999, sources)
        runs.append([sq, grad_sq, pu, *leaves.p, *leaves.e, *leaves.m, *leaves.v])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_lamb_finish_kernels_reject_what_they_do_not_take(cuda):
    leaves, grads, _ = _finish_inputs(cuda, False, seed=32)
    with pytest.raises(TypeError, match="float32"):
        fk.lamb_finish_norms(leaves, [None if g is None else g.bfloat16() for g in grads])
    with pytest.raises(ValueError, match="elements"):
        fk.lamb_finish_norms(leaves, [grads[0], None, grads[2][:-1], grads[3]])
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(FINISH_SIZES[2], 2, device=cuda)[:, 0]
        fk.lamb_finish_norms(leaves, [grads[0], None, wide, grads[3]])
    half = fk.Leaves(tuple(t.half() for t in leaves.p), leaves.e, leaves.m, leaves.v,
                     leaves.factor, leaves.sharded)
    with pytest.raises(TypeError, match="float32"):
        fk.lamb_finish_norms(half, grads)


def test_lamb_update_on_the_card_takes_the_kernels(cuda, monkeypatch):
    """Lamb.update on CUDA tensors launches each pass once and never its
    plain version, and agrees with the same update on the CPU."""
    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig

    rng = np.random.default_rng(33)
    tree = lambda s=1.0: {"encoder": {"w": torch.from_numpy(
        (rng.normal(size=(64, 130)) * s).astype(np.float32))}, "joint_fc": {
        "b": torch.from_numpy((rng.normal(size=4099) * s).astype(np.float32))}}
    params, grads = tree(), tree()
    grads["joint_fc"]["b"][7] = float("nan")
    opt = Lamb(OptimizerConfig(warmup_steps=0), {"encoder": 2.0})
    runs = {}
    for dev in ("cpu", cuda):
        p = {k: {n: t.to(dev).clone() for n, t in d.items()} for k, d in params.items()}
        e = {k: {n: t.clone() for n, t in d.items()} for k, d in p.items()}
        g = {(k, n): t.to(dev) for k, d in grads.items() for n, t in d.items()}
        state = opt.init(p)
        if dev != "cpu":
            for name in ("lamb_finish_norms_plain", "lamb_finish_moments_plain",
                         "lamb_finish_apply_plain"):
                monkeypatch.setattr(fk, name, None)
            before = fk.lamb_finish_apply.launches
        for _ in range(2):
            state, norm = opt.update(p, e, state, g, True, 0.999)
        runs[str(dev)] = (p, e, state, norm)
    assert fk.lamb_finish_apply.launches == before + 2
    (p0, e0, s0, n0), (p1, e1, s1, n1) = runs["cpu"], runs[str(cuda)]
    torch.testing.assert_close(n1.cpu(), n0, rtol=1e-6, atol=0)
    for k in params:
        for n in params[k]:
            for a, b in ((p1, p0), (e1, e0), (s1.mu, s0.mu), (s1.nu, s0.nu)):
                torch.testing.assert_close(a[k][n].cpu(), b[k][n], rtol=1e-5, atol=1e-6)
