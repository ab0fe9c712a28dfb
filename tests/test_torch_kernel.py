"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card: the LSTM recurrence forward (K1), its store-gates variant (K3a)
and backward (K3b) (``caiman_asr_tpu_torch/ops/csrc/lstm_recurrence*.cu``),
the joint's forward (K2, K5-store, K7-store8), its stored-slab backward
passes (K5-A, K5-B) and its one-call backwards over the int8 slab
(K7-fused-u8) and with no slab (K6-fused) (``csrc/joint_fwd.cu``,
``csrc/joint_bwd.cu``, ``csrc/joint_bwd_fused.cu``).

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
other way moves one term by 2^-8.
"""

import numpy as np
import pytest
import torch

from caiman_asr_tpu_torch.ops import joint_kernel as jk
from caiman_asr_tpu_torch.ops import lstm_kernel

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
    assert lstm_kernel.lstm_recurrence.launches == before + T
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
    assert lstm_kernel.lstm_recurrence_sg.launches == before + T
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
    assert lstm_kernel.lstm_recurrence_bwd.launches == before + T + 1
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


# route -> (Z_STORE_LIMIT_BYTES, _ZSTORE_DTYPE, FUSED_BWD, tolerance against dense autograd)
ROUTES = {"K7-fused-u8": (1 << 62, "i8", True, dict(rtol=5e-2, atol=5e-2)),
          "K6-fused": (0, "auto", True, dict(rtol=1e-3, atol=2e-3))}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("blank", [599, 100])
def test_fused_joint_lse_routes_on_the_card_match_a_dense_reference(cuda, monkeypatch, route,
                                                                    blank):
    limit, dtype, fused, tol = ROUTES[route]
    monkeypatch.setattr(jk, "Z_STORE_LIMIT_BYTES", limit)
    monkeypatch.setattr(jk, "_ZSTORE_DTYPE", dtype)
    monkeypatch.setattr(jk, "FUSED_BWD", fused)
    N, Hj, K = 70, 32, 600
    assert jk.store_plan(N, Hj, K)["backward"] == route
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

    before = (jk.joint_fwd_store8.launches, jk.joint_bwd_fused_u8.launches,
              jk.joint_fwd.launches, jk.joint_bwd_fused.launches)
    got = run(lambda h, w, b: jk.fused_joint_lse(h, w, b, labels, blank))
    after = (jk.joint_fwd_store8.launches, jk.joint_bwd_fused_u8.launches,
             jk.joint_fwd.launches, jk.joint_bwd_fused.launches)
    added = tuple(a - b for a, b in zip(after, before))
    assert added == ((1, 2, 0, 0) if route == "K7-fused-u8" else (0, 0, 1, 3))
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
