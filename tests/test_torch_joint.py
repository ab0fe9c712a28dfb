"""The port's fused joint + log-sum-exp (``caiman_asr_tpu_torch/ops/
joint_kernel.py``, the plain versions of its kernels on the CPU) against the
JAX package's ``fused_joint_lse`` in interpret mode, on each route that is
ported: the bf16 slab (K5-store, K5-A, K5-B), the int8 slab (K7-store8,
K7-fused-u8) and no slab (K2, K6-fused). Both sides are forced onto a route
through the same policy attributes, as ``tests/ops/test_pallas_joint.py``
forces the JAX side.

Tolerances: the forward 1e-5 (fp32, sums in another order, as the JAX test).
Gradients against JAX on the same route: atol 2e-3 / rtol 1e-3 for the bf16
slab (the JAX test's bound for that route); for the no-slab route atol 2e-5
/ rtol 1e-4 in fp32, since both sides round at the same places and differ
only in the order of fp32 sums; for the int8 route atol 5e-4 / rtol 1e-3,
since a slab entry that falls the other way at a rounding boundary (below)
moves a softmax numerator by one step, 1/127 of its tile's maximum (both far
inside the JAX test's own 2e-3 and 5e-2 against the exact reference); with
bf16 inputs one bf16 ulp (2^-7 relative, atol 2^-7 of the gradient's largest
magnitude), as the gradients themselves come back in bf16. The int8 slab
itself is compared
entry by entry: equal, or one step apart on at most 0.1% of the entries
where the two products differ in the last bit of ``u * (127 / m)``; the
scales at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caiman_asr_tpu.ops.pallas_joint as pj
from caiman_asr_tpu_torch.ops import joint_kernel as jk
from caiman_asr_tpu_torch.ops.transducer_loss import transducer_loss_from_fg

N, Hj, K = 70, 32, 600  # deliberately unaligned
BLANK = K - 1

# mode -> (Z_STORE_LIMIT_BYTES, RECHUNK_LIMIT_BYTES, _ZSTORE_DTYPE, FUSED_BWD), the
# attributes tests/ops/test_pallas_joint.py sets
MODES = {
    "stored": (1 << 62, 0, "auto", False),
    "stored_fused_i8": (1 << 62, 0, "i8", True),
    "fused": (0, 0, "auto", True),
    "stored_fused": (1 << 62, 0, "auto", True),
    "stored_i8": (1 << 62, 0, "i8", False),
    "rechunk": (0, 1 << 62, "auto", False),
    "recompute": (0, 0, "auto", False),
}
FP32_TOL = {"fused": dict(atol=2e-5, rtol=1e-4), "stored_fused_i8": dict(atol=5e-4, rtol=1e-3)}
# (N, Hj, K, scale of h, scale of w): the JAX test's shape; three scale tiles
# of 1,024 with a ragged last one; Hj >= 1024, two scale tiles of 2,048
SHAPES = {"one-tile": (70, 32, 600, 1.0, 0.1), "ragged": (50, 32, 2500, 1.0, 0.1),
          "hj1024": (40, 1024, 2500, 0.1, 0.03)}


def make(n, hj, k, h_scale=1.0, w_scale=0.1, seed=0):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(n, hj)) * h_scale).astype(np.float32)
    w = (rng.normal(size=(hj, k)) * w_scale).astype(np.float32)
    b = (rng.normal(size=(k,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, k - 1, (n,)).astype(np.int32)
    rng = np.random.default_rng(seed + 1)
    cb = rng.normal(size=(n,)).astype(np.float32)
    cl = rng.normal(size=(n,)).astype(np.float32)
    return h, w, b, labels, cb, cl


@pytest.fixture(scope="module")
def data():
    return make(N, Hj, K)


def force(monkeypatch, mode):
    """Put both packages on the route ``mode`` names."""
    for mod in (pj, jk):
        for name, value in zip(("Z_STORE_LIMIT_BYTES", "RECHUNK_LIMIT_BYTES", "_ZSTORE_DTYPE",
                                "FUSED_BWD"), MODES[mode]):
            monkeypatch.setattr(mod, name, value)


@pytest.fixture
def stored(monkeypatch):
    """The JAX side stores the slab, as its test's "stored" mode; the port
    stores it at this size by its default policy."""
    force(monkeypatch, "stored")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("blank", [BLANK, 100])
@pytest.mark.parametrize("grad", [False, True], ids=["K2", "K5-store"])
def test_forward_matches_jax(data, stored, blank, grad):
    h, w, b, labels, _, _ = data
    jb, jl = pj.fused_joint_lse(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(labels), blank, True)
    th, tw, tb, tlab = _t(h, w, b, labels)
    before = (jk.joint_fwd.launches, jk.joint_fwd_store.launches)
    with torch.set_grad_enabled(grad):
        if grad:
            th.requires_grad_()
        lb, ll = jk.fused_joint_lse(th, tw, tb, tlab, blank)
    assert lb.requires_grad == grad
    assert (jk.joint_fwd.launches, jk.joint_fwd_store.launches) == before  # CPU: plain
    np.testing.assert_allclose(lb.detach().numpy(), np.asarray(jb), atol=1e-5)
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("blank", [BLANK, 100])
def test_vjp_matches_jax(data, stored, blank):
    h, w, b, labels, cb, cl = data

    def jloss(h, w, b):
        lb, ll = pj.fused_joint_lse(h, w, b, jnp.asarray(labels), blank, True)
        return jnp.sum(lb * cb) + jnp.sum(ll * cl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    leaves = [t.requires_grad_() for t in _t(h, w, b)]
    lb, ll = jk.fused_joint_lse(*leaves, torch.from_numpy(labels), blank)
    loss = (lb * torch.from_numpy(cb)).sum() + (ll * torch.from_numpy(cl)).sum()
    for g, r in zip(torch.autograd.grad(loss, leaves), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3, rtol=1e-3)


def _both_sides(arrays, blank, bf16):
    """(values and gradients) of JAX and of the port on the same arrays."""
    h, w, b, labels, cb, cl = arrays
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32

    def jloss(h, w, b):
        lb, ll = pj.fused_joint_lse(h, w, b, jnp.asarray(labels), blank, True)
        return jnp.sum(lb * cb) + jnp.sum(ll * cl), (lb, ll)

    jargs = (jnp.asarray(h, jdt), jnp.asarray(w, jdt), jnp.asarray(b))
    (_, jvals), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(*jargs)
    th, tw, tb = _t(h, w, b)
    leaves = [th.to(tdt).requires_grad_(), tw.to(tdt).requires_grad_(), tb.requires_grad_()]
    lb, ll = jk.fused_joint_lse(*leaves, torch.from_numpy(labels), blank)
    loss = (lb * torch.from_numpy(cb)).sum() + (ll * torch.from_numpy(cl)).sum()
    grads = torch.autograd.grad(loss, leaves)
    to_np = lambda x: np.asarray(x.astype(jnp.float32))
    return ([to_np(v) for v in jvals], [to_np(g) for g in jgrads],
            [lb.detach().numpy(), ll.detach().numpy()], [g.float().numpy() for g in grads])


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", ["one-tile", "ragged"])
@pytest.mark.parametrize("mode", ["stored_fused_i8", "fused"])
def test_route_matches_jax(monkeypatch, mode, shape, bf16):
    """Values and gradients in h, w, b on the int8 and the no-slab route."""
    force(monkeypatch, mode)
    n, hj, k, hs, ws = SHAPES[shape]
    arrays = make(n, hj, k, hs, ws, seed=3)
    assert jk.store_plan(n, hj, k)["backward"] == {"stored_fused_i8": "K7-fused-u8",
                                                   "fused": "K6-fused"}[mode]
    jvals, jgrads, vals, grads = _both_sides(arrays, 100, bf16)
    for got, want in zip(vals, jvals):
        np.testing.assert_allclose(got, want, atol=1e-5 if not bf16 else 2e-5)
    for got, want in zip(grads, jgrads):
        if bf16:
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, **FP32_TOL[mode])


@pytest.mark.parametrize("mode", ["stored_fused_i8", "fused"])
def test_route_matches_jax_at_hj_1024(monkeypatch, mode):
    """The Hj >= 1024 tile branch (scale tiles 2,048 wide), fp32."""
    force(monkeypatch, mode)
    n, hj, k, hs, ws = SHAPES["hj1024"]
    assert jk.store_plan(n, hj, k)["kt"] == 2048
    jvals, jgrads, vals, grads = _both_sides(make(n, hj, k, hs, ws, seed=5), k - 1, False)
    for got, want in zip(vals, jvals):
        np.testing.assert_allclose(got, want, atol=1e-5)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, want, **FP32_TOL[mode])


@pytest.mark.parametrize("mode", ["stored_fused_i8", "fused"])
def test_route_is_close_to_the_exact_gradient(data, monkeypatch, mode):
    """Against dense autograd, at the JAX test's own bounds for the route
    (5e-2 / 5e-2 for the lossy int8 slab, 2e-3 / 1e-3 for the no-slab one)."""
    force(monkeypatch, mode)
    h, w, b, labels, cb, cl = _t(*data)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (h, w, b)]
        lb, ll = fn(*leaves)
        return torch.autograd.grad((lb * cb).sum() + (ll * cl).sum(), leaves)

    def dense(h, w, b):
        z = h @ w + b
        d = torch.logsumexp(z, 1)
        return z[:, BLANK] - d, z.gather(1, labels.long()[:, None])[:, 0] - d

    tol = dict(atol=5e-2, rtol=5e-2) if mode.endswith("i8") else dict(atol=2e-3, rtol=1e-3)
    for got, want in zip(grads(lambda h, w, b: jk.fused_joint_lse(h, w, b, labels, BLANK)),
                         grads(dense)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_int8_slab_and_scales_match_jax(monkeypatch, shape, bf16):
    """K7-store8's plain version against the slab and the scales the JAX
    forward stores (``_forward(..., store_z=True)``), entry by entry."""
    force(monkeypatch, "stored_fused_i8")
    n, hj, k, hs, ws = SHAPES[shape]
    h, w, b, labels, _, _ = make(n, hj, k, hs, ws, seed=7)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    *_, denom, up, us = pj._forward(jnp.asarray(h, jdt), jnp.asarray(w, jdt), jnp.asarray(b),
                                    jnp.asarray(labels), k - 1, True, store_z=True)
    kt = pj._tiles(hj)[1]
    th, tw, tb = _t(h, w, b)
    tdt = torch.bfloat16 if bf16 else torch.float32
    sums, q, s = jk.joint_fwd_store8(th.to(tdt), tw.to(tdt).t().contiguous(), tb, kt)
    assert q.dtype == torch.int8 and q.shape == (n, k)
    assert s.shape == (-(-k // kt), n) == (us.shape[0], n)
    np.testing.assert_allclose(np.log(sums.numpy()), np.asarray(denom), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(us)[:, 0, :n], rtol=1e-6)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(up)[:n, :k].astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    assert q.numpy().max() == 127 and q.numpy().min() >= 0


def test_a_zero_scale_tile_quantises_to_zero():
    """m == 0 in a scale tile (every u underflows) gives scale 0 and q 0,
    and dequantises to 0 (``pallas_joint.py:133``)."""
    h = torch.ones(3, 4)
    wt = torch.zeros(256, 4)
    b = torch.cat([torch.zeros(128), torch.full((128,), -200.0)])
    sums, q, s = jk.joint_fwd_store8(h, wt, b, 128)
    assert torch.equal(sums, torch.full((3,), 128.0))
    assert torch.equal(s[1], torch.zeros(3)) and not q[:, 128:].any()
    assert torch.equal(q[:, :128], torch.full((3, 128), 127, dtype=torch.int8))


# (N, Hj, K): the base-85M smoke cell, the entry() shapes, the JAX test's,
# a base batch past the bf16 budget (the int8 plan), large-196M widths at
# B=16, 32, 48 and 64, the row counts either side of its two budgets, and
# one past both budgets at base widths
PLAN_TABLE = [
    (139360, 768, 8704), (432, 768, 8704), (70, 32, 600), (1_000_000, 768, 8704),
    (139360, 1024, 17408), (278720, 1024, 17408), (418080, 1024, 17408),
    (557440, 1024, 17408), (145408, 1024, 17408), (146432, 1024, 17408),
    (407552, 1024, 17408), (408576, 1024, 17408), (4_000_000, 768, 8704),
]


@pytest.mark.parametrize("n,hj,k", PLAN_TABLE)
def test_store_plan_matches_jax(n, hj, k):
    tp, kt = pj._tiles(hj)[:2]
    Np, Kp = -(-n // tp) * tp, -(-k // kt) * kt
    plan = jk.store_plan(n, hj, k)
    assert (plan["Np"], plan["Kp"], plan["kt"]) == (Np, Kp, kt)
    assert (plan["cols"], plan["dtype"]) == tuple(pj._store_plan(Np, Kp, kt))


@pytest.mark.parametrize("n,plan,backward", [
    (145408, "bf16", "K5-A + K5-B"), (146432, "i8", "K7-fused-u8"),
    (407552, "i8", "K7-fused-u8"), (408576, None, "K6-fused"),
    (139360, "bf16", "K5-A + K5-B"), (278720, "i8", "K7-fused-u8"),
    (557440, None, "K6-fused"),
])
def test_large_196m_takes_each_route_by_its_batch(n, plan, backward):
    got = jk.store_plan(n, 1024, 17408)
    assert (got["dtype"], got["backward"]) == (plan, backward)
    assert got["slab_bytes"] == {"bf16": n * 17408 * 2, "i8": n * 17408 + 9 * n * 4,
                                 None: 0}[plan]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("hj,k", [(32, 600), (768, 8704), (1024, 17408)])
def test_policy_functions_match_jax(monkeypatch, mode, hj, k):
    force(monkeypatch, mode)
    assert jk._tiles(hj) == pj._tiles(hj)
    tp, kt, tp_a, kt_a, _, _ = pj._tiles(hj)
    for stored, i8 in ((False, False), (True, False), (True, True)):
        assert jk._use_fused(stored, i8) == pj._use_fused(stored, i8)
    for Kp in (-(-k // kt) * kt, -(-k // kt_a) * kt_a):
        for t, c in ((tp_a, kt_a), (tp_a, kt)):
            assert jk._fused_bwd_fits(hj, Kp, t, c) == pj._fused_bwd_fits(hj, Kp, t, c)
    for Np in (1024, 140288, 279552, 558080):
        for itemsize in (1, 2):
            assert jk._store_cols(Np, 18432, kt, itemsize) == pj._store_cols(Np, 18432, kt,
                                                                             itemsize)


def test_smoke_cell_stores_the_bf16_slab():
    plan = jk.store_plan(139360, 768, 8704)
    assert plan["dtype"] == "bf16" and plan["cols"] == plan["Kp"] == 9216
    assert plan["slab_bytes"] == 139360 * 8704 * 2


def _tiny_call():
    h, w, b, labels, _, _ = _t(*make(8, 4, 40))
    return jk.fused_joint_lse(h.requires_grad_(), w, b, labels, 39)


def test_a_plan_that_does_not_store_the_bf16_slab_raises(monkeypatch):
    """800,000 rows x 9,000 classes: the padded bf16 slab (14.8 GB) is past
    the 12 GiB budget, so the plan is the int8 slab, whose fused backward
    (K7-fused-u8) is ported. With the fused backward switched off the plan
    leads to the two-kernel int8 backward, which is not: a gradient call
    raises naming its kernels before anything is computed, a validation call
    needs no slab."""
    N, Hj, K = 800_000, 4, 9000
    plan = jk.store_plan(N, Hj, K)
    assert (plan["dtype"], plan["backward"]) == ("i8", "K7-fused-u8")
    monkeypatch.setattr(jk, "FUSED_BWD", False)
    h = torch.zeros(N, Hj)
    w, b, labels = torch.zeros(Hj, K), torch.zeros(K), torch.zeros(N, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="K7-A8"):
        jk.fused_joint_lse(h.requires_grad_(), w, b, labels, K - 1)
    with torch.no_grad():
        jk.fused_joint_lse(h[:10], w, b, labels[:10], K - 1)


@pytest.mark.parametrize("mode,kernel", [
    ("stored_fused", "K5-fused-u"), ("stored_i8", "K7-A8"), ("rechunk", "K6-derive-a"),
    ("recompute", "K4-A"),
])
def test_each_unported_route_raises_naming_its_kernel(monkeypatch, mode, kernel):
    force(monkeypatch, mode)
    with pytest.raises(NotImplementedError, match=kernel):
        _tiny_call()


def test_the_hybrid_split_raises(monkeypatch):
    """A budget that holds one vocab tile of three (``Z_STORE_PARTIAL``)."""
    monkeypatch.setattr(jk, "Z_STORE_LIMIT_BYTES", 1024 * 1024 * 2)
    monkeypatch.setattr(jk, "Z_STORE_PARTIAL", True)
    plan = jk.store_plan(70, 16, 2560)
    assert (plan["cols"], plan["dtype"]) == (1024, "bf16")
    h, w, b, labels, _, _ = _t(*make(70, 16, 2560))
    with pytest.raises(NotImplementedError, match="hybrid"):
        jk.fused_joint_lse(h.requires_grad_(), w, b, labels, 2559)


def test_the_no_slab_workspace_does_not_grow_with_the_rows():
    rows = jk.fused_workspace_rows(557_440, 17_408)
    assert rows % 128 == 0 and rows * 17_408 * 4 <= 1 << 30
    assert jk.fused_workspace_rows(10 * 557_440, 17_408) == rows
    assert jk.fused_workspace_rows(200, 17_408) == 256


def test_a_huge_logit_gives_an_infinite_loss():
    """No max subtraction (the JAX contract): exp overflows, the row's
    denominator is inf and that utterance's loss is not finite."""
    rng = np.random.default_rng(2)
    B, T, U, H, Kc = 2, 5, 3, 8, 20
    f = torch.from_numpy(rng.normal(size=(B, T, H)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, U + 1, H)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(Kc, H)) * 0.1).astype(np.float32))
    b = torch.zeros(Kc)
    txt = torch.from_numpy(rng.integers(0, Kc - 1, (B, U)))
    lens = (torch.tensor([T, T]), torch.tensor([U, U]))
    assert torch.isfinite(transducer_loss_from_fg(f, g, w, b, txt, *lens, Kc - 1)).all()
    f[1, 2, 0] = 1e4
    w[3, 0] = 1.0
    loss = transducer_loss_from_fg(f, g, w, b, txt, *lens, Kc - 1)
    assert torch.isfinite(loss[0]) and not torch.isfinite(loss[1])
