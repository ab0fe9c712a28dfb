"""The port's fused joint + log-sum-exp (``caiman_asr_tpu_torch/ops/
joint_kernel.py``, the plain versions of its kernels on the CPU) against the
JAX package's ``fused_joint_lse`` in interpret mode, on every route of its
backward: the bf16 slab (K5-store; K5-A + K5-B, or K5-fused-u), the int8 slab
(K7-store8; K7-fused-u8, or K7-A8 + K7-B8), no slab (K2; K6-fused, the
rechunked K6-derive-a + K5-B, or the per-pass recompute K4-A + K4-B) and the
hybrid split (the bf16 slab over the first columns, K4 over the rest). Both
sides are forced onto a route through the same policy attributes, as
``tests/ops/test_pallas_joint.py`` forces the JAX side.

Tolerances: the forward 1e-5 (fp32, sums in another order, as the JAX test).
Gradients against JAX on the same route, fp32: atol 2e-3 / rtol 1e-3 where u
is parked in bf16 (the bf16 slab, the rechunked route, the stored columns of
the hybrid split: the JAX test's bound for those routes; a u whose last fp32
bits differ may round to the other bf16 neighbour); atol 2e-5 / rtol 1e-4
where nothing is parked in fewer bits (K6-fused, the per-pass recompute, the
recomputed columns of the hybrid split): both sides round at the same places
and differ only in the order of fp32 sums; for the int8 routes atol 5e-4 /
rtol 1e-3, since a slab entry that falls the other way at a rounding
boundary (below) moves a softmax numerator by one step, 1/127 of its tile's
maximum (both far inside the JAX test's own 2e-3 and 5e-2 against the exact
reference); with bf16 inputs one bf16 ulp (2^-7 relative, atol 2^-7 of the
gradient's largest magnitude), as the gradients themselves come back in
bf16. The int8 slab itself is compared entry by entry: equal, or one step
apart on at most 0.1% of the entries where the two products differ in the
last bit of ``u * (127 / m)``; the scales at rtol 1e-6.
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
BF16_PARKED, EXACT, INT8 = (dict(atol=2e-3, rtol=1e-3), dict(atol=2e-5, rtol=1e-4),
                            dict(atol=5e-4, rtol=1e-3))
FP32_TOL = {"stored": BF16_PARKED, "stored_fused": BF16_PARKED, "rechunk": BF16_PARKED,
            "fused": EXACT, "recompute": EXACT, "stored_fused_i8": INT8, "stored_i8": INT8}
BACKWARD = {"stored": "K5-A + K5-B", "stored_fused": "K5-fused-u", "stored_i8": "K7-A8 + K7-B8",
            "stored_fused_i8": "K7-fused-u8", "fused": "K6-fused",
            "rechunk": "K6-derive-a + K5-B", "recompute": "K4-A + K4-B"}
ROUTE_MODES = ["stored_fused_i8", "fused", "stored_fused", "stored_i8", "rechunk", "recompute"]
# (N, Hj, K, scale of h, scale of w): the JAX test's shape; three scale tiles
# of 1,024 with a ragged last one; Hj >= 1024, two scale tiles of 2,048; the
# JAX test's shape for the hybrid split, two and a half vocab tiles
SHAPES = {"one-tile": (70, 32, 600, 1.0, 0.1), "ragged": (50, 32, 2500, 1.0, 0.1),
          "hj1024": (40, 1024, 2500, 0.1, 0.03), "hybrid": (70, 16, 2560, 1.0, 0.1)}


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


def force_hybrid(monkeypatch, n, hj, tiles, fused="auto"):
    """Put both packages on the hybrid split: a budget that holds ``tiles``
    vocab tiles of the bf16 slab, and ``Z_STORE_PARTIAL``. Returns the
    columns stored."""
    tp, kt = pj._tiles(hj)[:2]
    for mod in (pj, jk):
        monkeypatch.setattr(mod, "Z_STORE_LIMIT_BYTES", -(-n // tp) * tp * 2 * kt * tiles)
        monkeypatch.setattr(mod, "Z_STORE_PARTIAL", True)
        monkeypatch.setattr(mod, "FUSED_BWD", fused)
    return kt * tiles


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
    # the reference from copies of the inputs (no buffer shared with numpy),
    # finished before the port runs: JAX dispatches asynchronously
    jb, jl = pj.fused_joint_lse(jnp.array(h), jnp.array(w), jnp.array(b),
                                jnp.array(labels), blank, True)
    jb, jl = np.array(jax.block_until_ready(jb)), np.array(jl)
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
@pytest.mark.parametrize("grad", [False, True], ids=["K2", "K5-store"])
def test_forward_matches_float64(data, blank, grad):
    """The port's forward within 1e-5 of the same scores in float64 (numpy),
    as each side of test_forward_matches_jax should be. The one suite run
    in which that test failed (9 of 70 rows up to 3.05e-5 apart) printed
    port values within 3.3e-7 of these."""
    h, w, b, labels, _, _ = data
    z = h.astype(np.float64) @ w.astype(np.float64) + b
    lse = np.log(np.exp(z).sum(1))
    th, tw, tb, tlab = _t(h, w, b, labels)
    with torch.set_grad_enabled(grad):
        lb, ll = jk.fused_joint_lse(th.requires_grad_(grad), tw, tb, tlab, blank)
    np.testing.assert_allclose(lb.detach().numpy(), z[:, blank] - lse, atol=1e-5)
    np.testing.assert_allclose(ll.detach().numpy(), z[np.arange(len(labels)), labels] - lse,
                               atol=1e-5)


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


def _assert_grads_close(grads, jgrads, bf16, tols):
    """``tols``: one fp32 tolerance per gradient (h, w, b)."""
    for got, want, tol in zip(grads, jgrads, tols):
        if bf16:
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", ["one-tile", "ragged"])
@pytest.mark.parametrize("mode", ROUTE_MODES)
def test_route_matches_jax(monkeypatch, mode, shape, bf16):
    """Values and gradients in h, w, b on every route the knobs reach beside
    the default bf16-slab one."""
    force(monkeypatch, mode)
    n, hj, k, hs, ws = SHAPES[shape]
    arrays = make(n, hj, k, hs, ws, seed=3)
    assert jk.store_plan(n, hj, k)["backward"] == BACKWARD[mode]
    jvals, jgrads, vals, grads = _both_sides(arrays, 100, bf16)
    for got, want in zip(vals, jvals):
        np.testing.assert_allclose(got, want, atol=1e-5 if not bf16 else 2e-5)
    _assert_grads_close(grads, jgrads, bf16, [FP32_TOL[mode]] * 3)


@pytest.mark.parametrize("mode", ROUTE_MODES)
def test_route_matches_jax_at_hj_1024(monkeypatch, mode):
    """The Hj >= 1024 tile branch (scale tiles 2,048 wide), fp32."""
    force(monkeypatch, mode)
    n, hj, k, hs, ws = SHAPES["hj1024"]
    assert jk.store_plan(n, hj, k)["kt"] == 2048
    jvals, jgrads, vals, grads = _both_sides(make(n, hj, k, hs, ws, seed=5), k - 1, False)
    for got, want in zip(vals, jvals):
        np.testing.assert_allclose(got, want, atol=1e-5)
    _assert_grads_close(grads, jgrads, False, [FP32_TOL[mode]] * 3)


def _dense_grads(h, w, b, labels, cb, cl, blank):
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    z = leaves[0] @ leaves[1] + leaves[2]
    d = torch.logsumexp(z, 1)
    lb, ll = z[:, blank] - d, z.gather(1, labels.long()[:, None])[:, 0] - d
    return torch.autograd.grad((lb * cb).sum() + (ll * cl).sum(), leaves)


def _port_grads(h, w, b, labels, cb, cl, blank):
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    lb, ll = jk.fused_joint_lse(*leaves, labels, blank)
    return torch.autograd.grad((lb * cb).sum() + (ll * cl).sum(), leaves)


@pytest.mark.parametrize("mode", ROUTE_MODES)
def test_route_is_close_to_the_exact_gradient(data, monkeypatch, mode):
    """Against dense autograd, at the JAX test's own bounds for the route
    (5e-2 / 5e-2 for the lossy int8 slab, 2e-4 / 1e-4 for the per-pass
    recompute, 2e-3 / 1e-3 for the others)."""
    force(monkeypatch, mode)
    args = _t(*data)
    tol = (dict(atol=5e-2, rtol=5e-2) if mode.endswith("i8") else
           dict(atol=2e-4, rtol=1e-4) if mode == "recompute" else dict(atol=2e-3, rtol=1e-3))
    for got, want in zip(_port_grads(*args, BLANK), _dense_grads(*args, BLANK)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


# (shape, vocab tiles stored, blank, FUSED_BWD): the JAX test's shape (1,024
# of 2,560 columns stored, the recomputed rest ragged, labels on both sides)
# with the blank in the recomputed and in the stored part; two tiles of a
# ragged three; the stored part through K5-fused-u; scale tiles 2,048 wide
HYBRID = {"blank-recomputed": ("hybrid", 1, 2559, "auto"),
          "blank-stored": ("hybrid", 1, 100, "auto"),
          "two-tiles": ("ragged", 2, 100, "auto"),
          "fused-stored-part": ("hybrid", 1, 2559, True),
          "hj1024": ("hj1024", 1, 2499, "auto")}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(HYBRID))
def test_hybrid_split_matches_jax(monkeypatch, case, bf16):
    """``Z_STORE_PARTIAL``: the slab over [0, ks), K4 over [ks, K). dW and db
    of the recomputed columns at the recompute's tolerance, the rest at the
    bf16 slab's."""
    shape, tiles, blank, fused = HYBRID[case]
    n, hj, k, hs, ws = SHAPES[shape]
    ks = force_hybrid(monkeypatch, n, hj, tiles, fused)
    plan = jk.store_plan(n, hj, k)
    assert (plan["dtype"], plan["ks"], plan["cols"]) == ("bf16", ks, ks) and ks < k
    assert plan["route"] == ("K5-fused-u" if fused is True else "K5-A + K5-B")
    assert "K4-A + K4-B" in plan["backward"] and "hybrid" in plan["backward"]
    jnp_t = jnp.bfloat16 if bf16 else jnp.float32
    *_, up, _ = pj._forward(jnp.zeros((n, hj), jnp_t), jnp.zeros((hj, k), jnp_t),
                            jnp.zeros((k,)), jnp.zeros((n,), jnp.int32), blank, True,
                            store_z=True)
    assert up.shape[1] == ks  # the JAX side splits at the same column
    arrays = make(n, hj, k, hs, ws, seed=3)
    assert (arrays[3] < ks).any() and (arrays[3] >= ks).any()  # labels on both sides
    jvals, jgrads, vals, grads = _both_sides(arrays, blank, bf16)
    for got, want in zip(vals, jvals):
        np.testing.assert_allclose(got, want, atol=1e-5 if not bf16 else 2e-5)
    _assert_grads_close(grads, jgrads, bf16, [BF16_PARKED] * 3)
    if not bf16:
        for got, want in zip(grads[1:], jgrads[1:]):
            np.testing.assert_allclose(got[..., ks:], want[..., ks:], **EXACT)


def test_hybrid_split_is_close_to_the_exact_gradient(monkeypatch):
    n, hj, k, hs, ws = SHAPES["hybrid"]
    force_hybrid(monkeypatch, n, hj, 1)
    args = _t(*make(n, hj, k, hs, ws, seed=3))
    for got, want in zip(_port_grads(*args, k - 1), _dense_grads(*args, k - 1)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3, rtol=1e-3)


def test_rechunked_route_walks_the_rows_in_chunks(monkeypatch):
    """``RECHUNK_LIMIT_BYTES`` = 1 MiB at N=1,100, K=600: 1,536 padded rows
    of 1,024 padded bf16 columns are 3 MiB, so three chunks of 512 rows
    (``tests/ops/test_pallas_joint.py``); dW and db add up across the chunks,
    the smear is put together in order, and the bf16 tile K6-derive-a hands
    to K5-B has a chunk's rows, never N."""
    for mod in (pj, jk):
        monkeypatch.setattr(mod, "Z_STORE_LIMIT_BYTES", 0)
        monkeypatch.setattr(mod, "RECHUNK_LIMIT_BYTES", 1 << 20)
        monkeypatch.setattr(mod, "FUSED_BWD", False)
    n, hj, k = 1100, 16, 600
    assert jk.store_plan(n, hj, k)["backward"] == "K6-derive-a + K5-B"
    assert jk.rechunk_rows(n, hj, k) == 512
    tiles = []
    derive = jk.joint_derive_a

    def recording(h, w, b, cs):
        u, smear = derive(h, w, b, cs)
        tiles.append(tuple(u.shape))
        return u, smear

    monkeypatch.setattr(jk, "joint_derive_a", recording)
    jvals, jgrads, vals, grads = _both_sides(make(n, hj, k, seed=7), k - 1, False)
    assert tiles == [(512, k), (512, k), (76, k)]
    for got, want in zip(vals, jvals):
        np.testing.assert_allclose(got, want, atol=1e-5)
    _assert_grads_close(grads, jgrads, False, [BF16_PARKED] * 3)


def test_rechunk_rows_follow_the_budget():
    """large-196M at B=64: 37 chunks of 15,360 rows under the default 512 MiB."""
    assert jk.RECHUNK_LIMIT_BYTES == 512 << 20
    rows = jk.rechunk_rows(557_440, 1024, 17_408)
    assert rows == 15_360 and -(-557_440 // rows) == 37
    assert rows * 17_408 * 2 <= jk.RECHUNK_LIMIT_BYTES
    assert jk.rechunk_rows(70, 32, 600) == 512  # one chunk, padded to the row tile


# --------------------------- the new wrappers' plain twins, direct formulas
def _direct_inputs(n=70, hj=24, k=333, seed=11):
    h, w, b, labels, cb, cl = _t(*make(n, hj, k, seed=seed))
    z = h @ w + b
    return h, w, b, labels, cb, cl, z


@pytest.fixture
def small_chunks(monkeypatch):
    """The plain versions walk the rows in chunks of 32: several per call."""
    monkeypatch.setattr(jk, "_PLAIN_ROWS", 32)


def _dz_direct(u, c, cl, labels):
    dz = -c[:, None] * u
    for row, lab in enumerate(labels.tolist()):
        if 0 <= lab < u.shape[1]:
            dz[row, lab] += cl[row]
    return dz


def test_fused_u_twin_is_both_slab_passes(small_chunks):
    h, w, b, labels, cb, cl, z = _direct_inputs()
    u = torch.exp(z).to(torch.bfloat16)
    cs = (cb + cl) * 1e-2
    smear, dw, db = jk.joint_bwd_fused_u(h, u, w, cs, cl, labels)
    torch.testing.assert_close(smear, -cs[:, None] * (u.float() @ w.t()))
    dz = _dz_direct(u.float(), cs, cl, labels)
    torch.testing.assert_close(dw, h.t() @ dz)
    torch.testing.assert_close(db, dz.sum(0))
    for got, want in zip((smear, dw, db),
                         (jk.joint_bwd_dh(u, w, cs), *jk.joint_bwd_dw(h, u, cs, cl, labels))):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("kt", [128, 1024])
def test_int8_pass_twins_match_a_direct_formula(small_chunks, kt):
    """K7-A8 rounds the dequantised u to bf16 for its product, K7-B8 builds
    dz from the unrounded one; a ragged last scale tile (333 columns)."""
    h, w, b, labels, cb, cl, z = _direct_inputs()
    _, q, s = jk.joint_fwd_store8(h, w.t().contiguous(), b, kt)
    uf = q.float() * s.t().repeat_interleave(kt, dim=1)[:, :q.shape[1]]
    cs = (cb + cl) * 1e-2
    smear = jk.joint_bwd_dh_u8(q, s, w, cs, kt)
    torch.testing.assert_close(smear, -cs[:, None] * (uf.to(torch.bfloat16).float() @ w.t()))
    unrounded = -cs[:, None] * (uf @ w.t())
    assert (smear - unrounded).abs().max() > 1e-5 * smear.abs().max()  # the rounding is there
    dw, db = jk.joint_bwd_dw_u8(h, q, s, cs, cl, labels, kt)
    dz = _dz_direct(uf, cs, cl, labels)
    torch.testing.assert_close(dw, h.t() @ dz)
    torch.testing.assert_close(db, dz.sum(0))
    for got, want in zip(jk.joint_bwd_fused_u8(h, q, s, w, cs, cl, labels, kt), (smear, dw, db)):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_derive_a_twin_rounds_the_smear_from_the_fp32_u(small_chunks, bf16):
    """The tile is bf16 whatever the inputs; the smear's u is rounded to the
    weight dtype from the fp32 u, so with fp32 weights it never sees the
    bf16 tile."""
    h, w, b, labels, cb, cl, _ = _direct_inputs()
    if bf16:
        h, w = h.to(torch.bfloat16), w.to(torch.bfloat16)
    cs = (cb + cl) * 1e-2
    u32 = torch.exp(h.float() @ w.float() + b)
    u, smear = jk.joint_derive_a(h, w, b, cs)
    assert u.dtype == torch.bfloat16 and torch.equal(u, u32.to(torch.bfloat16))
    torch.testing.assert_close(smear, -cs[:, None] * (u32.to(w.dtype).float() @ w.float().t()))
    from_tile = -cs[:, None] * (u.float() @ w.float().t())
    if bf16:
        torch.testing.assert_close(smear, from_tile)
    else:  # the tile's rounding, 2^-9 of each u, would show
        assert (smear - from_tile).abs().max() > 1e-5 * smear.abs().max()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("out32,out16", [(True, False), (False, True), (True, True)])
def test_derive_twin_matches_jax_numerators(small_chunks, bf16, shifted, out32, out16):
    """The derivation alone (the first launch of each chunk of K6-fused,
    K6-derive-a and K4): exp(h w + b - shift), the numerators JAX's no-slab
    kernels recompute (pallas_joint.py:144-162, :165-187, :190-235), in fp32
    and / or rounded once to bf16. fp32 1e-6 (sums in another order); bf16
    one step where the fp32 values round to neighbours."""
    h, w, b, *_ = make(n=90, hj=24, k=333, seed=12)
    if bf16:  # both sides take the same bf16-representable inputs
        h, w = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (h, w))
    z = jnp.matmul(h, w, precision=jax.lax.Precision.HIGHEST) + b
    shift = np.array(jax.nn.logsumexp(z, axis=1)) if shifted else None
    want = np.asarray(jnp.exp(z - (shift[:, None] if shifted else 0.0)))
    ht, wt = (torch.from_numpy(a) for a in (h, np.ascontiguousarray(w.T)))
    if bf16:
        ht, wt = ht.to(torch.bfloat16), wt.to(torch.bfloat16)
    before = jk.joint_derive.launches
    v32, v16 = jk.joint_derive(ht, wt, torch.from_numpy(b),
                               torch.from_numpy(shift) if shifted else None, out32, out16)
    assert jk.joint_derive.launches == before  # the plain version: nothing launched
    assert (v32 is None) != out32 and (v16 is None) != out16
    if out32:
        np.testing.assert_allclose(v32.numpy(), want, rtol=1e-6, atol=0)
    if out16:
        assert v16.dtype == torch.bfloat16
        np.testing.assert_allclose(v16.float().numpy(), want, rtol=2 ** -8, atol=0)
    if out32 and out16:
        assert torch.equal(v16, v32.to(torch.bfloat16))


def test_derive_twin_asks_for_an_output():
    h, w, b, *_ = _direct_inputs()
    with pytest.raises(ValueError, match="output"):
        jk.joint_derive(h, w.t().contiguous(), b, None, False, False)


@pytest.mark.parametrize("hj", [8, 96, 512, 768, 1023, 1024, 1536])
def test_the_forward_kernel_takes_every_scale_tile_the_policy_makes(hj):
    """The bf16 forward takes scale tiles that divide its 2,048-column
    rounds; the store policy (the JAX package's tile sizes) only ever asks
    for 1,024 or 2,048. The plain version takes any width."""
    assert jk._tiles(hj)[1] == pj._tiles(hj)[1] and jk._tiles(hj)[1] in jk.FWD_SCALE_TILES
    assert jk.FWD_SCALE_TILES == tuple(k for k in range(128, 2049, 128) if 2048 % k == 0)
    h, w, b, *_ = _direct_inputs(n=20, hj=8, k=300)
    for kt in (8, 100, 384):
        assert jk.joint_fwd_store8(h, w.t().contiguous(), b, kt)[2].shape == (-(-300 // kt), 20)


@pytest.mark.parametrize("lo,hi", [(0, None), (100, 333), (0, 128), (37, 205)])
def test_recompute_twins_match_a_direct_formula_over_a_column_range(small_chunks, lo, hi):
    """K4-A and K4-B over [lo, hi): the softmax with the unscaled
    coefficient cb + cl; labels relative to ``lo``, those outside the range
    (negative, or past its end) meeting no column."""
    h, w, b, labels, cb, cl, z = _direct_inputs()
    end = w.shape[1] if hi is None else hi
    denom = torch.logsumexp(z, 1)
    p = torch.exp(z - denom[:, None])[:, lo:end]
    c = cb + cl
    smear = jk.joint_bwd_dh_recompute(h, w, b, denom, c, lo, hi)
    torch.testing.assert_close(smear, -c[:, None] * (p @ w[:, lo:end].t()))
    rel = (labels - lo).to(torch.int32)
    outside = ((rel < 0) | (rel >= end - lo)).sum().item()
    assert (outside > 0) == ((lo, end) != (0, w.shape[1]))
    dw, db = jk.joint_bwd_dw_recompute(h, w, b, denom, c, cl, rel, lo, hi)
    dz = _dz_direct(p, c, cl, rel)
    assert dw.shape == (h.shape[1], end - lo) and db.shape == (end - lo,)
    torch.testing.assert_close(dw, h.t() @ dz)
    torch.testing.assert_close(db, dz.sum(0))
    # the whole backward is the sum of its ranges' parts
    if (lo, end) != (0, w.shape[1]):
        whole = jk.joint_bwd_dh_recompute(h, w, b, denom, c)
        rest = (jk.joint_bwd_dh_recompute(h, w, b, denom, c, 0, lo)
                + jk.joint_bwd_dh_recompute(h, w, b, denom, c, end, None))
        torch.testing.assert_close(smear + rest, whole)


def test_recompute_twins_reject_a_range_outside_the_vocabulary():
    h, w, b, labels, cb, cl, z = _direct_inputs()
    denom = torch.logsumexp(z, 1)
    for lo, hi in ((-1, 10), (10, 5), (0, 334)):
        with pytest.raises(ValueError, match="column range"):
            jk.joint_bwd_dh_recompute(h, w, b, denom, cb + cl, lo, hi)


def test_pass_b_adds_into_what_it_is_given(small_chunks):
    """K5-B with ``out``: the rows in two chunks add up to one call's."""
    h, w, b, labels, cb, cl, z = _direct_inputs()
    u = torch.exp(z).to(torch.bfloat16)
    cs = (cb + cl) * 1e-2
    dw, db = jk.joint_bwd_dw(h, u, cs, cl, labels)
    out = jk.joint_bwd_dw(h[:40], u[:40], cs[:40], cl[:40], labels[:40])
    same = jk.joint_bwd_dw(h[40:], u[40:], cs[40:], cl[40:], labels[40:], out=out)
    assert same[0] is out[0] and same[1] is out[1]
    torch.testing.assert_close(out[0], dw)
    torch.testing.assert_close(out[1], db)


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
    h.requires_grad_()
    return h, jk.fused_joint_lse(h, w, b, labels, 39)


def test_a_plan_that_does_not_store_the_bf16_slab_raises(monkeypatch):
    """800,000 rows x 9,000 classes: the padded bf16 slab (14.8 GB) is past
    the 12 GiB budget, so the plan is the int8 slab with its fused backward
    (K7-fused-u8). With the fused backward switched off the plan names the
    two-kernel int8 backward, and a small call forced onto that route
    returns gradients (no route raises). A validation call needs no slab."""
    N, Hj, K = 800_000, 4, 9000
    plan = jk.store_plan(N, Hj, K)
    assert (plan["dtype"], plan["backward"]) == ("i8", "K7-fused-u8")
    monkeypatch.setattr(jk, "FUSED_BWD", False)
    assert jk.store_plan(N, Hj, K)["backward"] == "K7-A8 + K7-B8"
    monkeypatch.setattr(jk, "_ZSTORE_DTYPE", "i8")
    assert jk.store_plan(8, 4, 40)["backward"] == "K7-A8 + K7-B8"
    before = (jk.joint_bwd_dh_u8.launches, jk.joint_bwd_dw_u8.launches)
    h, (lb, ll) = _tiny_call()
    (dh,) = torch.autograd.grad(lb.sum() + 2 * ll.sum(), h)
    assert dh.shape == (8, 4) and torch.isfinite(dh).all() and dh.any()
    assert (jk.joint_bwd_dh_u8.launches, jk.joint_bwd_dw_u8.launches) == before  # CPU: plain
    with torch.no_grad():
        w, b = torch.zeros(Hj, K), torch.zeros(K)
        jk.fused_joint_lse(torch.zeros(10, Hj), w, b, torch.zeros(10, dtype=torch.int32), K - 1)


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
