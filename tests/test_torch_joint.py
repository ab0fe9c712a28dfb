"""The port's fused joint + log-sum-exp (``caiman_asr_tpu_torch/ops/
joint_kernel.py``, the plain versions of K2, K5-store, K5-A and K5-B on the
CPU) against the JAX package's ``fused_joint_lse`` in interpret mode, at the
JAX test's own unaligned shape (``tests/ops/test_pallas_joint.py``).

Tolerances: the forward 1e-5 (fp32, sums in another order, as the JAX test);
gradients atol 2e-3 / rtol 1e-3, the JAX test's bound for its stored-slab
route, which both sides take here.
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


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(N, Hj)).astype(np.float32)
    w = (rng.normal(size=(Hj, K)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(K,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, K - 1, (N,)).astype(np.int32)
    rng = np.random.default_rng(1)
    cb = rng.normal(size=(N,)).astype(np.float32)
    cl = rng.normal(size=(N,)).astype(np.float32)
    return h, w, b, labels, cb, cl


@pytest.fixture
def stored(monkeypatch):
    """The JAX side stores the slab, as its test's "stored" mode; the port
    stores it at this size by its default policy."""
    monkeypatch.setattr(pj, "Z_STORE_LIMIT_BYTES", 1 << 62)
    monkeypatch.setattr(pj, "RECHUNK_LIMIT_BYTES", 0)
    monkeypatch.setattr(pj, "_ZSTORE_DTYPE", "auto")
    monkeypatch.setattr(pj, "FUSED_BWD", False)


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


# (N, Hj, K): the base-85M smoke cell, the entry() shapes, the JAX test's,
# a base batch past the bf16 budget (the int8 plan), large-196M widths at
# B=16 and B=48, and one past both budgets
PLAN_TABLE = [
    (139360, 768, 8704), (432, 768, 8704), (70, 32, 600), (1_000_000, 768, 8704),
    (139360, 1024, 17408), (418080, 1024, 17408), (4_000_000, 768, 8704),
]


@pytest.mark.parametrize("n,hj,k", PLAN_TABLE)
def test_store_plan_matches_jax(n, hj, k):
    tp, kt = pj._tiles(hj)[:2]
    Np, Kp = -(-n // tp) * tp, -(-k // kt) * kt
    plan = jk.store_plan(n, hj, k)
    assert (plan["Np"], plan["Kp"]) == (Np, Kp)
    assert (plan["cols"], plan["dtype"]) == tuple(pj._store_plan(Np, Kp, kt))


def test_smoke_cell_stores_the_bf16_slab():
    plan = jk.store_plan(139360, 768, 8704)
    assert plan["dtype"] == "bf16" and plan["cols"] == plan["Kp"] == 9216
    assert plan["slab_bytes"] == 139360 * 8704 * 2


def test_a_plan_that_does_not_store_the_bf16_slab_raises():
    """800,000 rows x 9,000 classes: the padded bf16 slab (14.8 GB) is past
    the 12 GiB budget, so the plan is the int8 slab (K7), which is not
    ported; a gradient call raises, a validation call needs no slab."""
    N, Hj, K = 800_000, 4, 9000
    assert jk.store_plan(N, Hj, K)["dtype"] == "i8"
    h = torch.zeros(N, Hj)
    w, b, labels = torch.zeros(Hj, K), torch.zeros(K), torch.zeros(N, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="K6"):
        jk.fused_joint_lse(h.requires_grad_(), w, b, labels, K - 1)
    with torch.no_grad():
        jk.fused_joint_lse(h[:10], w, b, labels[:10], K - 1)


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
