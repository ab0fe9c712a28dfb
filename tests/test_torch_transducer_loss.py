"""The port's transducer loss (``caiman_asr_tpu_torch/ops/transducer_loss.py``)
against the JAX package's, on the same inputs made with numpy from a seed.

Tolerances: the dense lattice loss rtol 1e-5 and its gradients atol 1e-5
(fp32; the row scans combine in another tree order); the fused route's loss
rtol 1e-5 against JAX's dense CPU route (the K2 / K5-store plain versions
are exact fp32), its gradients atol 2e-3 / rtol 1e-3 (the port's backward
reads the bf16 u slab, as on the card; the JAX package's bound for that
route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.ops import transducer_loss as jtl
from caiman_asr_tpu_torch.ops import transducer_loss as tl

B, T, U, K = 3, 7, 4, 13
BLANK = K - 1
EOS, STAR = 3, 5


@pytest.fixture(scope="module")
def lattice():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(B, T, U + 1, K)).astype(np.float32)
    labels = rng.integers(0, K - 1, (B, U)).astype(np.int32)
    labels[0, 1] = EOS
    labels[1, 2] = STAR
    t_lens = np.asarray([T, T - 2, 4], np.int32)
    u_lens = np.asarray([U, 3, 0], np.int32)  # the last transcript is empty
    return logits, labels, t_lens, u_lens


MODS = {
    "none": {},
    "delay_eos_star": dict(delay_penalty=0.01, eos_penalty=0.2, eos_idx=EOS,
                           star_penalty=-0.7, star_idx=STAR),
}


@pytest.mark.parametrize("mods", list(MODS))
def test_dense_loss_and_gradients_match_jax(lattice, mods):
    logits, labels, t_lens, u_lens = lattice
    jm, tm = jtl.LossModifiers(**MODS[mods]), tl.LossModifiers(**MODS[mods])
    jfn = lambda x: jtl.transducer_loss(x, jnp.asarray(labels), jnp.asarray(t_lens),
                                        jnp.asarray(u_lens), BLANK, jm)
    want, vjp = jax.vjp(jfn, jnp.asarray(logits))
    ct = np.asarray([1.0, -0.5, 2.0], np.float32)
    (want_grad,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(logits).requires_grad_()
    got = tl.transducer_loss(x, *(torch.from_numpy(a) for a in (labels, t_lens, u_lens)),
                             BLANK, tm)
    (grad,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-5)


def test_linrec_matches_a_loop_with_neg_inf():
    """The log-depth scan equals the sequential recurrence, also where k
    holds NEG_INF (the trap of a cumsum-of-k rewrite)."""
    rng = np.random.default_rng(1)
    b = rng.normal(size=(4, 11)).astype(np.float32)
    k = rng.normal(size=(4, 11)).astype(np.float32)
    k[:, 3] = tl.NEG_INF
    k[2, :] = tl.NEG_INF
    got = tl._linrec(torch.from_numpy(b), torch.from_numpy(k)).numpy()
    want = b.copy()
    for j in range(1, b.shape[1]):
        want[:, j] = np.logaddexp(b[:, j], want[:, j - 1] + k[:, j])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def fg():
    rng = np.random.default_rng(2)
    H, Kc = 16, 40
    f = rng.normal(size=(B, T, H)).astype(np.float32)
    g = rng.normal(size=(B, U + 1, H)).astype(np.float32)
    w = (rng.normal(size=(Kc, H)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(Kc,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, Kc - 1, (B, U)).astype(np.int32)
    t_lens = np.asarray([T, 5, 3], np.int32)
    u_lens = np.asarray([U, 2, 0], np.int32)
    return f, g, w, b, labels, t_lens, u_lens, Kc - 1


def test_fused_route_matches_jax_on_the_cpu(fg):
    f, g, w, b, labels, t_lens, u_lens, blank = fg
    mods = dict(delay_penalty=0.02, eos_penalty=0.1, eos_idx=EOS, star_penalty=-0.5,
                star_idx=STAR)
    jm, tm = jtl.LossModifiers(**mods), tl.LossModifiers(**mods)
    rest = tuple(jnp.asarray(a) for a in (labels, t_lens, u_lens))

    def jloss(f, g, w, b):
        return jnp.sum(jtl.transducer_loss_from_fg(f, g, w, b, *rest, blank, jm)
                       * jnp.arange(1.0, B + 1.0))

    want = jloss(*(jnp.asarray(a) for a in (f, g, w, b)))
    want_grads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (f, g, w, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (f, g, w, b)]
    per_utt = tl.transducer_loss_from_fg(*leaves, *(torch.from_numpy(a) for a in
                                                    (labels, t_lens, u_lens)), blank, tm)
    got = (per_utt * torch.arange(1.0, B + 1.0)).sum()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for gr, wg in zip(torch.autograd.grad(got, leaves), want_grads):
        np.testing.assert_allclose(gr.numpy(), np.asarray(wg), atol=2e-3, rtol=1e-3)


def test_joint_dropout_backward_takes_its_mask_from_the_output():
    """Same output, same cotangent: the port's backward equals the JAX
    package's (which never saw the mask), and only kept positions pass."""
    rate = 0.3
    h = torch.relu(torch.randn(50, 8, generator=torch.Generator().manual_seed(0)))
    h.requires_grad_()
    out = tl.JointDropout.apply(h, rate, torch.Generator().manual_seed(1))
    ct = torch.randn(50, 8, generator=torch.Generator().manual_seed(2))
    (grad,) = torch.autograd.grad(out, h, ct)
    (want,) = jtl._joint_dropout_bwd(rate, jnp.asarray(out.detach().numpy()),
                                     jnp.asarray(ct.numpy()))[1:]
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-6)
    kept = out.detach() != 0
    np.testing.assert_allclose(out.detach()[kept].numpy(), (h.detach()[kept] / (1 - rate)).numpy(),
                               rtol=1e-6)
    assert not grad[~kept].any()


def test_joint_dropout_in_the_loss_needs_a_generator(fg):
    f, g, w, b, labels, t_lens, u_lens, blank = fg
    args = [torch.from_numpy(a) for a in (f, g, w, b, labels, t_lens, u_lens)]
    with pytest.raises(ValueError):
        tl.transducer_loss_from_fg(*args, blank, dropout_rate=0.3)
    a = tl.transducer_loss_from_fg(*args, blank, dropout_rate=0.3,
                                   generator=torch.Generator().manual_seed(0))
    c = tl.transducer_loss_from_fg(*args, blank)
    assert torch.isfinite(a).all() and not torch.equal(a, c)


@pytest.mark.parametrize("kw", [dict(model_group="model")])
def test_routes_not_ported_raise(fg, kw):
    """The vocab-parallel route (JAX's ``vocab_axis``) is ported: outside an
    initialised process group it raises rather than run as one process
    (``tests/test_torch_vocab_parallel.py`` holds it against JAX over gloo
    ranks)."""
    f, g, w, b, labels, t_lens, u_lens, blank = fg
    args = [torch.from_numpy(a) for a in (f, g, w, b, labels, t_lens, u_lens)]
    with pytest.raises(RuntimeError, match="torch.distributed"):
        tl.transducer_loss_from_fg(*args, blank, **kw)


@pytest.mark.parametrize("pack_to", [64, 53])
def test_packed_route_matches_jax_and_the_dense_route(fg, pack_to):
    """pack_to rows (64, and the valid count itself: 53, no multiple of a
    tile) against the JAX packed loss (its Pallas joint in interpret mode
    on the CPU) at the fused route's tolerances, and against the port's
    dense fused route, the same arithmetic on a subset of its rows: loss
    rtol 1e-5, gradients 1e-5 of their largest magnitude."""
    f, g, w, b, labels, t_lens, u_lens, blank = fg
    assert int(np.sum(t_lens * (u_lens + 1))) == 53
    rest = tuple(jnp.asarray(a) for a in (labels, t_lens, u_lens))
    weight = np.arange(1.0, B + 1.0, dtype=np.float32)

    def jloss(f, g, w, b):
        return jnp.sum(jtl.transducer_loss_from_fg(f, g, w, b, *rest, blank, pack_to=pack_to)
                       * weight)

    jargs = tuple(jnp.asarray(a) for a in (f, g, w, b))
    want, want_grads = float(jloss(*jargs)), jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    out = {}
    for route in (pack_to, None):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (f, g, w, b)]
        per_utt = tl.transducer_loss_from_fg(*leaves, *(torch.from_numpy(a) for a in
                                                        (labels, t_lens, u_lens)), blank,
                                             pack_to=route)
        loss = (per_utt * torch.from_numpy(weight)).sum()
        out[route] = float(loss.detach()), torch.autograd.grad(loss, leaves)
    got, grads = out[pack_to]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for gr, wg in zip(grads, want_grads):
        np.testing.assert_allclose(gr.numpy(), np.asarray(wg), atol=2e-3, rtol=1e-3)
    dense, dense_grads = out[None]
    np.testing.assert_allclose(got, dense, rtol=1e-5)
    for gr, dg in zip(grads, dense_grads):
        np.testing.assert_allclose(gr.numpy(), dg.numpy(), atol=1e-5 * float(dg.abs().max()))


def test_an_undercounted_pack_to_poisons_the_loss(fg):
    """One row short of the valid count: every score -inf, the summed loss
    not finite in both packages (never a silently truncated lattice); per
    utterance the same entries are finite (an empty transcript's lattice
    has no label edge to poison)."""
    f, g, w, b, labels, t_lens, u_lens, blank = fg
    want = np.asarray(jtl.transducer_loss_from_fg(
        *(jnp.asarray(a) for a in (f, g, w, b, labels, t_lens, u_lens)), blank, pack_to=52))
    args = [torch.from_numpy(a) for a in (f, g, w, b, labels, t_lens, u_lens)]
    lp_b, lp_l = tl._packed_joint_scores(*args, blank, 52)
    assert torch.isneginf(lp_b).all() and torch.isneginf(lp_l).all()
    got = tl.transducer_loss_from_fg(*args, blank, pack_to=52).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert not np.isfinite(want.sum()) and not np.isfinite(got.sum())
