"""The port's pruned two-stage loss (``caiman_asr_tpu_torch/ops/pruned_loss.py``)
against the JAX package's (``caiman_asr_tpu/ops/pruned_loss.py``), on the same
inputs made with numpy from a seed and the same heads carried across.

Each JAX reference is computed once, in a module-scoped fixture. The
objective from (f, g) is held at a joint width that is not a multiple of 128
(the JAX plain-logits route, which the port takes too) and at Hj = 128
(JAX's fused Pallas joint in interpret mode; the port's fused joint, whose
CPU path is the kernels' plain versions, with the bf16 slab).

Tolerances: scores and posteriors atol 2e-5 (fp32, sums in another order);
the ranges are integers and equal exactly; the banded lattice's loss rtol
1e-5 and gradients atol 1e-5; the objective's loss rtol 1e-5 and its
gradients atol 1e-3 / rtol 1e-3 (the fused route's backward reads the bf16
slab on both sides and rounds dz to the compute dtype); the full band
against the port's dense loss rtol 1e-5 / gradients atol 2e-5 (the same
lattice in band coordinates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caiman_asr_tpu.ops.pallas_joint as pj
from caiman_asr_tpu.ops import pruned_loss as jpl
from caiman_asr_tpu.ops import transducer_loss as jtl
from caiman_asr_tpu_torch.ops import pruned_loss as pl
from caiman_asr_tpu_torch.ops import transducer_loss as tl

EOS, STAR = 2, 3
MODS = {
    "none": {},
    "delay": dict(delay_penalty=0.1),
    "eos": dict(eos_penalty=0.3, eos_idx=EOS, delay_penalty=0.05),
    "star": dict(star_penalty=-0.7, star_idx=STAR),
    "all": dict(delay_penalty=0.1, eos_penalty=0.2, eos_idx=EOS, star_penalty=-0.5,
                star_idx=STAR),
}


def _case(rng, B=3, T=9, U=5, K=13):
    labels = rng.integers(0, K - 1, size=(B, U)).astype(np.int32)
    labels[0, 1], labels[1, 2] = EOS, STAR
    t_lens = rng.integers(U + 2, T + 1, size=B).astype(np.int32)
    u_lens = rng.integers(1, U + 1, size=B).astype(np.int32)
    t_lens[0], u_lens[0] = T, U
    return labels, t_lens, u_lens


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_simple_scores_match_jax():
    rng = np.random.default_rng(0)
    B, T, U, K = 2, 6, 4, 9
    am = rng.normal(size=(B, T, K)).astype(np.float32) * 3
    lm = rng.normal(size=(B, U + 1, K)).astype(np.float32) * 3
    labels, _, _ = _case(rng, B=B, T=T, U=U, K=K)
    want = jpl.simple_lattice_scores(jnp.asarray(am), jnp.asarray(lm), jnp.asarray(labels),
                                     blank_idx=K - 1)
    got = pl.simple_lattice_scores(*_t(am, lm, labels), blank_idx=K - 1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


# the edge cases of prune_ranges: u_len + 1 < S (smax 0), t_len = 1, and
# frames past t_len (pinned to smax)
RANGE_CASES = {
    "ragged": (4, 12, 7, 3, None),
    "short_transcripts": (3, 8, 6, 5, dict(u_lens=[6, 2, 1], t_lens=[8, 8, 5])),
    "one_frame": (3, 8, 4, 3, dict(u_lens=[4, 3, 0], t_lens=[8, 1, 1])),
    "wide_band": (2, 7, 3, 4, None),
}


@pytest.mark.parametrize("case", list(RANGE_CASES))
def test_prune_ranges_equal_jax_exactly(case):
    B, T, U, S, lens = RANGE_CASES[case]
    rng = np.random.default_rng(3)
    _, t_lens, u_lens = _case(rng, B=B, T=T, U=U)
    if lens:
        t_lens = np.asarray(lens["t_lens"], np.int32)
        u_lens = np.asarray(lens["u_lens"], np.int32)
    y = np.abs(rng.normal(size=(B, T, U + 1))).astype(np.float32)
    y[0, 2, :] = 0.5  # ties: the first maximum wins on both sides
    y[1, 3, 1] = np.inf
    want = np.asarray(jax.jit(jpl.prune_ranges, static_argnums=3)(
        jnp.asarray(y), jnp.asarray(t_lens), jnp.asarray(u_lens), S))
    got = pl.prune_ranges(*_t(y, t_lens, u_lens), S)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def lattice_case():
    rng = np.random.default_rng(4)
    B, T, U, S = 3, 10, 6, 3
    labels, t_lens, u_lens = _case(rng, B=B, T=T, U=U)
    mods = jtl.LossModifiers(**MODS["all"])
    null, emit = jtl._penalised_scores(
        jnp.asarray(rng.normal(size=(B, T, U + 1)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(B, T, U + 1)).astype(np.float32)),
        jnp.asarray(labels), jnp.asarray(t_lens), mods)
    tl_, ul_ = jnp.asarray(t_lens), jnp.asarray(u_lens)
    post = jax.jit(jpl.emit_posteriors)(null, emit, tl_, ul_)
    ranges = jax.jit(jpl.prune_ranges, static_argnums=3)(post, tl_, ul_, S)
    j = np.arange(S)
    idx = np.minimum(np.asarray(ranges)[:, :, None] + j, U)
    nb = np.take_along_axis(np.asarray(null), idx, axis=2)
    eb = np.take_along_axis(np.asarray(emit), idx, axis=2)
    ct = np.asarray([1.0, -0.5, 2.0], np.float32)
    fn = lambda n, e: jpl.banded_rnnt_lattice(n, e, ranges, tl_, ul_)
    loss = jax.jit(fn)(jnp.asarray(nb), jnp.asarray(eb))
    grads = jax.jit(jax.grad(lambda n, e: jnp.sum(fn(n, e) * ct), argnums=(0, 1)))(
        jnp.asarray(nb), jnp.asarray(eb))
    return dict(null=np.asarray(null), emit=np.asarray(emit), t_lens=t_lens, u_lens=u_lens,
                post=np.asarray(post), ranges=np.asarray(ranges), nb=nb, eb=eb, ct=ct,
                loss=np.asarray(loss), grads=[np.asarray(g) for g in grads], S=S)


def test_emit_posteriors_and_ranges_match_jax(lattice_case):
    c = lattice_case
    post = pl.emit_posteriors(*_t(c["null"], c["emit"], c["t_lens"], c["u_lens"]))
    np.testing.assert_allclose(post.numpy(), c["post"], atol=2e-5)
    ranges = pl.prune_ranges(post, *_t(c["t_lens"], c["u_lens"]), c["S"])
    np.testing.assert_array_equal(ranges.numpy(), c["ranges"])


def test_simple_ranges_from_the_backward_equal_emit_posteriors(lattice_case):
    """Under a gradient the ranges come from the simple lattice's backward;
    its emit gradient is minus ``emit_posteriors``' value, so the ranges are
    the same integers as JAX's."""
    c = lattice_case
    null, emit = (torch.tensor(x).requires_grad_() for x in (c["null"], c["emit"]))
    t_lens, u_lens = _t(c["t_lens"], c["u_lens"])
    simple = tl.rnnt_lattice(null, emit, t_lens, u_lens)
    (g_emit,) = torch.autograd.grad(simple.sum(), emit, retain_graph=True)
    np.testing.assert_allclose(-g_emit.numpy(), c["post"], atol=2e-5)
    got = pl.simple_ranges(simple, null, emit, t_lens, u_lens, c["S"])
    np.testing.assert_array_equal(got.numpy(), c["ranges"])
    with torch.no_grad():
        plain = pl.simple_ranges(tl.rnnt_lattice(null, emit, t_lens, u_lens), null, emit,
                                 t_lens, u_lens, c["S"])
    np.testing.assert_array_equal(plain.numpy(), c["ranges"])


def test_banded_lattice_loss_and_gradients_match_jax(lattice_case):
    c = lattice_case
    nb, eb = (torch.from_numpy(x).requires_grad_() for x in (c["nb"], c["eb"]))
    ranges, t_lens, u_lens = _t(c["ranges"].astype(np.int64), c["t_lens"], c["u_lens"])
    loss = pl.banded_rnnt_lattice(nb, eb, ranges, t_lens, u_lens)
    np.testing.assert_allclose(loss.detach().numpy(), c["loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, (nb, eb), torch.from_numpy(c["ct"]))
    for a, b in zip(grads, c["grads"]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


def _objective_inputs(H, K=13, seed=5):
    rng = np.random.default_rng(seed)
    B, T, U = 2, 7, 4
    labels, t_lens, u_lens = _case(rng, B=B, T=T, U=U, K=K)
    f = rng.normal(size=(B, T, H)).astype(np.float32) * 0.5
    g = rng.normal(size=(B, U + 1, H)).astype(np.float32) * 0.5
    w = rng.normal(size=(K, H)).astype(np.float32) * 0.3
    b = rng.normal(size=(K,)).astype(np.float32) * 0.1
    heads = jax.tree.map(np.asarray, jpl.init_simple_params(jax.random.PRNGKey(0), H, K))
    ct = np.asarray([1.0, 0.5], np.float32)
    return f, g, w, b, heads, labels, t_lens, u_lens, ct


OBJECTIVES = {"plain-H48": 48, "fused-H128": 128}


@pytest.fixture(scope="module", params=list(OBJECTIVES))
def objective(request):
    H = OBJECTIVES[request.param]
    f, g, w, b, heads, labels, t_lens, u_lens, ct = _objective_inputs(H)
    K = w.shape[0]
    mods = jtl.LossModifiers(**MODS["all"])
    fused = pj.fused_joint_lse

    def loss(f, g, w, b, heads):
        return jpl.pruned_transducer_loss_from_fg(
            f, g, w, b, heads, jnp.asarray(labels), jnp.asarray(t_lens), jnp.asarray(u_lens),
            K - 1, mods, prune_range=3, simple_scale=0.5)

    with pytest.MonkeyPatch.context() as mp:
        # the fused joint in interpret mode on the CPU
        mp.setattr(pj, "fused_joint_lse",
                   lambda h, w, b, lab, blank, interpret=False: fused(h, w, b, lab, blank, True))
        val, grads = jax.jit(lambda *a: jax.value_and_grad(
            lambda *x: jnp.sum(loss(*x) * ct), argnums=(0, 1, 2, 3, 4))(*a))(
            *map(jnp.asarray, (f, g, w, b)), jax.tree.map(jnp.asarray, heads))
        val = jax.jit(loss)(*map(jnp.asarray, (f, g, w, b)), jax.tree.map(jnp.asarray, heads))
    return (request.param, (f, g, w, b, heads, labels, t_lens, u_lens, ct), np.asarray(val),
            jax.tree.map(np.asarray, grads))


def test_pruned_objective_and_gradients_match_jax(objective):
    name, (f, g, w, b, heads, labels, t_lens, u_lens, ct), want, want_grads = objective
    K = w.shape[0]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (f, g, w, b)]
    th = {k: {n: torch.tensor(v[n]).requires_grad_() for n in ("w", "b")}
          for k, v in heads.items()}
    mods = tl.LossModifiers(**MODS["all"])
    got = pl.pruned_transducer_loss_from_fg(*leaves, th, *_t(labels, t_lens, u_lens), K - 1,
                                            mods, prune_range=3, simple_scale=0.5)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    head_leaves = [th[k][n] for k in ("simple_am", "simple_lm") for n in ("w", "b")]
    grads = torch.autograd.grad(got, leaves + head_leaves, torch.from_numpy(ct))
    wants = list(want_grads[:4]) + [want_grads[4][k][n] for k in ("simple_am", "simple_lm")
                                    for n in ("w", "b")]
    names = ["f", "g", "w", "b", "am.w", "am.b", "lm.w", "lm.b"]
    for n, a, e in zip(names, grads, wants):
        np.testing.assert_allclose(a.numpy(), e, atol=1e-3, rtol=1e-3, err_msg=f"{name} {n}")


@pytest.mark.parametrize("mods", list(MODS))
def test_full_band_equals_the_dense_loss(mods):
    """prune_range >= U + 1 and simple_scale 0: the port's pruned objective
    is its dense fused loss, value and gradients in f, g, w, b (both on the
    fused joint: Hj = 128)."""
    f, g, w, b, heads, labels, t_lens, u_lens, ct = _objective_inputs(128, K=11, seed=6)
    K = w.shape[0]
    m = tl.LossModifiers(**MODS[mods])
    th = {k: {n: torch.tensor(v[n]) for n in ("w", "b")} for k, v in heads.items()}
    out = []
    for pruned in (False, True):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (f, g, w, b)]
        ints = _t(labels, t_lens, u_lens)
        if pruned:
            loss = pl.pruned_transducer_loss_from_fg(*leaves, th, *ints, K - 1, m,
                                                     prune_range=labels.shape[1] + 1,
                                                     simple_scale=0.0)
        else:
            loss = tl.transducer_loss_from_fg(*leaves, *ints, K - 1, m)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves, torch.from_numpy(ct))))
    (dense, gd), (pruned, gp) = out
    np.testing.assert_allclose(pruned.numpy(), dense.numpy(), rtol=1e-5)
    for a, e in zip(gp, gd):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=2e-5)


def test_init_simple_params_shapes_and_scale():
    heads = pl.init_simple_params(torch.Generator().manual_seed(0), 16, 11)
    for k in ("simple_am", "simple_lm"):
        w, b = heads[k]["w"], heads[k]["b"]
        assert w.shape == (11, 16) and b.shape == (11,) and w.requires_grad and b.requires_grad
        w = w.detach()
        assert float(w.abs().max()) <= 0.25 and not b.any()
