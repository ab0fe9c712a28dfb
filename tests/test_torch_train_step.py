"""The port's train step, validation loss and learning-rate schedule
(``caiman_asr_tpu_torch/training/``) against the JAX package's, from the
same parameters and batches made with numpy from a seed.

The JAX step runs its fused joint route (the Pallas kernels in interpret
mode, as the JAX package's own kernel tests run them on the CPU), which is
the route it takes on a TPU. Every test that steps runs once per joint
route, both packages forced onto it through the same policy attributes: the
bf16 u = exp(z) slab with the two-kernel backward (the default at this
size), the int8 slab with its fused backward, no slab with the fused
backward, with the rechunked backward and with the per-pass recompute, and
the hybrid split (the slab over the first 1,024 classes, the recompute over
the rest); so both sides round the same way. The tiny model is
``tests/training/test_step.py``'s, with dropout 0 so that no random mask
enters; on every route but the first it is large-shaped (the predictor half
the encoder's width, ``joint_net_lr_factor`` 0.243 as
``configs/large-17407sp.yaml``), and on the hybrid split it has 1,100
classes, since a split needs more than one vocab tile.

Tolerances (fp32 compute): loss rtol 1e-5 and gradient norm rtol 1e-4 (the
same arithmetic, sums in another order); parameters, EMA and moments atol
2e-6 / rtol 1e-4 — one LAMB step moves a parameter by about lr = 5e-3, and
a gradient that differs in its last bits moves the Adam direction g/|g|
by as little. On the int8 route atol 1e-5: a slab entry at a rounding
boundary may fall the other way on the two sides and move a softmax
numerator by 1/127 of its row's maximum.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import caiman_asr_tpu.ops.pallas_joint as pj
import caiman_asr_tpu.ops.transducer_loss as jtl
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.training import OptimizerConfig as JaxOptConfig
from caiman_asr_tpu.training import build_optimizer as jax_build_optimizer
from caiman_asr_tpu.training.fused_finish import extract_opt_state
from caiman_asr_tpu.training.lr import lr_schedule as jax_lr_schedule
from caiman_asr_tpu.training.step import init_train_state as jax_init_train_state
from caiman_asr_tpu.training.step import make_train_step as jax_make_train_step
from caiman_asr_tpu.training.step import make_val_loss_step as jax_make_val_loss_step
from caiman_asr_tpu_torch.export.from_jax import load_jax_params, train_state_from_jax
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops import joint_kernel as jk
from caiman_asr_tpu_torch.training.lr import lr_schedule
from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
from caiman_asr_tpu_torch.training.step import (
    init_train_state, make_train_step, make_val_loss_step,
)
from caiman_asr_tpu_torch.training.tree import tree_items

N_CLASSES = 12
BLANK = N_CLASSES - 1
TINY = dict(in_feats=8, enc_n_hid=16, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
            enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=1, joint_n_hid=16,
            enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
OPT = dict(lr=1e-2, warmup_steps=1, hold_steps=100, half_life_steps=100)
SCALARS = {"delay_penalty": 0.0, "star_penalty": 0.0, "grad_noise_std": 0.0}
STATE_TOL = dict(atol=2e-6, rtol=1e-4)
LARGE_SHAPED = dict(TINY, joint_net_lr_factor=0.243)
ROWS = 8 * 6 * 5  # B * T' * (U + 1) of a microbatch: one row tile of 1,024
# the policy attributes (of either package's joint module) as they are by default
DEFAULTS = dict(Z_STORE_LIMIT_BYTES=None, _ZSTORE_DTYPE="auto", FUSED_BWD="auto",
                RECHUNK_LIMIT_BYTES=512 << 20, Z_STORE_PARTIAL=False)
# route -> (model config, classes, policy attributes, the backward, state tolerance)
ROUTES = {
    "bf16-slab": (TINY, N_CLASSES, {}, "K5-A + K5-B", STATE_TOL),
    "int8-fused": (LARGE_SHAPED, N_CLASSES,
                   dict(Z_STORE_LIMIT_BYTES=1 << 62, _ZSTORE_DTYPE="i8", FUSED_BWD=True),
                   "K7-fused-u8", dict(atol=1e-5, rtol=1e-4)),
    "no-slab-fused": (LARGE_SHAPED, N_CLASSES, dict(Z_STORE_LIMIT_BYTES=0, FUSED_BWD=True),
                      "K6-fused", STATE_TOL),
    "rechunk": (LARGE_SHAPED, N_CLASSES, dict(Z_STORE_LIMIT_BYTES=0, FUSED_BWD=False),
                "K6-derive-a + K5-B", STATE_TOL),
    "recompute": (LARGE_SHAPED, N_CLASSES,
                  dict(Z_STORE_LIMIT_BYTES=0, FUSED_BWD=False, RECHUNK_LIMIT_BYTES=0),
                  "K4-A + K4-B", STATE_TOL),
    # a budget of one 1,024-wide vocab tile of the two that 1,100 classes pad to
    "hybrid": (LARGE_SHAPED, 1100,
               dict(Z_STORE_LIMIT_BYTES=1024 * 2 * 1024, Z_STORE_PARTIAL=True),
               "K5-A + K5-B over [0, 1024) and K4-A + K4-B over [1024, 1100) "
               "(the hybrid split)", STATE_TOL),
}


def classes(route):
    return ROUTES[route][1]


@contextlib.contextmanager
def on_route(route, mod):
    """Force ``mod`` (either package's joint module) onto ``route``."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in {**DEFAULTS, **ROUTES[route][2]}.items():
            mp.setattr(mod, name, value)
        yield


@contextlib.contextmanager
def jax_fused_joint(route="bf16-slab"):
    """Route the JAX loss through its fused Pallas joint, in interpret mode,
    on ``route``."""
    fused = pj.fused_joint_lse
    with on_route(route, pj), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtl, "_fused_joint_ok", lambda H: True)
        mp.setattr(pj, "fused_joint_lse",
                   lambda h, w, b, labels, blank, interpret=False: fused(h, w, b, labels,
                                                                          blank, True))
        yield


def make_batch(rng, n_classes=N_CLASSES, A=2, B=8, T=12, U=4):
    lens_t = rng.integers(T - 4, T + 1, (A, B)).astype(np.int32)
    lens_t[:, 0] = T
    lens_u = rng.integers(1, U + 1, (A, B)).astype(np.int32)
    lens_u[:, 0] = U
    return {
        "feats": rng.normal(size=(A, T, B, 8)).astype(np.float32),
        "feat_lens": lens_t,
        "txt": rng.integers(0, n_classes - 1, (A, B, U)).astype(np.int32),
        "txt_lens": lens_u,
    }


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    return request.param


@pytest.fixture
def port_route(route):
    """The port on the fixture's route for the length of a test."""
    with on_route(route, jk):
        assert jk.store_plan(ROWS, 16, classes(route))["backward"] == ROUTES[route][3]
        yield route


@pytest.fixture(scope="module")
def jax_side(route):
    n_classes = classes(route)
    model = JaxRNNT(JaxConfig(**ROUTES[route][0]), n_classes)
    opt = jax_build_optimizer(JaxOptConfig(**OPT), model.param_lr_factors())
    state = jax_init_train_state(model, opt, jax.random.PRNGKey(0))
    with jax_fused_joint(route):
        step = jax_make_train_step(model, opt, n_classes - 1, donate=False)
        batches = [make_batch(np.random.default_rng(s), n_classes) for s in (1, 2)]
        states, metrics = [state], []
        for b in batches:
            s, m = step(states[-1], to_jax(b), jax.random.PRNGKey(0), SCALARS)
            states.append(s)
            metrics.append({k: float(v) for k, v in m.items()})
        val = jax_make_val_loss_step(model, n_classes - 1)
        vb = make_batch(np.random.default_rng(3), n_classes, A=1)
        val_out = val(state.params, {k: jnp.asarray(v[0]) for k, v in vb.items()})
    return model, opt, step, batches, states, metrics, vb, [float(x) for x in val_out]


def new_model(route="bf16-slab"):
    return RNNT(RNNTModelConfig(**ROUTES[route][0]), classes(route), device="cpu")


def port_model(params, route="bf16-slab"):
    return load_jax_params(new_model(route), jax.tree.map(np.asarray, params))


def port_step(model):
    opt = Lamb(OptimizerConfig(**OPT), model.param_lr_factors())
    return opt, make_train_step(model, opt, model.n_classes - 1, device="cpu")


def _np(tree):
    return {path: leaf.detach().numpy() for path, leaf in tree_items(tree)}


def _jax_leaves(tree):
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out[prefix + (k,)] = np.asarray(v)

    walk(tree, ())
    return out


def assert_state_close(port_state, jax_state, tol=STATE_TOL):
    adam, sched = extract_opt_state(jax_state.opt_state)
    pairs = [(port_state.params, jax_state.params), (port_state.ema_params, jax_state.ema_params),
             (port_state.opt_state.mu, adam.mu), (port_state.opt_state.nu, adam.nu)]
    for got_tree, want_tree in pairs:
        got, want = _np(got_tree), _jax_leaves(want_tree)
        assert got.keys() == want.keys()
        for path in got:
            np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **tol)
    assert port_state.opt_state.count == int(adam.count)
    assert port_state.opt_state.sched_count == int(sched.count)
    assert port_state.step == int(jax_state.step)


def test_one_and_two_steps_match_jax(jax_side, port_route):
    jmodel, _, _, batches, jstates, jmetrics, _, _ = jax_side
    model = port_model(jstates[0].params, port_route)
    assert model.param_lr_factors()["joint_fc"] == ROUTES[port_route][0].get(
        "joint_net_lr_factor", 1.0)
    opt, step = port_step(model)
    state = init_train_state(model, opt, device="cpu")
    for b, js, jm in zip(batches, jstates[1:], jmetrics):
        state, m = step(state, to_torch(b), None, SCALARS)
        np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-4)
        assert m["skipped"] == jm["skipped"] == 0
        assert_state_close(state, js, ROUTES[port_route][4])


def test_step_from_a_carried_state_matches_jax(jax_side, port_route):
    """Start from JAX's state after one step (moments, counts and EMA not
    fresh) and take the second step on both sides."""
    _, _, _, batches, jstates, jmetrics, _, _ = jax_side
    js = jstates[1]
    adam, sched = extract_opt_state(js.opt_state)
    model = new_model(port_route)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    state = train_state_from_jax(model, to_np(js.params), to_np(js.ema_params), to_np(adam.mu),
                                 to_np(adam.nu), int(adam.count), int(sched.count),
                                 int(js.step))
    assert_state_close(state, js)
    _, step = port_step(model)
    state, m = step(state, to_torch(batches[1]), None, SCALARS)
    np.testing.assert_allclose(float(m["loss"]), jmetrics[1]["loss"], rtol=1e-5)
    assert_state_close(state, jstates[2], ROUTES[port_route][4])


def test_nan_batch_is_skipped_with_the_state_unchanged(jax_side, port_route):
    _, _, _, batches, jstates, _, _, _ = jax_side
    model = port_model(jstates[0].params, port_route)
    opt, step = port_step(model)
    state = init_train_state(model, opt, device="cpu")
    before = {k: v.copy() for k, v in _np(state.params).items()}
    bad = to_torch(batches[0])
    bad["feats"][0, 0, 0, 0] = float("nan")
    new, m = step(state, bad, None, SCALARS)
    assert m["skipped"] == 1 and not np.isfinite(float(m["loss"]))
    assert new.step == 0 and new.opt_state.count == 0 and new.opt_state.sched_count == 0
    for tree, want in ((new.params, before), (new.ema_params, before)):
        for path, got in _np(tree).items():
            np.testing.assert_array_equal(got, want[path])
    for tree in (new.opt_state.mu, new.opt_state.nu):
        assert all(not a.any() for a in _np(tree).values())


def test_val_loss_matches_jax(jax_side, port_route):
    _, _, _, _, jstates, _, vb, (want_sum, want_n) = jax_side
    model = port_model(jstates[0].params, port_route)
    val = make_val_loss_step(model, model.n_classes - 1, device="cpu")
    got_sum, got_n = val(model.param_tree(), {k: torch.from_numpy(v[0]) for k, v in vb.items()})
    np.testing.assert_allclose(float(got_sum), want_sum, rtol=1e-5)
    assert got_n == want_n == 8.0


def test_val_loss_at_the_entry_shapes_equals_jax_entry():
    """base-85M at full width, B=2, T=48, U=8, all-zero inputs as
    ``__graft_entry__.entry()`` builds them: the port's validation loss
    (mean over the batch) equals JAX ``entry()``'s scalar, rtol 1e-5."""
    fn, args = graft.entry()
    want = float(fn(*args))
    params, feats, feat_lens, txt, txt_lens = args
    cfg = RNNTModelConfig(in_feats=240, enc_n_hid=1024, enc_pre_rnn_layers=2,
                          enc_post_rnn_layers=6, enc_stack_time_factor=2, pred_n_hid=512,
                          pred_rnn_layers=2, joint_n_hid=768)
    model = load_jax_params(RNNT(cfg, 8704, device="cpu"), jax.tree.map(np.asarray, params))
    val = make_val_loss_step(model, 8703, device="cpu")
    batch = {"feats": feats, "feat_lens": feat_lens, "txt": txt, "txt_lens": txt_lens}
    got_sum, n = val(model.param_tree(), {k: torch.from_numpy(np.array(v))
                                          for k, v in batch.items()})
    np.testing.assert_allclose(float(got_sum) / n, want, rtol=1e-5)


@pytest.mark.parametrize("cfg", [
    dict(initial_lr=4e-3, min_lr=4e-4, warmup_steps=1632, hold_steps=18000,
         half_life_steps=10880),
    dict(initial_lr=1e-2, min_lr=1e-3, warmup_steps=0, hold_steps=3, half_life_steps=2),
])
def test_lr_schedule_matches_jax(cfg):
    got, want = lr_schedule(**cfg), jax_lr_schedule(**cfg)
    for step in (0, 1, 2, 5, 100, 1631, 1632, 1633, 19631, 19632, 25000, 60000, 10 ** 6):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_a_pruned_step_needs_the_heads():
    """Every option of the JAX step is ported, the pruned loss too
    (tests/test_torch_pruned_loss.py, test_torch_tp_step.py): a pruned step
    on a state without the pruned loss's heads raises, and one on a state
    made with them takes its step."""
    model = RNNT(RNNTModelConfig(**TINY), N_CLASSES, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    opt = Lamb(OptimizerConfig())
    step = make_train_step(model, opt, BLANK, device="cpu", pruned_range=4)
    batch = to_torch(make_batch(np.random.default_rng(1)))
    with pytest.raises(ValueError, match="pruned"):
        step(init_train_state(model, opt, device="cpu"), batch, None, SCALARS)
    state, m = step(init_train_state(model, opt, device="cpu", pruned_loss=True), batch, None,
                    SCALARS)
    assert m["skipped"] == 0 and np.isfinite(float(m["loss"])) and state.step == 1
