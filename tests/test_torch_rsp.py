"""Random state passing: the port's ``training/rsp.py``, the carried state
through ``RNNT.enc_pred`` and the RSP train step against the JAX package's
(``caiman_asr_tpu/training/rsp.py``, ``models/rnnt.py:316-415``,
``training/step.py:169-240``), on the same parameters, batches and carried
states made with numpy from a seed. Mirrors ``tests/training/test_rsp.py``.

Tolerances: the controller's gates exactly; the encoder and predictor
outputs and the new state atol 1e-5 (fp32 sums in another order); the step
as ``tests/test_torch_train_step.py`` (loss rtol 1e-5, gradient norm rtol
1e-4, parameters, EMA and moments at its STATE_TOL), its returned state
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.models.state import EncoderState as JEncoderState
from caiman_asr_tpu.models.state import PredNetState as JPredNetState
from caiman_asr_tpu.models.state import RNNTState as JRNNTState
from caiman_asr_tpu.training import OptimizerConfig as JaxOptConfig
from caiman_asr_tpu.training import build_optimizer as jax_build_optimizer
from caiman_asr_tpu.training import rsp as jrsp
from caiman_asr_tpu.training.step import init_train_state as jax_init_train_state
from caiman_asr_tpu.training.step import make_train_step as jax_make_train_step
from caiman_asr_tpu_torch.export.from_jax import rnnt_state_from_jax
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.training import rsp
from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
from caiman_asr_tpu_torch.training.step import init_train_state, make_train_step, map_state
from tests.test_torch_train_step import (
    OPT, SCALARS, TINY, assert_state_close, jax_fused_joint, make_batch, port_model, port_step,
    to_jax, to_torch,
)

STATE_ATOL = 1e-5


@pytest.mark.parametrize("freq", [[99, 0, 1], [99, 0], [0, 1], [1, 1, 1, 1], [5, 0, 0, 2]])
@pytest.mark.parametrize("seed", [0, 7])
def test_controller_gates_match_jax(freq, seed):
    """The same gate stream over steps before and after the delay, with a
    reset after a skipped step, and fast_forward for a resumed run."""
    assert rsp.is_rsp_on(freq) == jrsp.is_rsp_on(freq)
    got, want = rsp.RSPController(freq, 6, seed), jrsp.RSPController(freq, 6, seed)
    for step in range(20):
        n = 1 + step % 4
        np.testing.assert_array_equal(got.gates(step, n), want.gates(step, n))
        if step == 11:
            got.reset()
            want.reset()
    a, b = rsp.RSPController(freq, 0, seed), jrsp.RSPController(freq, 0, seed)
    a.fast_forward(9, 3)
    b.fast_forward(9, 3)
    np.testing.assert_array_equal(a.gates(9, 3), b.gates(9, 3))
    assert (a.remaining, a.fresh) == (b.remaining, b.fresh)


def test_controller_rules():
    """tests/training/test_rsp.py's: pairs, the delay, off."""
    assert rsp.rsp_delay_default(100, 200, 50) == jrsp.rsp_delay_default(100, 200, 50) == 450
    np.testing.assert_array_equal(rsp.RSPController([0, 1], 0).gates(10, 8),
                                  [0, 1, 0, 1, 0, 1, 0, 1])
    late = rsp.RSPController([0, 1], delay=100)
    assert late.gates(5, 4).sum() == 0 and late.gates(200, 4).sum() > 0
    assert rsp.RSPController([99, 0], delay=0).gates(0, 16).sum() == 0


def _carried(seed, B, cfg):
    """A nonzero carried state as numpy arrays, in the JAX layout."""
    rng = np.random.default_rng(seed)
    hc = lambda L, H: tuple((rng.normal(size=(L, B, H)) * 0.5).astype(np.float32)
                            for _ in range(2))
    return JRNNTState(
        JEncoderState(hc(cfg["enc_pre_rnn_layers"], cfg["enc_n_hid"]),
                      hc(cfg["enc_post_rnn_layers"], cfg["enc_n_hid"])),
        JPredNetState(hc(cfg["pred_rnn_layers"], cfg["pred_n_hid"]),
                      rng.integers(0, 11, (B, 1)).astype(np.int32)))


def _leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _port_leaves(state):
    out = []
    map_state(lambda t: out.append(t.detach().numpy()), state)
    return out


def test_zero_state_and_the_state_from_jax():
    model = RNNT(RNNTModelConfig(**TINY), 12, device="cpu")
    got = rsp.zero_rnnt_state(model, 5, device="cpu")
    want = jrsp.zero_rnnt_state(JaxRNNT(JaxConfig(**TINY), 12), 5)
    for g, w in zip(_port_leaves(got), _leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any()
    carried = _carried(0, 5, TINY)
    back = rnnt_state_from_jax(jax.tree.map(np.asarray, carried))
    for g, w in zip(_port_leaves(back), _leaves(carried)):
        np.testing.assert_array_equal(g, w)


def test_enc_pred_from_a_carried_state_matches_jax():
    """Mixed gates across the batch: gate 0 zeroes a sample's h and c and
    its re-embedded last token; the new state is the encoder's at each
    last frame and the predictor's before the last label."""
    jmodel = JaxRNNT(JaxConfig(**TINY), 12)
    params = jmodel.init(jax.random.PRNGKey(3))
    model = port_model(params)
    b = make_batch(np.random.default_rng(4), A=1)
    mb = {k: v[0] for k, v in b.items()}
    carried = _carried(5, 8, TINY)
    gate = np.asarray([1, 0, 1, 1, 0, 0, 1, 0], np.float32)
    (jf, jfl), (jg, _), jstate = jmodel.enc_pred(
        params, *(jnp.asarray(mb[k]) for k in ("feats", "feat_lens", "txt", "txt_lens")),
        jax.tree.map(jnp.asarray, carried), state_gate=jnp.asarray(gate))
    (f, fl), (g, _), state = model.enc_pred(
        *(torch.from_numpy(mb[k]) for k in ("feats", "feat_lens", "txt", "txt_lens")),
        rnnt_state_from_jax(carried), state_gate=torch.from_numpy(gate))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jfl))
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), atol=STATE_ATOL)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), atol=STATE_ATOL)
    for got, want in zip(_port_leaves(state), _leaves(jstate)):
        assert got.dtype == want.dtype or got.dtype == np.int64
        np.testing.assert_allclose(got, want, atol=STATE_ATOL)
    # the gate matters: all gates 1 move the outputs
    (_, _), (g1, _), _ = model.enc_pred(
        *(torch.from_numpy(mb[k]) for k in ("feats", "feat_lens", "txt", "txt_lens")),
        rnnt_state_from_jax(carried), state_gate=torch.ones(8))
    assert not torch.allclose(g1, g)


@pytest.fixture(scope="module")
def jax_rsp():
    """JAX RSP steps over A=3 microbatches, gates [0, 1, 1], from a carried
    state: dense, packed, and with a NaN in the first microbatch."""
    model = JaxRNNT(JaxConfig(**TINY), 12)
    opt = jax_build_optimizer(JaxOptConfig(**OPT), model.param_lr_factors())
    state = jax_init_train_state(model, opt, jax.random.PRNGKey(0))
    batch = make_batch(np.random.default_rng(11), A=3)
    bad = {k: v.copy() for k, v in batch.items()}
    bad["feats"][0, 0, 0, 0] = np.nan
    nv = (-(-batch["feat_lens"] // 2) * (batch["txt_lens"] + 1)).sum(axis=1)
    cap = int(nv.max()) + 5
    carried = _carried(12, 8, TINY)
    gates = np.asarray([0, 1, 1], np.float32)
    out = {}
    with jax_fused_joint():
        step = jax_make_train_step(model, opt, 11, rsp=True, donate=False)
        for name, b, pack_to in (("dense", batch, None), ("packed", batch, cap),
                                 ("nan", bad, None)):
            s, m, rs = step(state, to_jax(b), jax.random.PRNGKey(0), SCALARS,
                            jax.tree.map(jnp.asarray, carried), gates, pack_to=pack_to)
            out[name] = (s, {k: float(v) for k, v in m.items()}, rs)
    return state, {"dense": batch, "packed": batch, "nan": bad}, cap, carried, gates, out


def _port_rsp_step(state0):
    model = port_model(state0.params)
    opt = Lamb(OptimizerConfig(**OPT), model.param_lr_factors())
    step = make_train_step(model, opt, 11, rsp=True, device="cpu")
    return init_train_state(model, opt, device="cpu"), step


@pytest.mark.parametrize("case", ["dense", "packed"])
def test_rsp_step_matches_jax(jax_rsp, case):
    state0, batches, cap, carried, gates, out = jax_rsp
    js, jm, jrs = out[case]
    state, step = _port_rsp_step(state0)
    state, m, rs = step(state, to_torch(batches[case]), None, SCALARS,
                        rnnt_state_from_jax(carried), gates,
                        pack_to=cap if case == "packed" else None)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-4)
    assert m["skipped"] == jm["skipped"] == 0
    assert_state_close(state, js)
    for got, want in zip(_port_leaves(rs), _leaves(jrs)):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=STATE_ATOL)


def test_rsp_step_gates_and_state_change_the_loss(jax_rsp):
    """The carried state enters only where gated: gates [0, 0, 0] give the
    same loss from the carried state as from a zero state, and differ from
    [0, 1, 1]."""
    state0, batches, _, carried, _, out = jax_rsp
    losses = {}
    for name, gates, st in (("off", [0, 0, 0], rnnt_state_from_jax(carried)),
                            ("zero", [0, 0, 0], None), ("on", [0, 1, 1],
                                                        rnnt_state_from_jax(carried))):
        state, step = _port_rsp_step(state0)
        if st is None:
            st = rsp.zero_rnnt_state(RNNT(RNNTModelConfig(**TINY), 12, device="cpu"), 8,
                                     device="cpu")
        _, m, _ = step(state, to_torch(batches["dense"]), None, SCALARS, st,
                       np.asarray(gates, np.float32))
        losses[name] = float(m["loss"])
    np.testing.assert_allclose(losses["on"], out["dense"][1]["loss"], rtol=1e-5)
    assert abs(losses["on"] - losses["off"]) > 1e-6
    np.testing.assert_allclose(losses["off"], losses["zero"], rtol=1e-6)


def test_a_skipped_rsp_step_returns_a_zero_state(jax_rsp):
    state0, batches, _, carried, gates, out = jax_rsp
    js, jm, jrs = out["nan"]
    assert jm["skipped"] == 1 and all(not x.any() for x in _leaves(jrs))
    state, step = _port_rsp_step(state0)
    new, m, rs = step(state, to_torch(batches["nan"]), None, SCALARS,
                      rnnt_state_from_jax(carried), gates)
    assert m["skipped"] == 1 and new.step == 0
    leaves = _port_leaves(rs)
    assert len(leaves) == len(_leaves(jrs)) and all(not x.any() for x in leaves)


def test_rsp_with_batch_norm_raises_in_both_packages():
    cfg = dict(TINY, enc_batch_norm=True)
    jmodel = JaxRNNT(JaxConfig(**cfg), 12)
    with pytest.raises(NotImplementedError):
        jax_make_train_step(jmodel, jax_build_optimizer(JaxOptConfig()), 11, rsp=True)
    model = RNNT(RNNTModelConfig(**cfg), 12, device="cpu")
    with pytest.raises(NotImplementedError, match="batch-norm"):
        make_train_step(model, Lamb(OptimizerConfig()), 11, rsp=True, device="cpu")
    make_train_step(model, Lamb(OptimizerConfig()), 11, device="cpu")


def test_an_rsp_step_without_its_state_raises():
    model = RNNT(RNNTModelConfig(**TINY), 12, device="cpu")
    opt, step = port_step(model)
    rsp_step = make_train_step(model, opt, 11, rsp=True, device="cpu")
    state = init_train_state(model, opt, device="cpu")
    with pytest.raises(ValueError, match="rnnt_state"):
        rsp_step(state, to_torch(make_batch(np.random.default_rng(0))), None, SCALARS)
