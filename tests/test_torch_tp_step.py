"""The port's tensor-parallel train step (``training/step.make_train_step_tp``
over ``parallel/mesh.init_model_parallel``'s (data x model) layout) and its
shard-aware LAMB (``training/optimizer.py``) against the JAX package.

Each case spawns D * M gloo CPU ranks (``tests/test_torch_distributed.py``'s
harness; the ranks import no JAX). They start from the JAX package's
initial state (``init_train_state``, with the pruned loss's heads where the
case has them), cut into vocab shards, take one step on their data rank's
rows of the batch (JAX's contiguous blocks of the data axis), and gather the
whole state back. The parent holds it against JAX's ``make_train_step_tp``
on a mesh of the same shape over the conftest's CPU devices, on the tiny
2-layer RNN-T of ``tests/parallel/test_tp_step.py``, dropout and noise off.
Both sides store each shard's bf16 slab (the same store budget), so they
round alike.

Tolerances (fp32 compute): loss rtol 1e-5, gradient norm rtol 1e-4, state
(parameters, EMA, both moments) atol 2e-6 / rtol 1e-4: ``PERF.md`` section
2's gates for the training CLI. With the pruned loss the state's atol is
5e-5: the simple heads take bf16 operands on both sides
(``preferred_element_type`` fp32), so the part of f's and g's gradients
that flows through them is rounded to bf16 (each shard's part, before the
sum over the model group, on both sides); where the two sides' fp32 parts
differ in their last bits an element can round the other way, 2^-8 of that
part (one element of 8,192 at 2.2e-5 in these cases; every other within the
CLI gates). The replicated leaves are equal to the bit on every rank of a
model group.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.training import OptimizerConfig as JaxOptConfig
from caiman_asr_tpu.training import build_optimizer as jax_build_optimizer
from caiman_asr_tpu.training.fused_finish import extract_opt_state
from caiman_asr_tpu.training.step import BATCH_DIMS, joint_fc_pspecs
from caiman_asr_tpu.training.step import init_train_state as jax_init_train_state
from caiman_asr_tpu.training.step import make_train_step_tp as jax_make_train_step_tp
from tests.test_torch_distributed import spawn_ranks

CFG = dict(in_feats=16, enc_n_hid=32, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=16, pred_rnn_layers=1, joint_n_hid=32,
           joint_dropout=0.0, enc_dropout=0.0, pred_dropout=0.0)
K, BLANK, PRUNE = 64, 63, 3
OPT = dict(lr=1e-2, warmup_steps=1, hold_steps=100, half_life_steps=100)
SCALARS = {"delay_penalty": 0.0, "star_penalty": 0.0, "grad_noise_std": 0.0}
STATE_TOL = dict(atol=2e-6, rtol=1e-4)
# name -> (data ranks, model ranks, pruned band or 0)
CASES = {"1x2": (1, 2, 0), "2x2": (2, 2, 0), "1x2-pruned": (1, 2, PRUNE),
         "2x2-pruned": (2, 2, PRUNE)}


def _batch():
    A, B, T, U = 2, 4, 16, 6
    rng = np.random.default_rng(0)
    t_lens = rng.integers(T - 4, T + 1, (A, B)).astype(np.int32)
    u_lens = rng.integers(2, U + 1, (A, B)).astype(np.int32)
    t_lens[:, 0], u_lens[:, 0] = T, U
    return {"feats": rng.normal(size=(A, T, B, 16)).astype(np.float32),
            "feat_lens": t_lens,
            "txt": rng.integers(0, K - 2, (A, B, U)).astype(np.int32),
            "txt_lens": u_lens}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    D, M, pruned = CASES[request.param]
    devs = jax.devices()
    if len(devs) < D * M:
        pytest.skip(f"needs {D * M} devices (the conftest's CPU mesh)")
    model = JaxRNNT(JaxConfig(**CFG), K)
    opt = jax_build_optimizer(JaxOptConfig(**OPT), model.param_lr_factors())
    state = jax_init_train_state(model, opt, jax.random.PRNGKey(0), pruned_loss=pruned > 0)
    init = _np_tree(state.params)
    batch = _batch()
    mesh = Mesh(np.array(devs[:D * M]).reshape(D, M), ("data", "model"))
    pspecs = joint_fc_pspecs(state.params)
    put = lambda t: jax.device_put(t, jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs))
    tp_state = state._replace(
        params=put(state.params), ema_params=put(state.ema_params),
        opt_state=jax.device_put(state.opt_state, NamedSharding(mesh, P())),
        step=jax.device_put(state.step, NamedSharding(mesh, P())))
    batch_sh = jax.device_put(
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: NamedSharding(mesh, P(*([None] * BATCH_DIMS[k] + ["data"]
                                    + [None] * (batch[k].ndim - BATCH_DIMS[k] - 1))))
         for k in batch})
    step = jax_make_train_step_tp(model, opt, mesh, BLANK, donate=False, pruned_range=pruned)
    new, metrics = step(tp_state, batch_sh, jax.random.PRNGKey(1),
                        {k: jnp.asarray(v) for k, v in SCALARS.items()})
    adam, sched = extract_opt_state(new.opt_state)
    want = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": _np_tree(new.params), "ema": _np_tree(new.ema_params),
            "mu": _np_tree(adam.mu), "nu": _np_tree(adam.nu), "count": int(adam.count),
            "sched_count": int(sched.count), "step": int(new.step)}
    return request.param, D, M, pruned, init, batch, want


RANK_BODY = """
from caiman_asr_tpu_torch.export.from_jax import train_state_from_jax
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
from caiman_asr_tpu_torch.training.step import gather_state, make_train_step_tp, shard_state
from caiman_asr_tpu_torch.training.tree import tree_map
spec = pickle.load(open(SPEC, "rb"))
M = spec["m"]
data_rank, model_rank = mesh.init_model_parallel(M)
D = world // M
model = RNNT(RNNTModelConfig(**spec["cfg"]), spec["k"], device="cpu")
z = lambda t: {k: z(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in t.items()}
state = train_state_from_jax(model, spec["init"], spec["init"], z(spec["init"]),
                             z(spec["init"]), 0, 0, 0)
state = shard_state(state, model_rank, M)
opt = Lamb(OptimizerConfig(**spec["opt"]), model.param_lr_factors())
step = make_train_step_tp(model, opt, spec["blank"], data_group=mesh.data_group(),
                          model_group=mesh.model_group(), pruned_range=spec["pruned"],
                          device="cpu")
b = spec["batch"]
n = b["feats"].shape[2] // D
rows = slice(data_rank * n, (data_rank + 1) * n)
local = {k: torch.from_numpy(np.ascontiguousarray(v[:, :, rows] if k == "feats" else v[:, rows]))
         for k, v in b.items()}
state, m = step(state, local, None, spec["scalars"])
whole = gather_state(state, mesh.model_group())
np_tree = lambda t: tree_map(lambda x: x.detach().numpy().copy(), t)
pickle.dump({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "skipped": m["skipped"], "params": np_tree(whole.params),
             "ema": np_tree(whole.ema_params), "mu": np_tree(whole.opt_state.mu),
             "nu": np_tree(whole.opt_state.nu), "count": whole.opt_state.count,
             "sched_count": whole.opt_state.sched_count, "step": whole.step,
             "shard_shape": tuple(state.params["joint_fc"]["w"].shape)},
            open(out, "wb"))
"""


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_tp_step_matches_jax(case, tmp_path):
    name, D, M, pruned, init, batch, want = case
    spec = tmp_path / "spec.pkl"
    spec.write_bytes(pickle.dumps({"m": M, "cfg": CFG, "k": K, "blank": BLANK, "opt": OPT,
                                   "init": init, "batch": batch, "scalars": SCALARS,
                                   "pruned": pruned}))
    ranks = [pickle.loads(p.read_bytes())
             for p in spawn_ranks(RANK_BODY.replace("SPEC", repr(str(spec))), tmp_path, D * M)]
    got = ranks[0]
    assert got["shard_shape"] == (K // M, CFG["joint_n_hid"])
    assert got["skipped"] == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4, err_msg=name)
    assert (got["count"], got["sched_count"], got["step"]) == (
        want["count"], want["sched_count"], want["step"]) == (1, 1, 1)
    tol = dict(STATE_TOL, atol=5e-5) if pruned else STATE_TOL
    for tree in ("params", "ema", "mu", "nu"):
        g, w = _flat(got[tree]), _flat(want[tree])
        assert g.keys() == w.keys()
        assert any(k[0] == "simple_am" for k in g) == (pruned > 0)
        for k in g:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{name} {tree} {k}", **tol)
    # every rank ends with the same whole state, the replicated leaves to the bit
    for other in ranks[1:]:
        assert other["loss"] == got["loss"] and other["grad_norm"] == got["grad_norm"]
        for tree in ("params", "ema", "mu", "nu"):
            for k, v in _flat(other[tree]).items():
                np.testing.assert_array_equal(v, _flat(got[tree])[k], err_msg=f"{tree} {k}")


LAMB_BODY = """
from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
from caiman_asr_tpu_torch.parallel.vocab_parallel import gather_tree, shard_tree
torch.manual_seed(0)  # alike on every rank
mk = lambda: {"encoder": {"w": torch.randn(6, 5), "b": torch.randn(6)},
              "joint_fc": {"w": torch.randn(8, 5), "b": torch.randn(8) * 0.0},
              "simple_am": {"w": torch.randn(8, 5), "b": torch.randn(8)}}
params, grads = mk(), mk()
opt = Lamb(OptimizerConfig(lr=1e-2, warmup_steps=1, clip_norm=1.0))
whole_p = {k: {n: t.clone() for n, t in v.items()} for k, v in params.items()}
whole_e = {k: {n: t.clone() for n, t in v.items()} for k, v in params.items()}
st = opt.init(whole_p)
flat_g = {(k, n): t for k, v in grads.items() for n, t in v.items()}
_, norm_whole = opt.update(whole_p, whole_e, st, flat_g, True, 0.9)
mesh.init_model_parallel(world)
shard_p, shard_e = shard_tree(params, rank, world), shard_tree(params, rank, world)
sg = shard_tree(grads, rank, world)
st2 = opt.init(shard_p)
flat_sg = {(k, n): t for k, v in sg.items() for n, t in v.items()}
sharded = {p for p in flat_sg if p[0] != "encoder"}
new, norm_shard = opt.update(shard_p, shard_e, st2, flat_sg, True, 0.9, sharded=sharded,
                             group=mesh.model_group())
res = {"norms": [float(norm_whole), float(norm_shard)]}
for name, a, b in (("params", whole_p, gather_tree(shard_p, mesh.model_group())),
                   ("mu", st.mu, gather_tree(new.mu, mesh.model_group()))):
    res[name] = [(k, n, float((a[k][n] - b[k][n]).abs().max())) for k in a for n in a[k]]
pickle.dump(res, open(out, "wb"))
"""


def test_sharded_lamb_equals_the_unsharded_step(tmp_path):
    """Two model ranks, each with half of the vocab leaves: the global
    gradient norm and every updated leaf (the clip and the trust ratios on
    the whole tensors) equal one process's step on the whole tensors."""
    for res in (pickle.loads(p.read_bytes()) for p in spawn_ranks(LAMB_BODY, tmp_path, 2)):
        np.testing.assert_allclose(*res["norms"], rtol=1e-6)
        for tree in ("params", "mu"):
            for k, n, diff in res[tree]:
                assert diff <= 1e-6, (tree, k, n, diff)


LAYOUT_BODY = """
res = {}
for m in (1, 2, 4, 3):
    try:
        d, mr = mesh.init_model_parallel(m)
        res[m] = [d, mr, mesh.data_rank(), mesh.model_rank(), mesh.data_world(),
                  None if mesh.model_group() is None
                  else torch.distributed.get_process_group_ranks(mesh.model_group()),
                  None if mesh.data_group() is None
                  else torch.distributed.get_process_group_ranks(mesh.data_group())]
    except ValueError as e:
        res[m] = str(e)
pickle.dump(res, open(out, "wb"))
"""


def test_the_data_by_model_layout(tmp_path):
    """rank = data_i * M + model_j, as the JAX trainer reshapes its devices;
    a world that is not a multiple of M is refused."""
    ranks = [pickle.loads(p.read_bytes()) for p in spawn_ranks(LAYOUT_BODY, tmp_path, 4)]
    for r, res in enumerate(ranks):
        assert res[1][:5] == [r, 0, r, 0, 4] and res[1][5] is None
        assert res[2][:5] == [r // 2, r % 2, r // 2, r % 2, 2]
        assert res[2][5] == [2 * (r // 2), 2 * (r // 2) + 1] and res[2][6] == [r % 2, r % 2 + 2]
        assert res[4][:5] == [0, r, 0, r, 1] and res[4][5] == [0, 1, 2, 3]
        assert res[4][6] is None
        assert "multiple" in res[3]
