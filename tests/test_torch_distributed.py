"""Data parallelism in the port over ``torch.distributed``: the helpers of
``caiman_asr_tpu_torch/parallel/mesh.py``, ``evaluate/distributed.py``
(the assertions of ``tests/evaluate/test_distributed.py``), batch-norm
statistics over the global batch, and a train step of a batch-norm model
over two ranks against the JAX step on the whole batch.

Each case spawns its ranks as subprocesses on the CPU (gloo), joined
through a ``file://`` store in the test's own directory (no TCP port to
collide under ``pytest -n``). The ranks import no JAX: ``jax`` is made
unimportable in them, and the parent computes the JAX side.

Tolerances: batch-norm outputs, statistics and input gradients over two
ranks against JAX ``batch_norm_apply`` on the concatenated batch atol 1e-6
(fp32); the batch-norm step as ``tests/test_torch_batch_norm_train.py``
holds the one-process step (loss rtol 1e-5, gradient norm rtol 1e-4,
state ``BN_STATE_TOL``).
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from caiman_asr_tpu.ops.lstm import batch_norm_apply as jax_batch_norm_apply
from caiman_asr_tpu_torch.parallel.mesh import backend_rule
from tests.test_torch_batch_norm_train import jax_bn  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240

# the head of every rank's program: no JAX, the arguments, the group
RANK_HEAD = """
import json, pickle, sys
class _NoJax:  # neither JAX nor the JAX package imports in a rank
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "caiman_asr_tpu"):
            raise ImportError(f"{{name}} in a rank")
sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, {repo!r})
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import numpy as np
import torch
from caiman_asr_tpu_torch.parallel import mesh
got_rank, got_world = mesh.init_multihost(store, world, rank, device="cpu")
"""
# the tail: every rank leaves the group together (a gloo rank that exits
# with its groups alive can abort in their destructors)
RANK_TAIL = """
mesh.barrier()
mesh.shutdown()
"""


def spawn_ranks(body: str, tmp_path, world: int = 2, name: str = "rank"):
    """Run ``RANK_HEAD + body`` as ``world`` processes joined through a
    file store under ``tmp_path``; returns each rank's output path (``out``
    in the program). Fails with the ranks' output if one fails."""
    prog = RANK_HEAD.format(repo=str(REPO)) + body + RANK_TAIL
    store = f"file://{tmp_path / (name + '_store')}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    outs = [tmp_path / f"{name}{r}.out" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(r), str(world), store,
                               str(outs[r])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=REPO, env=env)
             for r in range(world)]
    logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return outs


@pytest.mark.parametrize("device_type, local_world, cards, want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 2, "nccl"),
    ("cuda", 8, 8, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 4, 2, "gloo")])
def test_backend_rule(device_type, local_world, cards, want):
    backend, why = backend_rule(device_type, local_world, cards)
    assert backend == want and why


MESH_BODY = """
res = {"rank": got_rank, "world": got_world, "mesh": [mesh.rank(), mesh.world()],
       "backend": mesh.backend(), "device": str(mesh.device())}
a = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
b = torch.tensor([rank + 0.5])
sa, sb = mesh.all_reduce_flat([a, b], mesh.group())
res["flat"] = [sa.tolist(), sb.tolist(), list(sa.shape), list(sb.shape)]
res["ints"] = {op: mesh.all_reduce_ints([rank, 10 - rank], op) for op in ("max", "min", "sum")}
res["floats"] = mesh.all_reduce_floats([0.25 * (rank + 1), 1e-17])
res["objects"] = mesh.all_gather_objects({"rank": rank, "x": "y" * (rank + 1)})
tree = [torch.full((3,), float(rank)), torch.full((2, 2), rank + 0.5),
        torch.tensor([rank + 7], dtype=torch.int64)]
mesh.broadcast_tree(tree)
res["bcast_tree"] = [t.tolist() for t in tree]
x = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2) + 100 * rank
g = mesh.gather_rows(x, 1)
res["gathered"] = g.tolist()
res["taken_back"] = bool(torch.equal(mesh.take_rows(g, 1, rank, world), x))
tok = torch.tensor([[rank], [rank + 10]])
res["gathered0"] = mesh.gather_rows(tok, 0).tolist()
v = torch.tensor([1.0 + rank, 2.0], requires_grad=True)
s = mesh.AllReduceSum.apply(v * (rank + 1), mesh.group())
(s * torch.tensor([1.0, 3.0])).sum().backward()
res["sum_fwd"], res["sum_grad"] = s.tolist(), v.grad.tolist()
mesh.barrier()

from caiman_asr_tpu_torch.evaluate.core import EvalResult
from caiman_asr_tpu_torch.evaluate.distributed import (
    aggregate_eval_results, gather_objects, sum_across_processes, sync_wer_across_processes)
res["gather_objects"] = gather_objects({"rank": rank, "hyps": ["x"] * (rank + 1)})
res["sync_wer"] = sync_wer_across_processes(2 if rank == 0 else 1, 10 if rank == 0 else 30)
res["sum"] = sum_across_processes(0.1 * (rank + 1))
local = EvalResult(wer=0.0, scores=2 if rank == 0 else 1, num_words=10 if rank == 0 else 30,
                   loss=1.0 if rank == 0 else 3.0, hyps=[f"h{rank}"], refs=[f"r{rank}"],
                   fnames=[f"f{rank}"], timestamps=[[rank]], word_timestamps=[f"w{rank}"],
                   terminations=[f"t{rank}"])
g = aggregate_eval_results(local, loss_count=2.0)
res["aggregate"] = {k: getattr(g, k) for k in ("wer", "scores", "num_words", "loss", "hyps",
                                               "refs", "fnames", "timestamps",
                                               "word_timestamps", "terminations")}
mesh.shutdown()
res["after_shutdown"] = [mesh.rank(), mesh.world(), mesh.backend()]
json.dump(res, open(out, "w"))
"""


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    return [json.loads(p.read_text()) for p in spawn_ranks(MESH_BODY, tmp)]


def test_ranks_join_over_gloo_on_the_cpu(mesh_run):
    for r, res in enumerate(mesh_run):
        assert res["rank"] == r and res["world"] == 2 and res["mesh"] == [r, 2]
        assert res["backend"] == "gloo" and res["device"] == "cpu"
        assert res["after_shutdown"] == [0, 1, None]


def test_all_reduce_flat_sums_in_shape(mesh_run):
    for res in mesh_run:
        sa, sb, shape_a, shape_b = res["flat"]
        np.testing.assert_array_equal(sa, np.arange(6).reshape(2, 3) * 3.0)
        assert sb == [2.0] and shape_a == [2, 3] and shape_b == [1]


def test_host_scalar_collectives(mesh_run):
    for res in mesh_run:
        assert res["ints"] == {"max": [1, 10], "min": [0, 9], "sum": [1, 19]}
        assert res["floats"] == [0.75, 2e-17]  # float64 sums


def test_objects_gather_in_rank_order_and_tensors_broadcast_from_zero(mesh_run):
    for res in mesh_run:
        assert res["objects"] == [{"rank": 0, "x": "y"}, {"rank": 1, "x": "yy"}]
        assert res["bcast_tree"] == [[0.0] * 3, [[0.5, 0.5], [0.5, 0.5]], [7]]


def test_rows_gather_in_the_samplers_order(mesh_run):
    """Global row j * world + r is rank r's row j, on the batch axis of an
    (h, c) leaf [L, B, H] and of the last token [B, 1]; a rank takes its
    rows back."""
    x = [np.arange(12, dtype=np.float32).reshape(2, 3, 2) + 100 * r for r in range(2)]
    want = np.stack(x, axis=2).reshape(2, 6, 2)
    for res in mesh_run:
        np.testing.assert_array_equal(res["gathered"], want)
        assert res["taken_back"]
        assert res["gathered0"] == [[0], [1], [10], [11]]


def test_all_reduce_sum_backward_all_reduces_the_gradient(mesh_run):
    for r, res in enumerate(mesh_run):
        assert res["sum_fwd"] == [1 * 1.0 + 2 * 2.0, 2.0 + 4.0]
        assert res["sum_grad"] == [(r + 1) * 2.0, (r + 1) * 6.0]


def test_gather_objects_in_process_order(mesh_run):
    for res in mesh_run:
        objs = res["gather_objects"]
        assert [o["rank"] for o in objs] == [0, 1]
        assert [len(o["hyps"]) for o in objs] == [1, 2]


def test_sync_wer_and_sums(mesh_run):
    """rank 0 (2 errors, 10 words), rank 1 (1 error, 30 words): 3 / 40."""
    for res in mesh_run:
        assert abs(res["sync_wer"] - 3.0 / 40.0) < 1e-12
        assert abs(res["sum"] - 0.3) < 1e-12


def test_aggregate_eval_results_alike_on_every_rank(mesh_run):
    for res in mesh_run:
        g = res["aggregate"]
        assert abs(g["wer"] - 3.0 / 40.0) < 1e-12
        assert g["scores"] == 3 and g["num_words"] == 40
        assert g["hyps"] == ["h0", "h1"] and g["refs"] == ["r0", "r1"]
        assert g["fnames"] == ["f0", "f1"] and g["timestamps"] == [[0], [1]]
        assert g["word_timestamps"] == ["w0", "w1"] and g["terminations"] == ["t0", "t1"]
        assert abs(g["loss"] - 2.0) < 1e-12  # (1 * 2 + 3 * 2) / 4
    assert mesh_run[0]["aggregate"] == mesh_run[1]["aggregate"]


def test_one_process_returns_its_own_result():
    from caiman_asr_tpu_torch.evaluate.core import EvalResult
    from caiman_asr_tpu_torch.evaluate.distributed import (
        aggregate_eval_results,
        gather_objects,
        sync_wer_across_processes,
    )

    r = EvalResult(wer=0.5, scores=1, num_words=2, loss=None, hyps=["a"])
    assert aggregate_eval_results(r, 3.0) is r
    assert gather_objects({"a": 1}) == [{"a": 1}]
    assert sync_wer_across_processes(1, 4) == 0.25


BN_BODY = """
from caiman_asr_tpu_torch.ops.lstm import batch_norm_apply, batch_norm_group
z = np.load(sys.argv[5])
bn = {k: torch.from_numpy(z[k]).requires_grad_(k in ("scale", "bias"))
      for k in ("scale", "bias", "mean", "var")}
y = torch.from_numpy(np.ascontiguousarray(z["y"][:, rank::world])).requires_grad_(True)
ct = torch.from_numpy(np.ascontiguousarray(z["ct"][:, rank::world]))
updates = []
with batch_norm_group(mesh.group()):
    normed = batch_norm_apply(bn, y, True, updates)
    (normed * ct).sum().backward()
(mean, var), = updates
np.savez(out, out=normed.detach().numpy(), mean=mean.numpy(), var=var.numpy(),
         dy=y.grad.numpy(), dscale=bn["scale"].grad.numpy(), dbias=bn["bias"].grad.numpy())
"""


@pytest.mark.parametrize("world", [2, 3])
def test_batch_norm_over_ranks_matches_jax_on_the_whole_batch(tmp_path, world):
    """Each rank holds batch[:, r::world]; the output, the statistics and the
    input gradient of each rank's rows equal JAX's on the concatenated
    batch, and the ranks' parameter gradients sum to JAX's."""
    T, B, H = 7, 6, 16
    rng = np.random.default_rng(world)
    # an LSTM layer's output, which batch-norm normalises: within (-1, 1)
    y = np.tanh(rng.normal(size=(T, B, H)) * 1.5 + 0.3).astype(np.float32)
    ct = rng.normal(size=(T, B, H)).astype(np.float32)
    bn = {"scale": rng.normal(size=H).astype(np.float32),
          "bias": rng.normal(size=H).astype(np.float32),
          "mean": rng.normal(size=H).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, size=H).astype(np.float32)}
    np.savez(tmp_path / "in.npz", y=y, ct=ct, **bn)

    def f(y, scale, bias):
        updates = []
        out = jax_batch_norm_apply(dict(bn, scale=scale, bias=bias), y, True, updates)
        return out, updates[0]

    (want, (jmean, jvar)), vjp = jax.vjp(f, jnp.asarray(y), jnp.asarray(bn["scale"]),
                                         jnp.asarray(bn["bias"]))
    dy, dscale, dbias = vjp((jnp.asarray(ct), (jnp.zeros(H), jnp.zeros(H))))
    body = BN_BODY.replace("sys.argv[5]", repr(str(tmp_path / "in.npz")))
    outs = [np.load(p, allow_pickle=False) for p in
            (Path(str(o) + ".npz") for o in spawn_ranks(body, tmp_path, world))]
    tol = dict(atol=1e-6, rtol=0)
    for r, got in enumerate(outs):
        np.testing.assert_allclose(got["out"], np.asarray(want)[:, r::world], **tol)
        np.testing.assert_allclose(got["mean"], np.asarray(jmean), **tol)
        np.testing.assert_allclose(got["var"], np.asarray(jvar), **tol)
        np.testing.assert_allclose(got["dy"], np.asarray(dy)[:, r::world], **tol)
    np.testing.assert_allclose(sum(g["dscale"] for g in outs), np.asarray(dscale), atol=1e-5)
    np.testing.assert_allclose(sum(g["dbias"] for g in outs), np.asarray(dbias), atol=1e-5)


BN_STEP_BODY = """
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
from caiman_asr_tpu_torch.training.step import init_train_state, make_train_step
from caiman_asr_tpu_torch.training.tree import tree_map
spec = pickle.load(open(sys.argv[5], "rb"))
model = load_jax_params(RNNT(RNNTModelConfig(**spec["cfg"]), 12, device="cpu"), spec["params"])
opt = Lamb(OptimizerConfig(**spec["opt"]), model.param_lr_factors())
step = make_train_step(model, opt, 11, group=mesh.group(), device="cpu")
state = init_train_state(model, opt, device="cpu")
metrics = []
for b in spec["batches"]:
    local = {k: torch.from_numpy(np.ascontiguousarray(v[:, :, rank::world] if k == "feats"
                                                      else v[:, rank::world]))
             for k, v in b.items()}
    state, m = step(state, local, None, spec["scalars"])
    metrics.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "skipped": m["skipped"]})
np_tree = lambda t: tree_map(lambda x: x.detach().numpy().copy(), t)
pickle.dump({"metrics": metrics, "params": np_tree(state.params),
             "ema": np_tree(state.ema_params), "mu": np_tree(state.opt_state.mu),
             "nu": np_tree(state.opt_state.nu), "count": state.opt_state.count,
             "sched_count": state.opt_state.sched_count, "step": state.step},
            open(out, "wb"))
"""


def test_batch_norm_train_step_over_two_ranks_matches_jax(jax_bn, tmp_path):
    """Two ranks, each with half of every microbatch's rows, take JAX's two
    steps of a batch-norm model: the loss and gradient norm of each step,
    the running statistics, the parameters, EMA and moments after both,
    and the ranks equal to each other to the bit."""
    from caiman_asr_tpu_torch.export.from_jax import train_state_from_jax
    from caiman_asr_tpu_torch.models.config import RNNTModelConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from tests.test_torch_batch_norm_train import BN, BN_STATE_TOL, _assert_stats_close
    from tests.test_torch_train_step import OPT, SCALARS, assert_state_close

    jmodel, batches, jstates, jmetrics = jax_bn
    spec = tmp_path / "spec.pkl"
    spec.write_bytes(pickle.dumps({
        "cfg": BN, "opt": OPT, "scalars": SCALARS, "batches": batches,
        "params": jax.tree.map(np.asarray, jstates[0].params)}))
    body = BN_STEP_BODY.replace("sys.argv[5]", repr(str(spec)))
    ranks = [pickle.loads(p.read_bytes()) for p in spawn_ranks(body, tmp_path)]
    for got in ranks:
        for m, jm in zip(got["metrics"], jmetrics):
            np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-4)
            assert m["skipped"] == jm["skipped"] == 0
        model = RNNT(RNNTModelConfig(**BN), 12, device="cpu")
        state = train_state_from_jax(model, got["params"], got["ema"], got["mu"], got["nu"],
                                     got["count"], got["sched_count"], got["step"])
        _assert_stats_close(model, state, jmodel, jstates[-1])
        assert_state_close(state, jstates[-1], BN_STATE_TOL)
    flat = [jax.tree_util.tree_leaves({k: r[k] for k in ("params", "ema", "mu", "nu")})
            for r in ranks]
    assert all(np.array_equal(a, b) for a, b in zip(*flat))
