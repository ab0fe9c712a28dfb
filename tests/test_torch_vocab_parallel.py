"""The port's vocab-parallel joint (``caiman_asr_tpu_torch/parallel/vocab_parallel.py``)
over 2 and 4 gloo CPU ranks against the JAX package's ``vp_joint_lse`` under
``shard_map`` on as many of the conftest's CPU devices, on the same inputs
made with numpy from a seed.

The cases: 2 shards with the blank in the last one and every column in the
slab; 4 shards with the blank in the middle of the vocabulary and a forced
split (vocab tiles of 128 and a slab budget of two of them on both sides, so
the slab holds the columns [0, 256) of each 512-wide shard and the rest are
recomputed: K5-store + K2 forward, K5-A + K4-A and K5-B + K4-B backward).
The labels fall in every shard. Each rank runs the autograd Function (whose
CPU path is the kernels' plain versions) and the plain autograd version; the
parent holds both against JAX, each rank's dW and db against its columns of
JAX's and dh whole. The ranks import no JAX.

Tolerances: the log-probabilities rtol 2e-5; dh, dW and db atol 2e-3 /
rtol 1e-3 (the slab's bf16 rounding on both sides: the JAX module's own
bound); the plain version against the kernels' path, the same.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import caiman_asr_tpu.ops.pallas_joint as pj
from caiman_asr_tpu.parallel.vocab_parallel import vp_joint_lse
from tests.test_torch_distributed import spawn_ranks

N, Hj, K = 70, 16, 2048
# name -> (shards, blank, forced split)
CASES = {"2-blank-last": (2, K - 1, False), "4-blank-mid-split": (4, K // 2 + 3, True)}
SPLIT_TILES = (1024, 128, 512, 128, 512, 128)  # _tiles(Hj) of both packages
SPLIT_LIMIT = 256 * 1024 * 2  # two 128-wide tiles of the 1,024 padded rows, bf16
GRAD_TOL = dict(atol=2e-3, rtol=1e-3)


def _data():
    rng = np.random.default_rng(7)
    return dict(h=rng.normal(size=(N, Hj)).astype(np.float32),
                w=(rng.normal(size=(Hj, K)) * 0.1).astype(np.float32),
                b=(rng.normal(size=(K,)) * 0.1).astype(np.float32),
                labels=rng.integers(0, K - 1, (N,)).astype(np.int32),
                cb=rng.normal(size=(N,)).astype(np.float32),
                cl=rng.normal(size=(N,)).astype(np.float32))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    n, blank, split = CASES[request.param]
    d = _data()
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices (the conftest's CPU mesh)")
    mesh = Mesh(np.array(devs[:n]), ("model",))
    labels, cb, cl = (jnp.asarray(d[k]) for k in ("labels", "cb", "cl"))

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P(None, "model"), P("model")),
                       out_specs=(P(), P(), P(), P(None, "model"), P("model")),
                       check_vma=False)
    def sharded(h, w, b):
        def loss(h, w, b):
            lb, ll = vp_joint_lse(h, w, b, labels, blank, "model", True)
            return jnp.sum(lb * cb) + jnp.sum(ll * cl), (lb, ll)

        (_, (lb, ll)), (dh, dw, db) = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                         has_aux=True)(h, w, b)
        return lb, ll, dh, dw, db

    with pytest.MonkeyPatch.context() as mp:
        if split:
            mp.setattr(pj, "_tiles", lambda Hj: SPLIT_TILES)
            mp.setattr(pj, "Z_STORE_LIMIT_BYTES", SPLIT_LIMIT)
            mp.setattr(pj, "Z_STORE_PARTIAL", True)
        want = [np.asarray(x) for x in jax.jit(sharded)(*(jnp.asarray(d[k])
                                                          for k in ("h", "w", "b")))]
    return request.param, n, blank, split, d, want


RANK_BODY = """
from caiman_asr_tpu_torch.ops import joint_kernel as jk
from caiman_asr_tpu_torch.parallel import vocab_parallel as vp
spec = pickle.load(open(SPEC, "rb"))
if spec["split"]:
    jk._tiles = lambda Hj: spec["tiles"]
    jk.Z_STORE_LIMIT_BYTES = spec["limit"]
    jk.Z_STORE_PARTIAL = True
d = spec["data"]
Kl = d["w"].shape[1] // world
res = {"ks": vp.store_cols(d["h"].shape[0], d["h"].shape[1], Kl)}
for name, fn in (("kernels", vp.vp_joint_lse), ("plain", vp.vp_joint_lse_plain)):
    h = torch.from_numpy(d["h"]).requires_grad_()
    w = torch.from_numpy(d["w"][:, rank * Kl:(rank + 1) * Kl].copy()).requires_grad_()
    b = torch.from_numpy(d["b"][rank * Kl:(rank + 1) * Kl].copy()).requires_grad_()
    lb, ll = fn(h, w, b, torch.from_numpy(d["labels"]), spec["blank"], mesh.group())
    loss = (lb * torch.from_numpy(d["cb"])).sum() + (ll * torch.from_numpy(d["cl"])).sum()
    dh, dw, db = torch.autograd.grad(loss, (h, w, b))
    res[name] = [x.detach().numpy() for x in (lb, ll, dh, dw, db)]
with torch.no_grad():
    lb, ll = vp.vp_joint_lse(torch.from_numpy(d["h"]), torch.from_numpy(d["w"][:, rank * Kl:
        (rank + 1) * Kl].copy()), torch.from_numpy(d["b"][rank * Kl:(rank + 1) * Kl].copy()),
        torch.from_numpy(d["labels"]), spec["blank"], mesh.group())
res["no_grad"] = [lb.numpy(), ll.numpy()]
pickle.dump(res, open(out, "wb"))
"""


def test_vp_joint_matches_jax_over_ranks(case, tmp_path):
    name, n, blank, split, d, (lb, ll, dh, dw, db) = case
    Kl = K // n
    assert len(set((d["labels"] // Kl).tolist())) == n  # labels in every shard
    spec = tmp_path / "spec.pkl"
    spec.write_bytes(pickle.dumps({"data": d, "blank": blank, "split": split,
                                   "tiles": SPLIT_TILES, "limit": SPLIT_LIMIT}))
    body = RANK_BODY.replace("SPEC", repr(str(spec)))
    ranks = [pickle.loads(p.read_bytes()) for p in spawn_ranks(body, tmp_path, n)]
    for r, res in enumerate(ranks):
        assert res["ks"] == (256 if split else Kl)
        cols = slice(r * Kl, (r + 1) * Kl)
        for route in ("kernels", "plain"):
            g_lb, g_ll, g_dh, g_dw, g_db = res[route]
            np.testing.assert_allclose(g_lb, lb, rtol=2e-5, err_msg=f"{name} {route} {r}")
            np.testing.assert_allclose(g_ll, ll, rtol=2e-5, err_msg=f"{name} {route} {r}")
            np.testing.assert_allclose(g_dh, dh, **GRAD_TOL, err_msg=f"{name} {route} {r}")
            np.testing.assert_allclose(g_dw, dw[:, cols], **GRAD_TOL,
                                       err_msg=f"{name} {route} {r}")
            np.testing.assert_allclose(g_db, db[cols], **GRAD_TOL, err_msg=f"{name} {route} {r}")
        np.testing.assert_allclose(res["no_grad"][0], lb, rtol=2e-5)
        np.testing.assert_allclose(res["no_grad"][1], ll, rtol=2e-5)


def test_shard_relative_ids():
    import torch

    from caiman_asr_tpu_torch.parallel.vocab_parallel import shard_relative_ids

    ok, rel = shard_relative_ids(torch.tensor([0, 5, 9, 10, 14, 15, -1]), 5, 5)
    assert ok.tolist() == [False, True, True, False, False, False, False]
    assert rel.tolist() == [0, 0, 4, 4, 4, 4, 0]
    assert shard_relative_ids(7, 5, 5) == (True, 2)
    assert shard_relative_ids(12, 5, 5) == (False, 4)


def test_shard_and_gather_tree_round_trip():
    """``shard_tree`` cuts the vocab leaves (and only them) into equal rows;
    gathering the shards in rank order gives the whole leaves back."""
    import torch

    from caiman_asr_tpu_torch.parallel.vocab_parallel import shard_tree

    tree = {"encoder": {"w": torch.randn(4, 3)},
            "joint_fc": {"w": torch.randn(8, 3, requires_grad=True), "b": torch.randn(8)},
            "simple_am": {"w": torch.randn(8, 3), "b": torch.randn(8)}}
    shards = [shard_tree(tree, r, 4) for r in range(4)]
    assert shards[1]["encoder"]["w"] is tree["encoder"]["w"]
    assert shards[2]["joint_fc"]["w"].shape == (2, 3) and shards[2]["joint_fc"]["w"].requires_grad
    for top in ("joint_fc", "simple_am"):
        for leaf in ("w", "b"):
            whole = torch.cat([s[top][leaf] for s in shards])
            assert torch.equal(whole, tree[top][leaf])
    with pytest.raises(ValueError, match="equal shards"):
        shard_tree(tree, 0, 3)
