"""The port's reference ``.pt`` export and import (``caiman_asr_tpu_torch/
export/torch_export.py``, ``torch_import.py``) against the JAX package's, as
``tests/export/test_torch_export.py`` and ``test_torch_import.py`` hold
JAX's: checkpoints of JAX-initialised models (plain and batch-norm stacks),
written by JAX's checkpointer.

Tolerance: none. Conversion is renaming, so every tensor is equal to the
bit, in both directions (JAX's export read by the port, the port's by JAX's
``convert_state_dict``), and a round trip gives the ``.npz`` leaves back.
"""

import jax
import numpy as np
import pytest
import torch

from caiman_asr_tpu.export import torch_export as jex
from caiman_asr_tpu.export import torch_import as jim
from caiman_asr_tpu.export.checkpointer import save_checkpoint as jax_save
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch.export import torch_export as ex
from caiman_asr_tpu_torch.export import torch_import as im
from caiman_asr_tpu_torch.export.checkpointer import flatten_named, load_checkpoint
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT

N_CLASSES = 12
CFG = dict(in_feats=8, enc_n_hid=16, enc_pre_rnn_layers=2, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=2, joint_n_hid=12,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "batch_norm"])
def ckpt(request, tmp_path_factory):
    cfg = dict(CFG, enc_batch_norm=request.param)
    model = JaxRNNT(JaxConfig(**cfg), N_CLASSES)
    params = jax.tree.map(np.array, model.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    ema = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.01).astype(a.dtype), params)
    path = tmp_path_factory.mktemp("pt") / "ckpt.npz"
    jax_save(path, params, ema, meta={"step": 11, "epoch": 2, "best_wer": 0.25})
    return path, cfg


def _tensors_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), k


def test_export_equals_jax(ckpt, tmp_path):
    path, _ = ckpt
    got = ex.export_checkpoint(str(path), str(tmp_path / "port.pt"))
    want = jex.export_checkpoint(str(path), str(tmp_path / "jax.pt"))
    assert got == want
    p, j = (torch.load(tmp_path / f"{n}.pt", weights_only=False) for n in ("port", "jax"))
    assert {k: v for k, v in p.items() if k not in ("state_dict", "ema_state_dict",
                                                    "exported_from")} == \
        {k: v for k, v in j.items() if k not in ("state_dict", "ema_state_dict",
                                                 "exported_from")}
    for key in ("state_dict", "ema_state_dict"):
        _tensors_equal(p[key], j[key])
    assert "joint_net.2.weight" in p["state_dict"]


def test_import_equals_jax_both_ways(ckpt, tmp_path):
    """JAX's export read by the port's import, the port's export by JAX's:
    the same flat dicts, and the .npz's leaves back to the bit."""
    path, _ = ckpt
    jex.export_checkpoint(str(path), str(tmp_path / "jax.pt"))
    ex.export_checkpoint(str(path), str(tmp_path / "port.pt"))
    for pt in ("jax.pt", "port.pt"):
        sd = torch.load(tmp_path / pt, weights_only=False)["state_dict"]
        got, want = im.convert_state_dict(sd), jim.convert_state_dict(sd)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    meta = im.convert_checkpoint(str(tmp_path / "jax.pt"), str(tmp_path / "back.npz"))
    assert meta["step"] == 11 and meta["best_wer"] == 0.25
    params, ema, _, _ = load_checkpoint(path)
    back, back_ema, _, _ = load_checkpoint(tmp_path / "back.npz")
    for a, b in ((params, back), (ema, back_ema)):
        fa, fb = flatten_named(a), flatten_named(b)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
    # --use_ema_as_params
    im.main([str(tmp_path / "port.pt"), str(tmp_path / "ema.npz"), "--use_ema_as_params"])
    p2, _, _, _ = load_checkpoint(tmp_path / "ema.npz")
    fe, f2 = flatten_named(ema), flatten_named(p2)
    assert all(np.array_equal(fe[k], f2[k]) for k in fe)


def test_the_port_loads_an_exported_pt(ckpt, tmp_path):
    """``load_into`` puts the EMA (or the weights) of an exported ``.pt``
    into the port's RNNT strictly: its tensors equal those carried over
    from the .npz by export/from_jax, and it encodes alike."""
    path, cfg = ckpt
    ex.main([str(path), str(tmp_path / "m.pt")])
    params, ema, _, _ = load_checkpoint(path)
    for use_ema, tree in ((True, ema), (False, params)):
        model = RNNT(RNNTModelConfig(**cfg), N_CLASSES, device="cpu")
        info = im.load_into(model, str(tmp_path / "m.pt"), use_ema=use_ema)
        assert info == {"step": 11, "weights": "ema_state_dict" if use_ema else "state_dict"}
        want = load_jax_params(RNNT(RNNTModelConfig(**cfg), N_CLASSES, device="cpu"), tree)
        _tensors_equal(model.state_dict(), want.state_dict())
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(10, 2, 8)).astype(np.float32))
        lens = torch.tensor([10, 7])
        model.eval(), want.eval()
        assert torch.equal(model.encode(x, lens)[0], want.encode(x, lens)[0])
