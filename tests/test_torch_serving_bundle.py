"""The port's serving-bundle writer (``caiman_asr_tpu_torch/export/
serving_bundle.py``) and schema gate (``export/model_schema.py``) against
the JAX package's: from one checkpoint both write the same arrays and the
same meta, each package loads the other's bundle, and the gates (the
mel-normalisation ramp, the model schema) refuse alike."""

import json

import jax
import numpy as np
import pytest

from caiman_asr_tpu.export import model_schema as jax_schema
from caiman_asr_tpu.export import serving_bundle as jax_bundle
from caiman_asr_tpu.export.checkpointer import save_checkpoint as jax_save
from caiman_asr_tpu.models.rnnt import RNNT, RNNTModelConfig
from caiman_asr_tpu_torch.export import model_schema, serving_bundle

MINI_YAML = """
tokenizer:
  sentpiece_model: {spm}
  sampling: 0.05
rnnt:
  in_feats: 8
  enc_n_hid: 8
  enc_pre_rnn_layers: 1
  enc_post_rnn_layers: 1
  enc_dropout: 0.1
  pred_n_hid: 8
  pred_rnn_layers: 1
  joint_n_hid: 8
  forget_gate_bias: 1.0
  custom_lstm: true
ngram:
  ngram_path: {ngram_dir}
  scale_factor: 0.25
"""


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundle")
    model = RNNT(RNNTModelConfig(in_feats=8, enc_n_hid=8, enc_pre_rnn_layers=1,
                                 enc_post_rnn_layers=1, pred_n_hid=8, pred_rnn_layers=1,
                                 joint_n_hid=8), n_classes=6)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    ema = jax.tree.map(lambda a: a + np.float32(0.5), params)
    with_heads = dict(params, simple_am={"w": np.ones((6, 8), np.float32)},
                      simple_lm={"w": np.ones((6, 8), np.float32)})
    meta = {"logmel_norm_weight": 1.0, "step": 10, "best_wer": 0.2,
            "tokenizer_kw": {"labels": ["a"], "sampling": 0.05}}
    jax_save(root / "ema.npz", params, ema, None, meta)
    jax_save(root / "params.npz", with_heads, None, None, meta)
    jax_save(root / "ramp.npz", params, None, None, {"logmel_norm_weight": 0.5})
    jax_save(root / "noramp.npz", params, None, None, {})
    spm = root / "tok.model"
    spm.write_bytes(b"\x0a\x05\x0a\x01a\x10\x01")
    (root / "ngram").mkdir()
    (root / "ngram" / "ngram.arpa").write_text("\\data\\\nngram 1=1\n\n\\1-grams:\n-1.0 a\n\n\\end\\\n")
    cfg = root / "cfg.yaml"
    cfg.write_text(MINI_YAML.format(spm=spm, ngram_dir=root / "ngram"))
    stats = root / "stats.npz"
    rng = np.random.default_rng(0)
    np.savez(stats, melmeans=rng.normal(size=80).astype(np.float32),
             melvars=rng.random(80).astype(np.float32) + 0.5)
    return root


def _load_both(path):
    return serving_bundle.load_serving_bundle(path), jax_bundle.load_serving_bundle(path)


@pytest.mark.parametrize("ckpt, kw", [
    ("ema.npz", {}),
    ("ema.npz", dict(use_ema=False)),
    ("params.npz", dict(ngram_scale=0.5)),
    ("ema.npz", dict(sentencepiece_path=None, ngram_path="none")),
])
def test_bundles_match_jax(ckpts, tmp_path, ckpt, kw):
    kw = dict(kw)
    if kw.get("ngram_path") == "none":
        kw["ngram_path"] = str(tmp_path / "missing.arpa")
    args = (ckpts / ckpt, ckpts / "cfg.yaml")
    common = dict(mel_stats_path=ckpts / "stats.npz", skip_state_dict_check=True, **kw)
    serving_bundle.create_serving_bundle(*args, tmp_path / "port.npz", **common)
    jax_bundle.create_serving_bundle(*args, tmp_path / "jax.npz", **common)
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        assert "weights/simple_am/w" not in got.files
        for k in want.files:
            if k == "bundle_meta":
                assert json.loads(bytes(got[k])) == json.loads(bytes(want[k]))
            else:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # each package loads the other's bundle to the same tree
    for path in (tmp_path / "port.npz", tmp_path / "jax.npz"):
        (pw, pe, pm), (jw, je, jm) = _load_both(path)
        assert pm == jm and sorted(pe) == sorted(je)
        assert jax.tree.structure(pw) == jax.tree.structure(jw)
        for a, b in zip(jax.tree.leaves(pw), jax.tree.leaves(jw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ckpt", ["ramp.npz", "noramp.npz"])
def test_the_ramp_gate_refuses_alike(ckpts, tmp_path, ckpt):
    for mod in (serving_bundle, jax_bundle):
        with pytest.raises(ValueError, match="logmel_norm_weight"):
            mod.create_serving_bundle(ckpts / ckpt, ckpts / "cfg.yaml", tmp_path / "b.npz",
                                      skip_state_dict_check=True)


def test_the_schema_gate_refuses_alike(ckpts, tmp_path):
    for mod, err in ((serving_bundle, model_schema.CheckpointNotSupportedError),
                     (jax_bundle, jax_schema.CheckpointNotSupportedError)):
        with pytest.raises(err, match="skip_state_dict_check"):
            mod.create_serving_bundle(ckpts / "ema.npz", ckpts / "cfg.yaml", tmp_path / "b.npz")


@pytest.mark.parametrize("variant", ["base", "large"])
def test_the_schemas_are_the_jax_package_s(variant):
    """The port's schema copies equal the JAX package's; a tree of their
    shapes passes both gates, one changed shape fails both."""
    schema = json.loads((model_schema.SCHEMA_DIR / f"{variant}.json").read_text())
    assert schema == json.loads((jax_schema.SCHEMA_DIR / f"{variant}.json").read_text())
    tree = {}
    for name, shape in schema.items():
        node = tree
        *dirs, leaf = name.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = np.broadcast_to(np.float32(0), shape)
    assert model_schema.get_schema(tree) == jax_schema.get_schema(tree) == schema
    model_schema.check_schema_training(tree, False)
    jax_schema.check_schema_training(tree, False)
    tree["joint_fc"]["b"] = np.zeros(3, np.float32)
    for mod in (model_schema, jax_schema):
        with pytest.raises(mod.CheckpointNotSupportedError):
            mod.check_schema_training(tree, False)
        mod.check_schema_training(tree, True)


def test_the_cli_writes_what_jax_writes(ckpts, tmp_path):
    argv = ["--ckpt", str(ckpts / "ema.npz"), "--config", str(ckpts / "cfg.yaml"),
            "--mel_stats", str(ckpts / "stats.npz"), "--skip_state_dict_check",
            "--ngram_scale_factor", "0.75"]
    serving_bundle.main(argv + ["--output", str(tmp_path / "port.npz")])
    jax_bundle.main(argv + ["--output_ckpt", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        assert all(np.array_equal(got[k], want[k]) for k in want.files)
