"""The port imports neither JAX nor the JAX package, and its entry points
never fall back to the CPU on their own."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import caiman_asr_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "caiman_asr_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any "import jax" now raises
sys.modules["websockets"] = None  # the machine with the card may lack it
sys.modules["pyaudio"] = None  # the live client imports it only for the microphone
sys.modules["yaml"] = None  # the machine with the card has no YAML reader
import caiman_asr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(caiman_asr_tpu_torch.__path__,
                                               "caiman_asr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "caiman_asr_tpu" or m.startswith("caiman_asr_tpu."))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 15, names
# the train step's default path (random state passing, packing, SpecAugment,
# schedules, layer statistics, user tokens)
for name in ("training.rsp", "training.pack", "training.schedules", "log.layer_stats",
             "utils.user_tokens", "data.unk_handling", "ops.features", "data.featurize"):
    assert "caiman_asr_tpu_torch." + name in names, name
# validation as val.py runs it
for name in ("data.sampler", "data.loader", "evaluate.core", "evaluate.trim",
             "evaluate.state_resets", "latency.timestamp", "latency.ctm", "setup.builders",
             "args.shared", "log.logger", "val", "export.checkpointer", "models.yaml_lite"):
    assert "caiman_asr_tpu_torch." + name in names, name
# the training CLI on one process
for name in ("train", "args.train", "data.noise", "data.generate_mel_stats", "data.spm_train",
             "data.tokenizer", "export.checkpoint_averaging", "export.model_schema",
             "export.serving_bundle", "log.profiling", "synthetic_e2e", "serving.server"):
    assert "caiman_asr_tpu_torch." + name in names, name
# the rest of inference: the n-gram tools, the kenlm formats, the worker
# beam, the FPGA arithmetic
for name in ("lm.train_ngram", "lm.kenlm_binary", "lm.kenlm_trie", "lm.sweep_scale_factor",
             "decoding.parallel", "ops.quantize"):
    assert "caiman_asr_tpu_torch." + name in names, name
from caiman_asr_tpu_torch.models.config import load_config
assert load_config("configs/base-8703sp.yaml").rnnt.enc_n_hid == 1024
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|caiman_asr_tpu\b(?!_torch))", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += ["chip_smoke.py"] if pattern.search((REPO / "chip_smoke.py").read_text()) else []
    assert not offenders


def test_entry_points_without_a_device_raise_when_there_is_no_gpu(monkeypatch):
    from caiman_asr_tpu_torch import offline
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.models.config import RNNTModelConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from caiman_asr_tpu_torch.ops.logmel import LogMelFrontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RNNTModelConfig(in_feats=12, enc_n_hid=8, enc_pre_rnn_layers=1,
                          enc_post_rnn_layers=1, pred_n_hid=8, pred_rnn_layers=1,
                          joint_n_hid=8)
    from caiman_asr_tpu_torch import train
    from caiman_asr_tpu_torch.data import generate_mel_stats

    for entry in (lambda: RNNT(cfg, 5), LogMelFrontend, FeaturePipeline,
                  lambda: train.main(train.train_arg_parser().parse_args([])),
                  lambda: generate_mel_stats.main(["--model_config",
                                                   "configs/base-8703sp.yaml",
                                                   "--output_path", "unused.npz"])):
        with pytest.raises(RuntimeError, match="cuda"):
            entry()
    model = RNNT(cfg, 5, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        offline.transcribe(model, torch.zeros(1, 8000), torch.tensor([8000]))


def test_validation_without_a_gpu_raises_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from caiman_asr_tpu_torch import val

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = val.val_arg_parser().parse_args(
        ["--model_config", str(REPO / "configs" / "testing-1023sp.yaml"),
         "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        val.validate(args)
    assert not any(tmp_path.iterdir())  # it stopped before writing anything


def test_the_wavefront_benchmark_raises_when_there_is_no_gpu(monkeypatch):
    from caiman_asr_tpu_torch import bench_wavefront

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_wavefront.main(["-G", "2", "-B", "4", "-T", "3", "--fwd-only"])


def test_training_entry_points_raise_when_there_is_no_gpu(monkeypatch):
    from caiman_asr_tpu_torch.models.config import RNNTModelConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
    from caiman_asr_tpu_torch.training.step import (
        init_train_state, make_train_step, make_val_loss_step,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RNNTModelConfig(in_feats=12, enc_n_hid=8, enc_pre_rnn_layers=1,
                          enc_post_rnn_layers=1, pred_n_hid=8, pred_rnn_layers=1,
                          joint_n_hid=8)
    model = RNNT(cfg, 5, device="cpu")
    opt = Lamb(OptimizerConfig())
    for entry in (lambda: make_train_step(model, opt, 4), lambda: make_val_loss_step(model, 4),
                  lambda: init_train_state(model, opt)):
        with pytest.raises(RuntimeError, match="cuda"):
            entry()
    make_train_step(model, opt, 4, device="cpu")
    make_val_loss_step(model, 4, device="cpu")
    init_train_state(model, opt, device="cpu")
