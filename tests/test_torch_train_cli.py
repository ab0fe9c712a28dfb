"""The port's training CLI (``caiman_asr_tpu_torch/train.py``) against the
JAX package's ``train.main`` on a mini workspace (the eight utterances of
``tests/test_end_to_end.py``, its fixture copied), and the port's own
resume and preemption.

Against JAX both start ``--fine_tune`` from one JAX-initialised checkpoint,
with nothing random in the step: dropout 0, no SpecAugment, dither 0, no
noise, no subword sampling, ``--no_amp``; random state passing on (histories
of 1 or 3 microbatches from step 0), the packed joint on (``PACK_QUANTUM``
16 in both packages, so that the caps fall below the dense size), A=2, 4
steps, validation and checkpoints every 2. Tolerances are those
``tests/test_torch_train_step.py`` holds over steps (fp32 compute): each
step's loss rtol 1e-5 and gradient norm rtol 1e-4 against JAX's log; the
step-4 parameters, EMA and optimizer moments atol 2e-6 / rtol 1e-4; the
dev loss rtol 1e-5. Checkpoints cross both ways: the port resumes JAX's
step-2 checkpoint and JAX the port's, each giving JAX's steps 3 and 4.

The port's own resume is bit-exact with its uninterrupted run, with
dropout, SpecAugment, dither, speed perturbation, background noise and
subword sampling on (their host streams ride the checkpoint), at a
mid-epoch interrupt and at an epoch boundary past a partial group.
"""

import json
import pickle
import signal
import subprocess
import sys
import time
import wave
from pathlib import Path

import numpy as np
import pytest

from caiman_asr_tpu.args.train import train_arg_parser as jax_train_arg_parser
from caiman_asr_tpu.export.checkpointer import load_checkpoint as jax_load_checkpoint
from caiman_asr_tpu.export.checkpointer import save_checkpoint as jax_save_checkpoint
from caiman_asr_tpu_torch.args.train import train_arg_parser
from caiman_asr_tpu_torch.data.tokenizer import save_tokenizer_json, train_tokenizer
from caiman_asr_tpu_torch.export.checkpointer import flatten_named, load_checkpoint

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_NORM_RTOL, VAL_LOSS_RTOL = 1e-5, 1e-4, 1e-5
STATE_TOL = dict(atol=2e-6, rtol=1e-4)

TEXTS = [
    "the cat sat on the mat",
    "a dog barks at night",
    "she sells sea shells",
    "the quick brown fox jumps",
    "over the lazy dog again",
    "transcription of long speech",
    "hello world how are you",
    "testing one two three four",
]

# tests/test_end_to_end.py's MINI_CONFIG without SpecAugment; {train_extra}
# adds train-only augmentation for the port's own resume tests
MINI_CONFIG = """
tokenizer:
  sentpiece_model: {tok}
  labels: [" ", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m",
           "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z", "'"]
  sampling: {sampling}
input_val:
  audio_dataset: &val_dataset
    sample_rate: 16000
    trim_silence: false
    normalize_transcripts: lowercase
    standardize_wer: true
    error_rate: word
  filterbank_features: &val_features
    sample_rate: 16000
    window_size: 0.025
    window_stride: 0.01
    n_fft: 512
    n_filt: 16
    dither: {dither}
  frame_splicing: &val_splicing
    frame_stacking: 3
    frame_subsampling: 3
input_train:
  audio_dataset:
    !!merge <<: *val_dataset
    trim_silence: false
    max_duration: 20.0{train_extra}
  filterbank_features: *val_features
  frame_splicing: *val_splicing
rnnt:
  in_feats: 48
  enc_n_hid: 16
  enc_pre_rnn_layers: 1
  enc_post_rnn_layers: 1
  enc_stack_time_factor: 2
  enc_dropout: {dropout}
  pred_n_hid: 16
  pred_rnn_layers: 1
  pred_dropout: {dropout}
  joint_n_hid: 16
  joint_dropout: {dropout}
  forget_gate_bias: 1.0
grad_noise_scheduler:
  noise_level: 0.0
"""
AUGMENTED = """
    speed_perturbation:
      min_rate: 0.85
      max_rate: 1.15
      p: 1.0
  spec_augment:
    freq_masks: 1
    min_freq: 0
    max_freq: 4
    time_masks: 2
    min_time: 0
    max_time: 0.03"""


def write_wav(path, audio, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The utterances, a manifest, a tokenizer, two configs (``plain`` for
    the parity runs, ``augmented`` for the resume runs), a directory of
    noise clips and a JAX-initialised checkpoint."""
    import jax

    from caiman_asr_tpu.models.config import load_config as jax_load_config
    from caiman_asr_tpu.setup.builders import build_model as jax_build_model
    from caiman_asr_tpu.setup.builders import build_tokenizer as jax_build_tokenizer

    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    entries = []
    for i, text in enumerate(TEXTS):
        dur = 0.4 + 0.1 * i
        write_wav(root / f"utt{i}.wav", (rng.normal(size=int(16000 * dur)) * 0.1))
        entries.append({"transcript": text, "files": [{"fname": f"utt{i}.wav", "duration": dur}],
                        "original_duration": dur})
    (root / "manifest.json").write_text(json.dumps(entries))
    (root / "noise").mkdir()
    for i in range(3):
        write_wav(root / "noise" / f"n{i}.wav", rng.normal(size=12000) * 0.2)
    tok = root / "tok.json"
    save_tokenizer_json(tok, train_tokenizer(TEXTS * 4, vocab_size=48))
    plain = root / "plain.yaml"
    plain.write_text(MINI_CONFIG.format(tok=tok, sampling=0.0, dither=0.0, dropout=0.0,
                                        train_extra=""))
    augmented = root / "augmented.yaml"
    augmented.write_text(MINI_CONFIG.format(tok=tok, sampling=0.3, dither="0.00001",
                                            dropout=0.1, train_extra=AUGMENTED))
    cfg = jax_load_config(plain).cfg
    model, _ = jax_build_model(cfg, jax_build_tokenizer(cfg))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(5)))
    jax_save_checkpoint(root / "init.npz", params, params, None, {"step": 0})
    return root


def _set(args, root, config, out, **kw):
    d = dict(model_config=str(root / config), output_dir=str(out), dataset_dir=str(root),
             train_manifests=["manifest.json"], val_manifests=["manifest.json"],
             global_batch_size=4, grad_accumulation_batches=2, training_steps=4,
             val_frequency=2, save_frequency=2, log_frequency=1, prediction_frequency=4,
             val_batch_size=4, warmup_steps=2, hold_steps=2, half_life_steps=2, lr=1e-3,
             weights_init_scale=0.5, rsp_seq_len_freq=[1, 0, 1], rsp_delay=0)
    d.update(kw)
    for k, v in d.items():
        setattr(args, k, v)
    return args


def parity_args(parser, root, out, **kw):
    """The JAX-parity settings: fp32, nothing random, fine-tuning from the
    JAX-initialised checkpoint (``kw`` may replace any of them)."""
    return _set(parser().parse_args([]), root, "plain.yaml", out,
                **{**dict(no_amp=True, fine_tune=True, ckpt=str(root / "init.npz")), **kw})


def read_log(out):
    """{step: (loss, grad_norm)} of the train records, and {step: dev loss}."""
    train, dev = {}, {}
    for f in sorted(Path(out).glob("log_*.jsonl")):
        for line in f.read_text().splitlines():
            r = json.loads(line)
            if r.get("subset") == "train" and "loss" in r:
                train[r["step"][1]] = (r["loss"], r["grad_norm"])
            elif r.get("subset") == "dev_ema":
                dev[r["step"][1]] = r["loss"]
    return train, dev


@pytest.fixture(scope="module")
def packing():
    """Both packages' pack quantum cut to 16 rows: the packed joint runs."""
    import caiman_asr_tpu.training.pack as jax_pack
    import caiman_asr_tpu_torch.training.pack as port_pack

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pack, "PACK_QUANTUM", 16)
        mp.setattr(port_pack, "PACK_QUANTUM", 16)
        yield


def _jax_main(args):
    from caiman_asr_tpu import train as jax_train

    return jax_train.main(args)


def _port_main(args):
    from caiman_asr_tpu_torch import train

    return train.main(args, device="cpu")


@pytest.fixture(scope="module")
def jax_run(workspace, packing, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_out")
    _jax_main(parity_args(jax_train_arg_parser, workspace, out))
    return out


@pytest.fixture(scope="module")
def port_run(workspace, packing, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_out")
    _port_main(parity_args(train_arg_parser, workspace, out))
    return out


def assert_steps_close(got, want, steps):
    for s in steps:
        np.testing.assert_allclose(got[s][0], want[s][0], rtol=LOSS_RTOL, err_msg=f"loss {s}")
        np.testing.assert_allclose(got[s][1], want[s][1], rtol=GRAD_NORM_RTOL,
                                   err_msg=f"grad norm {s}")


def assert_checkpoints_close(got_path, want_path):
    """Parameters, EMA and optimizer leaves (counts exact), key sets."""
    got_p, got_e, got_o, _ = load_checkpoint(got_path)
    want_p, want_e, want_o, _ = jax_load_checkpoint(want_path)
    for got, want in ((got_p, want_p), (got_e, want_e)):
        got, want = flatten_named(got), flatten_named(want)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **STATE_TOL)
    assert len(got_o) == len(want_o)
    assert int(got_o[0]) == int(want_o[0]) and int(got_o[-1]) == int(want_o[-1])
    for i, (g, w) in enumerate(zip(got_o[1:-1], want_o[1:-1])):
        np.testing.assert_allclose(g, w, err_msg=f"opt/{i + 1}", **STATE_TOL)
    with np.load(got_path) as g, np.load(want_path) as w:
        assert sorted(g.files) == sorted(w.files)


def test_steps_and_checkpoints_match_jax(jax_run, port_run):
    got, got_dev = read_log(port_run)
    want, want_dev = read_log(jax_run)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    assert_steps_close(got, want, [1, 2, 3, 4])
    assert sorted(got_dev) == sorted(want_dev) == [2, 4]
    for s in got_dev:
        np.testing.assert_allclose(got_dev[s], want_dev[s], rtol=VAL_LOSS_RTOL)
    for name in ("step2.npz", "step4.npz", "last.npz", "best.npz"):
        assert_checkpoints_close(port_run / "ckpts" / name, jax_run / "ckpts" / name)
    # meta: the same fields and values, the port's host random streams beside them
    _, _, _, got_meta = load_checkpoint(port_run / "ckpts" / "last.npz")
    _, _, _, want_meta = jax_load_checkpoint(jax_run / "ckpts" / "last.npz")
    assert isinstance(got_meta.pop("_host_rng"), list)
    assert got_meta.keys() == want_meta.keys()
    np.testing.assert_allclose(got_meta.pop("best_wer"), want_meta.pop("best_wer"), rtol=1e-12)
    assert got_meta == want_meta


def test_the_port_resumes_a_jax_checkpoint(workspace, jax_run, packing, tmp_path):
    _port_main(parity_args(train_arg_parser, workspace, tmp_path, fine_tune=False,
                           resume=True, ckpt=str(jax_run / "ckpts" / "step2.npz")))
    got, _ = read_log(tmp_path)
    want, _ = read_log(jax_run)
    assert sorted(got) == [3, 4]
    assert_steps_close(got, want, [3, 4])
    assert_checkpoints_close(tmp_path / "ckpts" / "last.npz", jax_run / "ckpts" / "last.npz")


def test_jax_resumes_a_port_checkpoint(workspace, jax_run, port_run, packing, tmp_path):
    _jax_main(parity_args(jax_train_arg_parser, workspace, tmp_path, fine_tune=False,
                          resume=True, ckpt=str(port_run / "ckpts" / "step2.npz")))
    got, _ = read_log(tmp_path)
    want, _ = read_log(jax_run)
    assert sorted(got) == [3, 4]
    assert_steps_close(got, want, [3, 4])


def augmented_args(root, out, **kw):
    """The default run's randomness: bf16, dropout, SpecAugment, dither,
    speed perturbation, subword sampling, background noise from step 0,
    random state passing, the packed joint."""
    return _set(train_arg_parser().parse_args([]), root, "augmented.yaml", out,
                **{**dict(noise_dataset=str(root / "noise"), prob_background_noise=0.5,
                          noise_delay_steps=0, val_frequency=100, save_frequency=100,
                          prediction_frequency=100, training_steps=6), **kw})


@pytest.mark.parametrize("interrupt", ["mid_epoch", "epoch_tail"])
def test_resume_is_bit_exact(workspace, packing, tmp_path, interrupt):
    """``--resume`` reproduces the uninterrupted run's losses and gradient
    norms exactly. Mid-epoch: 8 utterances, microbatches of 2, A=2, so step
    3 is the first group of epoch 1. Epoch tail: A=3 leaves one microbatch
    of each epoch over, which the resumed run must make too."""
    kw = {} if interrupt == "mid_epoch" else dict(global_batch_size=6,
                                                  grad_accumulation_batches=3)
    stop = 3 if interrupt == "mid_epoch" else 2
    out_a, out_b = tmp_path / "ctl", tmp_path / "intr"
    _port_main(augmented_args(workspace, out_a, **kw))
    want, _ = read_log(out_a)
    assert sorted(want) == [1, 2, 3, 4, 5, 6]
    _port_main(augmented_args(workspace, out_b, training_steps=stop, **kw))
    _port_main(augmented_args(workspace, out_b, resume=True, **kw))
    got, _ = read_log(out_b)
    for s in range(stop + 1, 7):
        assert got[s] == want[s], (s, got[s], want[s])
    a, b = (flatten_named(load_checkpoint(o / "ckpts" / "last.npz")[1]) for o in (out_a, out_b))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_preemption_sigterm_saves_and_resumes(workspace, tmp_path):
    """SIGTERM mid-training finishes the step, saves ``last`` through the
    normal epilogue and exits 0; ``--resume`` continues from the saved
    step."""
    out = tmp_path / "out"
    spec = tmp_path / "args.json"
    spec.write_text(json.dumps(vars(augmented_args(workspace, out, training_steps=500,
                                                   val_frequency=1000,
                                                   save_frequency=1000))))
    prog = f"""
import json, sys
from argparse import Namespace
sys.path.insert(0, {str(REPO)!r})
from caiman_asr_tpu_torch import train
train.main(Namespace(**json.loads(open({str(spec)!r}).read())), device="cpu")
"""
    proc = subprocess.Popen([sys.executable, "-u", "-c", prog], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO)
    lines, deadline = [], time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if "[train] step" in line:
            proc.send_signal(signal.SIGTERM)
            break
    assert lines and "[train] step" in lines[-1], "".join(lines[-20:])
    tail, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, tail[-2000:]
    assert "saving last checkpoint" in tail
    _, _, _, meta = load_checkpoint(out / "ckpts" / "last.npz")
    stopped_at = int(meta["step"])
    assert 0 < stopped_at < 500
    state, _ = _port_main(augmented_args(workspace, out, training_steps=stopped_at + 2,
                                         resume=True, val_frequency=1000,
                                         save_frequency=1000))
    assert state.step == stopped_at + 2


@pytest.mark.parametrize("flag, value", [
    ("model_parallel", 2), ("pruned_loss_range", 4),
    ("noise_dataset", "Myrtle/CAIMAN-ASR-BackgroundNoise")])
def test_what_is_not_ported_raises_and_names_the_roadmap(workspace, tmp_path, flag, value):
    """A hub noise dataset is the one flag still to port, and raises naming
    its ROADMAP.md item. ``--model_parallel`` and ``--pruned_loss_range`` are
    ported (the tests below): the first raises on one process, whose world
    is no multiple of 2 (the JAX trainer drops devices there instead); the
    second takes its steps."""
    args = augmented_args(workspace, tmp_path, **{flag: value})
    if flag == "pruned_loss_range":
        state, _ = _port_main(_set(args, workspace, "augmented.yaml", tmp_path,
                                   training_steps=2))
        assert state.step == 2 and "simple_am" in state.params
        return
    if flag == "model_parallel":
        with pytest.raises(ValueError, match="multiple of it"):
            _port_main(args)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _port_main(args)


def test_without_a_gpu_main_raises(workspace, tmp_path, monkeypatch):
    import torch

    from caiman_asr_tpu_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(augmented_args(workspace, tmp_path))


def test_an_epoch_shorter_than_a_step_raises(workspace, tmp_path):
    """8 utterances in microbatches of 2 make 4 a epoch: A=5 never fills
    (the JAX trainer loops without a step); the port raises."""
    with pytest.raises(ValueError, match="fewer than --grad_accumulation_batches"):
        _port_main(augmented_args(workspace, tmp_path, global_batch_size=10,
                                  grad_accumulation_batches=5))


# --------------------------------------------------------------- pruned, TP
# a 48-class variant of the plain config (47 pieces and the blank): two
# vocab shards need an even vocabulary
PRUNED = 3


@pytest.fixture(scope="module")
def pruned_workspace(workspace):
    """``even.yaml`` (the plain config over a 47-piece tokenizer) and
    ``init_pruned.npz``: a JAX-initialised checkpoint of it with the pruned
    loss's heads, which every pruned run below fine-tunes from."""
    import jax

    from caiman_asr_tpu.models.config import load_config as jax_load_config
    from caiman_asr_tpu.ops.pruned_loss import init_simple_params
    from caiman_asr_tpu.setup.builders import build_model as jax_build_model
    from caiman_asr_tpu.setup.builders import build_tokenizer as jax_build_tokenizer

    root = workspace
    tok = root / "tok47.json"
    save_tokenizer_json(tok, train_tokenizer(TEXTS * 4, vocab_size=47))
    (root / "even.yaml").write_text(MINI_CONFIG.format(tok=tok, sampling=0.0, dither=0.0,
                                                       dropout=0.0, train_extra=""))
    cfg = jax_load_config(root / "even.yaml").cfg
    model, _ = jax_build_model(cfg, jax_build_tokenizer(cfg))
    assert model.n_classes == 48
    params = model.init(jax.random.PRNGKey(5))
    params.update(init_simple_params(jax.random.PRNGKey(6), 16, model.n_classes))
    params = jax.tree.map(np.asarray, params)
    jax_save_checkpoint(root / "init_pruned.npz", params, params, None, {"step": 0})
    return root


def pruned_args(parser, root, out, **kw):
    """The JAX-parity settings on ``even.yaml`` with the pruned loss of band
    3, random state passing off (the tensor-parallel step refuses it)."""
    return _set(parser().parse_args([]), root, "even.yaml", out,
                **{**dict(no_amp=True, fine_tune=True, ckpt=str(root / "init_pruned.npz"),
                          pruned_loss_range=PRUNED, rsp_seq_len_freq=[1]), **kw})


@pytest.fixture(scope="module")
def jax_pruned_run(pruned_workspace, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_pruned")
    _jax_main(pruned_args(jax_train_arg_parser, pruned_workspace, out))
    return out


# the pruned loss's heads take bf16 operands, so the part of f's and g's
# gradients through them is rounded to bf16 on both sides, and an element at
# a rounding boundary can fall the other way (tests/test_torch_tp_step.py)
PRUNED_STATE_TOL = dict(atol=5e-5, rtol=1e-4)
# the JAX step over a model group rounds each vocab shard's part to bf16
# before the sum, its one-device step the sum: the two differ by up to 2^-8
# of that part, and the tensor-parallel state is held against the
# one-device one at the JAX package's own bound for that comparison
# (tests/parallel/test_tp_pruned.py)
TP_VS_ONE_TOL = dict(atol=5e-4, rtol=5e-3)


def assert_pruned_run_close(got_out, want_out, steps, ckpt="last.npz", tol=PRUNED_STATE_TOL):
    got, _ = read_log(got_out)
    want, _ = read_log(want_out)
    assert sorted(got) == steps
    assert_steps_close(got, want, steps)
    got_p, got_e, got_o, _ = load_checkpoint(got_out / "ckpts" / ckpt)
    want_p, want_e, want_o, _ = jax_load_checkpoint(want_out / "ckpts" / ckpt)
    for g_tree, w_tree in ((got_p, want_p), (got_e, want_e)):
        g_flat, w_flat = flatten_named(g_tree), flatten_named(w_tree)
        assert g_flat.keys() == w_flat.keys() and "simple_am/w" in g_flat
        for k in g_flat:
            np.testing.assert_allclose(g_flat[k], w_flat[k], err_msg=k, **tol)
    assert len(got_o) == len(want_o)
    assert int(got_o[0]) == int(want_o[0]) and int(got_o[-1]) == int(want_o[-1])
    for i, (g, w) in enumerate(zip(got_o[1:-1], want_o[1:-1])):
        np.testing.assert_allclose(g, w, err_msg=f"opt/{i + 1}", **tol)


def test_pruned_steps_and_checkpoints_match_jax(pruned_workspace, jax_pruned_run, tmp_path):
    """``--pruned_loss_range 3``: each step's loss and gradient norm, and the
    last checkpoint with the heads, their EMA and both moments."""
    state, _ = _port_main(pruned_args(train_arg_parser, pruned_workspace, tmp_path))
    assert state.step == 4
    assert_pruned_run_close(tmp_path, jax_pruned_run, [1, 2, 3, 4])


TP_RANK = """
import caiman_asr_tpu_torch.ops.joint_kernel as jk
from caiman_asr_tpu_torch import train
jk.Z_STORE_LIMIT_BYTES = 0  # no slab: K2 and K4, exact fp32 as JAX's plain route here
args = pickle.load(open(SPEC, "rb"))
train.main(args, device="cpu")
"""


def _tp_main(args, tmp_path, name):
    """``train.main`` with ``--model_parallel 2`` over two gloo CPU ranks."""
    from tests.test_torch_distributed import spawn_ranks

    spec = tmp_path / f"{name}.pkl"
    spec.write_bytes(pickle.dumps(args))
    spawn_ranks(TP_RANK.replace("SPEC", repr(str(spec))), tmp_path, 2, name=name)


def test_model_parallel_runs_resume_across_layouts_and_packages(
        pruned_workspace, jax_pruned_run, tmp_path):
    """``--model_parallel 2 --pruned_loss_range 3`` on two ranks (one model
    group: one data rank, the global batch of one process) equals JAX's one
    process, the store budget 0 so that the vocab-parallel joint is exact
    fp32 as JAX's plain route is here. Its checkpoints hold whole arrays:
    one port process resumes its step 2, and JAX does, each giving JAX's
    steps 3 and 4; and the two ranks resume JAX's step 2 likewise. Losses
    and gradient norms at the CLI gates; the state, where one side ran over
    the model group and the other on one device, at ``TP_VS_ONE_TOL``."""
    tp = tmp_path / "tp"
    _tp_main(pruned_args(train_arg_parser, pruned_workspace, tp, model_parallel=2), tmp_path,
             "tp")
    assert_pruned_run_close(tp, jax_pruned_run, [1, 2, 3, 4], tol=TP_VS_ONE_TOL)
    with np.load(tp / "ckpts" / "step2.npz") as z:
        assert z["params/joint_fc/w"].shape == (48, 16)
        assert z["params/simple_lm/b"].shape == (48,)

    one = tmp_path / "one"
    _port_main(pruned_args(train_arg_parser, pruned_workspace, one, fine_tune=False,
                           resume=True, ckpt=str(tp / "ckpts" / "step2.npz")))
    assert_pruned_run_close(one, jax_pruned_run, [3, 4], tol=TP_VS_ONE_TOL)

    jax_out = tmp_path / "jax"
    _jax_main(pruned_args(jax_train_arg_parser, pruned_workspace, jax_out, fine_tune=False,
                          resume=True, ckpt=str(tp / "ckpts" / "step2.npz")))
    got, _ = read_log(jax_out)
    want, _ = read_log(jax_pruned_run)
    assert sorted(got) == [3, 4]
    assert_steps_close(got, want, [3, 4])

    tp2 = tmp_path / "tp_resumed"
    _tp_main(pruned_args(train_arg_parser, pruned_workspace, tp2, model_parallel=2,
                         fine_tune=False, resume=True,
                         ckpt=str(jax_pruned_run / "ckpts" / "step2.npz")), tmp_path, "tp2")
    assert_pruned_run_close(tp2, jax_pruned_run, [3, 4], tol=TP_VS_ONE_TOL)
