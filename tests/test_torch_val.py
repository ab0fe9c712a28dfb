"""The port's validation entry point (``caiman_asr_tpu_torch/val.py``) against
the JAX package's (``caiman_asr_tpu/val.py``) on one workspace: a tiny
config, 8 WAV utterances with their manifest (and the same as a directory of
audio and transcripts), a tokenizer, and a checkpoint the JAX package writes
from ``model.init(PRNGKey(0))`` (its EMA a perturbed copy; the joint's blank
bias lowered so that most utterances decode to text). Under each flag set,
both run in fp32 on the CPU, and:

- hyps, refs, fnames, WER and the predictions JSON are identical;
- the loss (``--calc_loss``) agrees to rtol 1e-5 (fp32 sums in another
  order);
- the CTM (``--dump_ctm``) is the same text, and the emission latencies
  against ``--gt_ctm`` are the same numbers;
- the terminations of the offline endpointing are the same.
"""

import json
import wave

import numpy as np
import pytest

from caiman_asr_tpu.data.tokenizer import save_tokenizer_json, train_tokenizer
from caiman_asr_tpu.export.checkpointer import save_checkpoint
from caiman_asr_tpu.val import val_arg_parser as jax_val_arg_parser
from caiman_asr_tpu.val import validate as jax_validate
from caiman_asr_tpu_torch.val import val_arg_parser, validate

LOSS_RTOL = 1e-5
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

CONFIG = """
{user_tokens}
tokenizer:
  sentpiece_model: {tok}
  labels: [" ", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m",
           "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z", "'"]
  sampling: 0.0
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
    dither: 0.0
  frame_splicing: &val_splicing
    frame_stacking: 3
    frame_subsampling: 3
input_train:
  audio_dataset:
    !!merge <<: *val_dataset
    max_duration: 20.0
  filterbank_features: *val_features
  frame_splicing: *val_splicing
rnnt:
  in_feats: 48
  enc_n_hid: 16
  enc_pre_rnn_layers: 1
  enc_post_rnn_layers: 1
  enc_stack_time_factor: 2
  enc_dropout: 0.0
  pred_n_hid: 16
  pred_rnn_layers: 1
  pred_dropout: 0.0
  joint_n_hid: 16
  joint_dropout: 0.0
  forget_gate_bias: 1.0
"""
# the random joint's logits scaled up (so that they vary from frame to frame)
# and the blank's bias raised until blank wins on all but EMIT_SHARE of the
# frames from the start state: most utterances decode to a few words
JOINT_SCALE, EMIT_SHARE = 10.0, 0.1
# the EOS checkpoint: the EOS piece's bias raised by this, so that EOS wins
# some decisions
EOS_RAISE = 0.5
GT_WORDS = ["at", "ato", "the", "ato", "ats"]


def write_wav(path, audio, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    import jax

    from caiman_asr_tpu.models.config import load_config
    from caiman_asr_tpu.setup.builders import build_model, build_tokenizer

    root = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(0)
    entries, gt_ctm = [], []
    (root / "dir").mkdir()
    for i, text in enumerate(TEXTS):
        dur = 0.4 + 0.15 * i
        t = np.arange(int(16000 * dur)) / 16000
        audio = (0.2 * np.sin(2 * np.pi * (120 + 40 * i) * t) * np.sin(2 * np.pi * 3 * t)
                 + rng.normal(size=t.size) * 0.05).astype(np.float32)
        write_wav(root / f"utt{i}.wav", audio)
        write_wav(root / "dir" / f"utt{i}.wav", audio)
        (root / "dir" / f"utt{i}.txt").write_text(text)
        entries.append({"transcript": text,
                        "files": [{"fname": f"utt{i}.wav", "duration": dur}],
                        "original_duration": dur})
        # ground truth in the words the random model emits, so that some align
        words = GT_WORDS
        for w, word in enumerate(words):
            gt_ctm.append(f"{root / f'utt{i}.wav'} 1 {w * dur / len(words):.3f} "
                          f"{0.8 * dur / len(words):.3f} {word}")
    (root / "manifest.json").write_text(json.dumps(entries))
    (root / "gt.ctm").write_text("\n".join(gt_ctm) + "\n")
    pieces = train_tokenizer(TEXTS * 4, vocab_size=48, user_symbols=("<EOS>",))
    save_tokenizer_json(root / "tok.json", pieces)
    configs = {}
    for name, user_tokens in (("mini", ""), ("eos", 'user_tokens:\n  eos: "<EOS>"')):
        configs[name] = root / f"{name}.yaml"
        configs[name].write_text(CONFIG.format(tok=root / "tok.json", user_tokens=user_tokens))
    configs["sampled"] = root / "sampled.yaml"
    configs["sampled"].write_text(configs["mini"].read_text().replace("sampling: 0.0",
                                                                      "sampling: 0.5"))
    cfg = load_config(configs["mini"]).cfg
    model, _ = build_model(cfg, build_tokenizer(cfg))
    params = jax.tree.map(np.array, model.init(jax.random.PRNGKey(0)))
    params["joint_fc"]["w"] *= JOINT_SCALE
    params["joint_fc"]["b"][-1] += blank_raise(cfg, params, root)
    ema = jax.tree.map(
        lambda a: a + np.random.default_rng(1).normal(size=a.shape).astype(a.dtype) * 0.01,
        params)
    save_checkpoint(root / "ckpt.npz", params, ema, meta={"step": 7})
    eos_params = jax.tree.map(np.array, ema)
    eos_params["joint_fc"]["b"][1] += EOS_RAISE  # piece 1: <EOS>, after <unk>
    save_checkpoint(root / "ckpt_eos.npz", params, eos_params)
    return root, configs


def blank_raise(cfg, params, root):
    """The raise of the blank's bias that leaves EMIT_SHARE of the frames of
    the workspace's audio (through the eval pipeline, from the start state)
    with a non-blank argmax."""
    import torch

    from caiman_asr_tpu_torch.data.audio import read_audio
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.export.from_jax import load_jax_params
    from caiman_asr_tpu_torch.models.config import load_config as port_config
    from caiman_asr_tpu_torch.models.rnnt import RNNT

    from caiman_asr_tpu_torch.setup.builders import apply_input_overrides

    pcfg = apply_input_overrides(port_config(root / "mini.yaml"), val_arg_parser().parse_args([]))
    model = load_jax_params(RNNT(pcfg.rnnt, params["joint_fc"]["b"].shape[0], device="cpu"),
                            params)
    margins = []
    with torch.no_grad():
        for i in range(len(TEXTS)):
            audio = torch.from_numpy(read_audio(root / f"utt{i}.wav"))[None]
            feats, lens = FeaturePipeline(pcfg.input_val, device="cpu")(
                audio, torch.tensor([audio.shape[1]]))
            f, f_lens, _ = model.encode(feats, lens)
            g, _, _ = model.predict(torch.zeros((1, 0), dtype=torch.int64))
            logits = model.joint(f, g)[0, : int(f_lens[0]), 0]
            margins.append(logits[:, :-1].amax(-1) - logits[:, -1])
    return float(torch.quantile(torch.cat(margins), 1.0 - EMIT_SHARE))


def run_both(workspace, tmp_path, flags, config="mini"):
    """Parse the same argv in both packages (checked equal), run each
    ``validate`` (the port with --cpu) and return the two results and output
    directories."""
    root, configs = workspace
    ckpt = root / ("ckpt_eos.npz" if config == "eos" else "ckpt.npz")
    base = ["--model_config", str(configs[config]), "--ckpt", str(ckpt),
            "--dataset_dir", str(root), "--val_manifests", "manifest.json", "--dump_preds",
            *flags]
    out = {}
    for name, parser, fn, extra in (("jax", jax_val_arg_parser, jax_validate, []),
                                    ("port", val_arg_parser, validate, ["--cpu"])):
        args = parser().parse_args(base + ["--output_dir", str(tmp_path / name)] + extra)
        out[name] = (fn(args), tmp_path / name)
    return out


def _fields(x):
    """A termination or timestamp of either package as comparable data: its
    class name and fields (plain ints stay ints)."""
    if isinstance(x, list):
        return [_fields(v) for v in x]
    return x if isinstance(x, int) else (type(x).__name__, vars(x))


def check_same(out, loss: bool = False):
    (want, want_dir), (got, got_dir) = out["jax"], out["port"]
    assert got.fnames == want.fnames
    assert got.refs == want.refs
    assert got.hyps == want.hyps
    assert got.wer == want.wer
    assert (got.scores, got.num_words) == (want.scores, want.num_words)
    assert _fields(got.terminations) == _fields(want.terminations)
    assert _fields(got.timestamps) == _fields(want.timestamps)
    assert ((got_dir / "preds" / "preds_step0.json").read_text()
            == (want_dir / "preds" / "preds_step0.json").read_text())
    if loss:
        assert want.loss is not None and np.isfinite(want.loss)
        np.testing.assert_allclose(got.loss, want.loss, rtol=LOSS_RTOL)
    else:
        assert got.loss is None and want.loss is None
    return got


def test_the_argv_parses_alike_in_both_packages():
    argv = ["--model_config", "x.yaml", "--ckpt", "c.npz", "--val_manifests", "a.json",
            "b.json", "--decoder", "beam", "--beam_width", "3", "--calculate_loss",
            "--no_ema", "--sr_segment", "2.0", "--eos_decoding", "predict",
            "--hf_val_dataset", "d", "--breakdown_wer", "--cpu"]
    assert vars(val_arg_parser().parse_args(argv)) == vars(jax_val_arg_parser().parse_args(argv))
    assert vars(val_arg_parser().parse_args([])) == vars(jax_val_arg_parser().parse_args([]))


def test_greedy(workspace, tmp_path):
    got = check_same(run_both(workspace, tmp_path, []))
    assert sum(bool(h) for h in got.hyps) >= 6, got.hyps


def test_calc_loss_with_breakdowns(workspace, tmp_path):
    check_same(run_both(workspace, tmp_path, ["--calc_loss", "--wer_breakdown",
                                              "--punctuation_error_rate"]), loss=True)


@pytest.mark.parametrize("decoder", ["beam", "fast_beam"])
def test_beams(workspace, tmp_path, decoder):
    got = check_same(run_both(workspace, tmp_path, ["--decoder", decoder, "--beam_width", "3"]))
    assert any(got.hyps)


def test_state_resets(workspace, tmp_path):
    got = check_same(run_both(workspace, tmp_path, ["--sr_segment", "0.6",
                                                    "--sr_overlap", "0.2"]))
    assert any(got.hyps)


def test_val_from_dir(workspace, tmp_path):
    got = check_same(run_both(workspace, tmp_path, ["--val_from_dir", "--val_audio_dir",
                                                    "dir"]))
    assert len(got.fnames) == len(TEXTS)


def test_nth_batch_only(workspace, tmp_path):
    got = check_same(run_both(workspace, tmp_path, ["--val_batch_size", "3",
                                                    "--nth_batch_only", "1"]))
    assert len(got.fnames) == 3


@pytest.mark.parametrize("terminal", [False, True])
def test_eos_predict_and_trimming(workspace, tmp_path, terminal):
    flags = ["--eos_decoding", "predict", "--eos_alpha", "0.5", "--eos_vad_threshold", "0.3",
             "--calc_loss"] + (["--eos_is_terminal"] if terminal else [])
    got = check_same(run_both(workspace, tmp_path, flags, config="eos"), loss=True)
    assert {type(t).__name__ for t in got.terminations} >= {"EOS", "Never"}


def test_ctm_and_emission_latency(workspace, tmp_path):
    root, _ = workspace
    out = run_both(workspace, tmp_path, ["--dump_ctm", "--gt_ctm", str(root / "gt.ctm"),
                                         "--calculate_emission_latency"])
    got = check_same(out)
    (want, want_dir), (_, got_dir) = out["jax"], out["port"]
    assert (got_dir / "model.ctm").read_text() == (want_dir / "model.ctm").read_text()
    assert (got_dir / "model.ctm").read_text()
    assert got.latency_metrics == want.latency_metrics
    assert got.latency_metrics["n"] > 0


def test_the_loss_targets_are_not_sampled(workspace, tmp_path):
    """With the config's subword sampling at 0.5, the port's loss is the
    same run after run, and the same as with sampling 0 (the JAX val.py
    samples its targets unseeded: ROADMAP.md Queue 3)."""
    root, configs = workspace
    losses = []
    for i, config in enumerate(("sampled", "sampled", "mini")):
        args = val_arg_parser().parse_args([
            "--model_config", str(configs[config]), "--ckpt", str(root / "ckpt.npz"),
            "--dataset_dir", str(root), "--val_manifests", "manifest.json", "--calc_loss",
            "--cpu", "--output_dir", str(tmp_path / str(i))])
        losses.append(validate(args).loss)
    assert losses[0] == losses[1] == losses[2]
