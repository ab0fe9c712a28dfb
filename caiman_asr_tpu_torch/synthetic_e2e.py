"""End-to-end sanity run of the port on synthetic tone-coded speech (the
port's copy of ``scripts/synthetic_e2e.py``).

Writes a dataset where each of 12 words is a distinct pure tone (240 train
and 32 dev utterances of 3 to 7 words), trains a 64-piece tokenizer and the
mel statistics on it, trains a small RNN-T from scratch through
``train.main`` and validates its best checkpoint through ``val.validate``
with the fast beam (width 4): the whole port, from WAV decoding through the
kernels, LAMB and the EMA to decoding and WER, on a task it can learn. At
2,500 steps or more the dev WER must be below 20%.

Run: python -m caiman_asr_tpu_torch.synthetic_e2e --workdir build/synthetic_e2e \\
       --steps 3000

``--compare_decoders`` then trains a 3-gram over the train transcripts
(``lm/train_ngram.py``) and tables the dev WER of greedy, the fast beam
(width 4), the fast beam with the LM fused at scale 0.3 and the host beam
with it; LM fusion must not hurt the fast beam.

``--pruned S`` trains on the pruned two-stage loss with band width S
(``--pruned_loss_range S``) instead of the dense loss: the quality check of
that mode.

It runs on the card (``run(..., device="cpu")`` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import time
import wave
from pathlib import Path

import numpy as np

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet", "kilo", "lima"]
SR = 16000
N_TRAIN, N_DEV = 240, 32
VOCAB = 64
WER_BAR, WER_BAR_STEPS = 0.2, 2500

CONFIG = """
tokenizer:
  sentpiece_model: {tok}
  labels: [" ", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l",
           "m", "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y",
           "z", "'"]
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
    n_filt: 80
    dither: 0.00001
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
  in_feats: 240
  enc_n_hid: 128
  enc_pre_rnn_layers: 1
  enc_post_rnn_layers: 1
  enc_stack_time_factor: 2
  enc_dropout: 0.1
  pred_n_hid: 64
  pred_rnn_layers: 1
  joint_n_hid: 128
  pred_dropout: 0.1
  joint_dropout: 0.1
  forget_gate_bias: 1.0
grad_noise_scheduler:
  noise_level: 0.0
"""


def synth(words, freqs):
    parts = []
    for w in words:
        t = np.arange(int(0.18 * SR)) / SR
        tone = 0.3 * np.sin(2 * np.pi * freqs[w] * t) * np.hanning(len(t))
        parts += [tone, np.zeros(int(0.05 * SR))]
    return np.concatenate(parts).astype(np.float32)


def write_set(root: Path, name: str, n: int, seed: int, freqs) -> list:
    """``n`` utterances as 16-bit WAV files and a manifest ``{name}.json``;
    returns their transcripts."""
    r = np.random.default_rng(seed)
    entries, texts = [], []
    for i in range(n):
        words = [WORDS[j] for j in r.integers(0, len(WORDS), r.integers(3, 8))]
        audio = synth(words, freqs)
        fn = f"{name}_{i:04d}.wav"
        with wave.open(str(root / fn), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((audio * 32767).astype(np.int16).tobytes())
        dur = len(audio) / SR
        entries.append({"transcript": " ".join(words),
                        "files": [{"fname": fn, "duration": dur}],
                        "original_duration": dur})
        texts.append(entries[-1]["transcript"])
    (root / f"{name}.json").write_text(json.dumps(entries))
    return texts


def prepare(root: Path, *, device="cuda") -> Path:
    """The dataset, the tokenizer and the mel statistics under ``root``;
    returns the model config's path."""
    from caiman_asr_tpu_torch.data.generate_mel_stats import main as mel_main
    from caiman_asr_tpu_torch.data.tokenizer import save_tokenizer_json, train_tokenizer

    root.mkdir(parents=True, exist_ok=True)
    freqs = {w: 300 + 150 * i for i, w in enumerate(WORDS)}
    texts = write_set(root, "train", N_TRAIN, 1, freqs)
    write_set(root, "dev", N_DEV, 2, freqs)
    save_tokenizer_json(root / "tok.json", train_tokenizer(texts, vocab_size=VOCAB))
    cfg = root / "cfg.yaml"
    cfg.write_text(CONFIG.format(tok=root / "tok.json"))
    print(f"dataset ready under {root}")
    mel_main(["--model_config", str(cfg), "--dataset_dir", str(root),
              "--manifests", "train.json", "--output_path", str(root / "mel_stats.npz")],
             device=device)
    return cfg


def train_argv(root: Path, cfg: Path, steps: int, lr: float, seed: int,
               log_frequency: int = 200, pruned: int = 0) -> list:
    """The JAX script's training flags."""
    return [
        "--model_config", str(cfg), "--dataset_dir", str(root),
        "--train_manifests", "train.json", "--val_manifests", "dev.json",
        "--output_dir", str(root / "out"),
        "--global_batch_size", "16", "--grad_accumulation_batches", "1",
        "--training_steps", str(steps),
        "--val_frequency", str(max(steps // 6, 100)),
        "--save_frequency", str(steps), "--log_frequency", str(log_frequency),
        "--prediction_frequency", str(steps * 10),
        "--warmup_steps", "40", "--hold_steps", str(steps // 4),
        "--half_life_steps", str(steps // 8),
        "--lr", str(lr), "--val_batch_size", "16", "--ema", "0.99",
        "--mel_stats_path", str(root / "mel_stats.npz"),
        "--norm_ramp_start_step", "200",
        "--norm_ramp_end_step", str(max(steps // 3, 400)),
        "--seed", str(seed),
    ] + (["--pruned_loss_range", str(pruned)] if pruned else [])


def run(workdir, steps: int = 3000, lr: float = 2e-3, seed: int = 1, *,
        log_frequency: int = 200, pruned: int = 0, device="cuda") -> dict:
    """Prepare, train (on the pruned loss of band width ``pruned`` where it
    is > 0) and validate; returns the greedy best and fast-beam dev WERs, the
    wall seconds of training and the logged train losses by step."""
    from caiman_asr_tpu_torch.args.train import train_arg_parser
    from caiman_asr_tpu_torch.train import main as train_main
    from caiman_asr_tpu_torch.val import val_arg_parser, validate

    root = Path(workdir)
    cfg = prepare(root, device=device)
    targs = train_arg_parser().parse_args(train_argv(root, cfg, steps, lr, seed, log_frequency,
                                                     pruned))
    t0 = time.perf_counter()
    _, best_wer = train_main(targs, device=device)
    train_s = time.perf_counter() - t0
    vargs = val_arg_parser().parse_args([
        "--model_config", str(cfg), "--dataset_dir", str(root),
        "--val_manifests", "dev.json", "--output_dir", str(root / "valout"),
        "--ckpt", str(root / "out" / "ckpts" / "best.npz"),
        "--mel_stats_path", str(root / "mel_stats.npz"),
        "--decoder", "fast_beam", "--beam_width", "4",
    ] + (["--cpu"] if str(device) == "cpu" else []))
    result = validate(vargs)
    losses = {}
    for f in sorted((root / "out").glob("log_*.jsonl")):
        for line in f.read_text().splitlines():
            rec = json.loads(line)
            if rec.get("subset") == "train" and "loss" in rec:
                losses[rec["step"][1]] = rec["loss"]
    return {"greedy_best_wer": best_wer, "beam_wer": result.wer, "train_s": train_s,
            "steps": steps, "losses": losses}


# the decoder comparison of the JAX script (scripts/synthetic_e2e.py:180-234)
LM_SCALE = "0.3"
COMPARE = (
    ("greedy", ["--decoder", "greedy"]),
    ("fast_beam-4", ["--decoder", "fast_beam", "--beam_width", "4"]),
    ("fast_beam-4+lm", ["--decoder", "fast_beam", "--beam_width", "4", "--ngram_path", "{lm}",
                        "--ngram_scale_factor", LM_SCALE]),
    ("host_beam-4+lm", ["--decoder", "beam", "--beam_width", "4", "--ngram_path", "{lm}",
                        "--ngram_scale_factor", LM_SCALE]),
)


def compare_decoders(workdir, *, device="cuda") -> dict:
    """Train a 3-gram on the train transcripts of a ``run`` workdir and
    return the dev WER of each decoder of ``COMPARE`` on its best
    checkpoint, with the seconds each validation took."""
    from caiman_asr_tpu_torch.lm.train_ngram import main as ngram_main
    from caiman_asr_tpu_torch.val import val_arg_parser, validate

    root = Path(workdir)
    ngram_main(["--manifests", "train.json", "--dataset_dir", str(root),
                "--tokenizer_model", str(root / "tok.json"), "--order", "3",
                "--output_dir", str(root / "ngram")])
    lm = str(root / "ngram" / "ngram.arpa")
    table, seconds = {}, {}
    for name, extra in COMPARE:
        va = val_arg_parser().parse_args([
            "--model_config", str(root / "cfg.yaml"), "--dataset_dir", str(root),
            "--val_manifests", "dev.json", "--output_dir", str(root / f"valout_{name}"),
            "--ckpt", str(root / "out" / "ckpts" / "best.npz"),
            "--mel_stats_path", str(root / "mel_stats.npz"),
        ] + [a.format(lm=lm) for a in extra] + (["--cpu"] if str(device) == "cpu" else []))
        t0 = time.perf_counter()
        table[name] = validate(va).wer
        seconds[name] = time.perf_counter() - t0
    return {"wer": table, "seconds": seconds}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="build/synthetic_e2e")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--pruned", type=int, default=0, metavar="S",
                   help="train on the pruned two-stage loss of band width S instead of the "
                        "dense loss: the quality check of --pruned_loss_range")
    p.add_argument("--seed", type=int, default=1,
                   help="training seed (init + data order) for repeat runs")
    p.add_argument("--compare_decoders", action="store_true",
                   help="train a 3-gram on the train transcripts and table the dev WER of "
                        "greedy, fast beam, fast beam + LM and host beam + LM")
    args = p.parse_args(argv)
    out = run(args.workdir, args.steps, args.lr, args.seed, pruned=args.pruned)
    print(f"\nfinal: greedy-best dev WER {out['greedy_best_wer']:.2%}, "
          f"beam-4 dev WER {out['beam_wer']:.2%}, training {out['train_s']:.1f} s "
          f"({1e3 * out['train_s'] / args.steps:.1f} ms a step with validation)")
    if args.steps >= WER_BAR_STEPS:
        assert out["beam_wer"] < WER_BAR, "synthetic task failed to learn"
    if args.compare_decoders:
        cmp = compare_decoders(args.workdir)
        print("\ndecoder comparison (dev WER):")
        for name, wer in cmp["wer"].items():
            print(f"  {name:16s} {wer:.2%}  ({cmp['seconds'][name]:.1f} s)")
        assert cmp["wer"]["fast_beam-4+lm"] <= cmp["wer"]["fast_beam-4"] + 1e-9, (
            "LM fusion must not hurt on in-domain synthetic text")


if __name__ == "__main__":
    main()
