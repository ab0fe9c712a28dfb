#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (caiman_asr_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases:
  1. set-up: card name and power limit, kernel build (nvcc, into
     build/kernels/), TF32 off;
  2. every kernel against its plain PyTorch version at the shapes the main
     path gives it, with times beside the bound and the library call;
  3. the slice at full width: base-85M (random weights from a seeded
     generator) transcribes 16 synthetic utterances offline with greedy
     decoding, in fp32 and bf16; the launch counts must equal the expected
     number and the fp32 result must equal the plain path's.

Prints the kernels line and, last, {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; without a GPU it exits non-zero at once.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import difflib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent

# peak rates of one H100 SXM (NVIDIA's data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # bf16: reordered bf16 sums over H=1024

B, H = 16, 1024
N_UTTS, MIN_S, MAX_S, SR = 16, 2.0, 8.0, 16000
SEED = 0
# A random joint almost never ranks blank first among 8,704 classes, so
# greedy decoding would emit the maximum number of symbols on every frame.
# The blank bias is raised so that blank wins all but EMIT_SHARE of
# the decisions, near what a trained model emits; it also keeps
# most greedy decisions far from ties between the kernel and plain paths.
EMIT_SHARE = 0.1
CALIB_TOKENS = 4
MIN_START_EMIT = 0.01


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps calls, with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def recurrence_bound_ms(T: int, dtype: str) -> tuple[float, str]:
    """Least time for one layer's recurrence: w_hh read once, gx read, ys and
    cs written, h0/c0 read, against HBM rate; 2*B*H*4H FLOPs per step against
    the peak for the type. Returns (ms, what bounds it)."""
    es = 4 if dtype == "float32" else 2
    nbytes = es * (4 * H * H + T * B * 4 * H + 2 * T * B * H + 2 * B * H)
    flops = 2.0 * B * H * 4 * H * T
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_recurrence(T: int, dtype_name: str, hard: bool, timed: bool) -> dict:
    """Kernel vs plain version on the card at [T, B, 4H]."""
    import torch

    from caiman_asr_tpu_torch.ops import lstm_kernel

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(T * 7 + int(hard))
    bound = 1.0 / math.sqrt(H)
    gx = (torch.randn((T, B, 4 * H), generator=g, device="cuda") * 0.5).to(dtype)
    w_hh = ((torch.rand((4 * H, H), generator=g, device="cuda") * 2 - 1) * bound).to(dtype)
    h0 = (torch.randn((B, H), generator=g, device="cuda") * 0.1).to(dtype)
    c0 = (torch.randn((B, H), generator=g, device="cuda") * 0.1).to(dtype)

    ys, cs = lstm_kernel.lstm_recurrence(gx, w_hh, h0, c0, hard)
    torch.cuda.synchronize()
    ys_ref, cs_ref = lstm_kernel.lstm_recurrence_plain(gx, w_hh, h0, c0, hard)
    err = max((ys.float() - ys_ref.float()).abs().max().item(),
              (cs.float() - cs_ref.float()).abs().max().item())
    res = {"T": T, "dtype": dtype_name, "hard": hard, "max_abs_err": err,
           "tol": TOL[dtype_name]}
    log(f"  recurrence T={T} B={B} H={H} {dtype_name} hard={hard}: "
        f"max|kernel - plain| = {err:.3g} (tol {TOL[dtype_name]})")
    if not err <= TOL[dtype_name]:
        raise AssertionError(f"kernel disagrees with its plain version: {res}")
    if timed:
        res["ms"] = cuda_ms(lambda: lstm_kernel.lstm_recurrence(gx, w_hh, h0, c0, hard))
        res["plain_ms"] = cuda_ms(
            lambda: lstm_kernel.lstm_recurrence_plain(gx, w_hh, h0, c0, hard), reps=3, warmup=1)
        res["bound_ms"], res["bound_by"] = recurrence_bound_ms(T, dtype_name)
        # library yardstick: one cuDNN LSTM layer (input width H), which also
        # does the input GEMM — so compare it with kernel + that GEMM
        x = torch.randn((T, B, H), generator=g, device="cuda").to(dtype)
        w_ih_t = ((torch.rand((H, 4 * H), generator=g, device="cuda") * 2 - 1) * bound).to(dtype)
        lib = torch.nn.LSTM(H, H, device="cuda", dtype=dtype)
        lib.flatten_parameters()
        res["library_flat_weights"] = (
            lib.weight_ih_l0.untyped_storage().data_ptr()
            == lib.weight_hh_l0.untyped_storage().data_ptr())
        with torch.no_grad():
            res["library_ms"] = cuda_ms(lambda: lib(x, (h0[None], c0[None])))
        res["gemm_ms"] = cuda_ms(lambda: torch.matmul(x.reshape(T * B, H), w_ih_t))
        res["kernel_plus_gemm_ms"] = res["ms"] + res["gemm_ms"]
        log(f"    kernel {res['ms']:.4f} ms | plain {res['plain_ms']:.4f} ms | "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) | "
            f"cuDNN nn.LSTM layer (with input GEMM) {res['library_ms']:.4f} ms vs "
            f"kernel + input GEMM {res['kernel_plus_gemm_ms']:.4f} ms "
            f"(cuDNN weights in one buffer: {res['library_flat_weights']})")
    return res


def synthetic_audio(seed: int):
    """N_UTTS utterances of MIN_S..MAX_S seconds at 16 kHz: a few harmonic
    tones with a slow amplitude envelope plus noise, zero-padded to [B, S]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(int(MIN_S * SR), int(MAX_S * SR) + 1, size=N_UTTS)
    lens[0] = int(MAX_S * SR)  # one utterance at the full length
    audio = np.zeros((N_UTTS, int(lens.max())), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / SR
        f0 = rng.uniform(90, 250)
        sig = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi)) / k
                  for k in range(1, 6))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
        audio[i, :n] = 0.1 * env * sig + 0.01 * rng.normal(size=n)
    return audio, lens.astype(np.int64)


def base_85m(device: str):
    """base-85M exactly as `__graft_entry__.py:14-27` builds it."""
    import torch

    from caiman_asr_tpu_torch.models.config import RNNTModelConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT

    cfg = RNNTModelConfig(
        in_feats=240, enc_n_hid=1024, enc_pre_rnn_layers=2, enc_post_rnn_layers=6,
        enc_stack_time_factor=2, pred_n_hid=512, pred_rnn_layers=2, joint_n_hid=768,
    )
    model = RNNT(cfg, 8704, device=device)
    return model.init_weights(torch.Generator(device=device).manual_seed(SEED))


def calibrate_blank(model, feats, feat_lens) -> float:
    """Raise the blank bias so that blank is the argmax on all but EMIT_SHARE
    of the (frame, prediction state) pairs, the states being the start state
    and those after CALIB_TOKENS random tokens — but on no more than
    1 - MIN_START_EMIT of the frames from the start state, so that decoding
    starts at all. Returns the raise."""
    import torch

    with torch.inference_mode():
        f, f_lens, _ = model.encode(feats, feat_lens)
        g_gen = torch.Generator(device=f.device).manual_seed(SEED + 1)
        y = torch.randint(0, model.n_classes - 1, (f.shape[0], CALIB_TOKENS),
                          generator=g_gen, device=f.device)
        g, _, _ = model.predict(y)
        logits = model.joint(f, g)  # [B, T, U+1, K]
        margin = logits[..., :-1].amax(-1) - logits[..., -1]
        valid = torch.arange(f.shape[1], device=f.device)[None, :] < f_lens[:, None]
        raise_by = torch.minimum(  # but let the start state emit somewhere
            torch.quantile(margin[valid].flatten(), 1.0 - EMIT_SHARE),
            torch.quantile(margin[..., 0][valid], 1.0 - MIN_START_EMIT),
        )
        model.joint_net[2].bias[-1] += raise_by
    return float(raise_by)


def tokens(responses):
    from caiman_asr_tpu_torch.decoding.response import frame_responses_to_tokens

    return [frame_responses_to_tokens(r) for r in responses]


def run_slice() -> dict:
    import numpy as np
    import torch

    from caiman_asr_tpu_torch import offline
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.ops import lstm_kernel
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig

    model = base_85m("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    if not all(p.device.type == "cuda" for p in model.parameters()):
        raise AssertionError("model parameters are not all on the GPU")
    log(f"  base-85M: {n_params} parameters, all on {torch.cuda.get_device_name(0)}")

    audio_np, lens_np = synthetic_audio(SEED)
    audio = torch.from_numpy(audio_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    audio_secs = float(lens_np.sum()) / SR
    pipe = PipelineConfig(logmel=LogMelConfig(dither=0.0))
    fp = FeaturePipeline(pipe, device="cuda")

    feats, feat_lens = fp(audio, lens)
    T_pre = feats.shape[0]
    T_post = -(-T_pre // model.cfg.enc_stack_time_factor)
    expected = (model.cfg.enc_pre_rnn_layers * T_pre
                + model.cfg.enc_post_rnn_layers * T_post)
    log(f"  {N_UTTS} utterances, {audio_secs:.2f} s of audio; encoder T={T_pre} "
        f"(pre) / {T_post} (post), B={N_UTTS}")
    log(f"  blank bias raised by {calibrate_blank(model, feats, feat_lens):.4f} "
        f"(emit share {EMIT_SHARE}, start-state floor {MIN_START_EMIT})")

    out = {"T_pre": T_pre, "T_post": T_post, "expected_launches": expected}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        torch.cuda.synchronize()
        lstm_kernel.lstm_recurrence.launches = 0
        t0 = time.perf_counter()
        responses = offline.transcribe(model, audio, lens, device="cuda", dtype=dtype,
                                       pipeline=pipe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lstm_kernel.lstm_recurrence.launches
        log(f"  transcribe {name}: {wall * 1e3:.1f} ms, "
            f"{audio_secs / wall:.1f} audio-s/s; lstm_recurrence_fwd launches "
            f"{launches} (expected {expected})")
        if launches != expected:
            raise AssertionError(f"{name}: {launches} launches, expected {expected}")
        out[name] = {"responses": responses, "launches": launches, "wall_s": wall}

        # layer times of this run's path, each ending in a synchronise
        with torch.inference_mode():
            decoder = GreedyDecoder(model, model.n_classes - 1)
            t0 = time.perf_counter()
            f_in, fl = fp(audio, lens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            encs, enc_lens, _ = model.encode(f_in.to(dtype), fl)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            decoder.decode_encs(encs, enc_lens)
            t3 = time.perf_counter()
        out[name].update(featurize_ms=1e3 * (t1 - t0), encode_ms=1e3 * (t2 - t1),
                         decode_ms=1e3 * (t3 - t2), encs=encs, enc_lens=enc_lens)
        log(f"    featurize {1e3 * (t1 - t0):.2f} ms | encode {1e3 * (t2 - t1):.2f} ms"
            f" | greedy decode {1e3 * (t3 - t2):.2f} ms")

    # fp32: the kernel path against the plain path on the card
    fp32 = out["float32"]
    with mock.patch.object(lstm_kernel, "lstm_recurrence", lstm_kernel.lstm_recurrence_plain):
        with torch.inference_mode():
            f_ref, _, _ = model.encode(feats, feat_lens)
        ref_responses = offline.transcribe(model, audio, lens, device="cuda",
                                           dtype=torch.float32, pipeline=pipe)
    enc_err = (fp32["encs"] - f_ref).abs().max().item()
    toks_k, toks_ref = tokens(fp32["responses"]), tokens(ref_responses)
    n_tok = sum(len(t) for t in toks_k)
    log(f"  fp32 encoder output vs plain path: max abs err {enc_err:.3g} (tol 1e-3); "
        f"greedy tokens identical: {toks_k == toks_ref} ({n_tok} tokens)")
    if not enc_err <= 1e-3:
        raise AssertionError(f"fp32 encoder output differs from the plain path by {enc_err}")
    if toks_k != toks_ref:
        raise AssertionError("fp32 greedy tokens differ from the plain path's")
    if n_tok == 0:
        raise AssertionError("the slice emitted no tokens: the comparison is vacuous")
    for name in ("float32", "bfloat16"):
        e = out[name]["encs"]
        if not (torch.isfinite(e).all() and e.shape == (N_UTTS, T_post, model.cfg.joint_n_hid)):
            raise AssertionError(f"{name} encoder output is not finite or has shape {e.shape}")

    toks_bf = tokens(out["bfloat16"]["responses"])
    same = sum(a == b for a, b in zip(toks_k, toks_bf))
    ratio = difflib.SequenceMatcher(
        a=[t for u in toks_k for t in u + [-1]], b=[t for u in toks_bf for t in u + [-1]],
        autojunk=False,
    ).ratio()
    log(f"  bf16 vs fp32 tokens: {same}/{N_UTTS} utterances identical, "
        f"sequence similarity {ratio:.4f}")
    out["bf16_identical_utts"] = same
    out["bf16_similarity"] = ratio
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 1
    if not (REPO / "caiman_asr_tpu_torch").is_dir():
        print(f"chip_smoke: no caiman_asr_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from caiman_asr_tpu_torch.ops import lstm_kernel

    t_start = time.perf_counter()
    # 1. set-up
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"== setup: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_logs = lstm_kernel.build_kernels()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s into {lstm_kernel.BUILD_DIR}")
    for stem, text in build_logs.items():
        for line in text.strip().splitlines():
            log(f"  [{stem}] {line}")

    # 2. each kernel against its plain version
    log("== kernels vs plain versions")
    for dtype in ("float32", "bfloat16"):
        for hard in (False, True):
            check_recurrence(64, dtype, hard, timed=not hard)

    # 3. the slice at full width
    log("== slice: offline greedy transcription, base-85M")
    sl = run_slice()
    log("== kernels at the main path's shapes")
    per_shape = {}
    for name in ("float32", "bfloat16"):
        for T in (sl["T_pre"], sl["T_post"]):
            per_shape[(name, T)] = check_recurrence(T, name, False, timed=True)

    line = per_shape[("bfloat16", sl["T_pre"])]
    kernels = [{
        "name": "lstm_recurrence_fwd",
        "route": "cuda",
        "source": "caiman_asr_tpu_torch/ops/csrc/lstm_recurrence.cu",
        "replaces": "caiman_asr_tpu/ops/pallas_lstm.py:56",
        "launches": sl["bfloat16"]["launches"],
        "max_abs_err": line["max_abs_err"],
        "ms": line["ms"],
        "plain_ms": line["plain_ms"],
        "bound_ms": line["bound_ms"],
        "bound_by": line["bound_by"],
        "library_ms": line["library_ms"],
        "shape": f"T={sl['T_pre']} B={B} H={H} bfloat16 (one encoder layer)",
    }]
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
