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
     number and the fp32 result must equal the plain path's;
  4. the train step at full width: base-85M with its dropouts takes 5 LAMB
     steps on one batch of the same 16 utterances with random transcripts,
     in bf16 and in fp32 compute; every loss finite, none skipped, the loss
     falling; every kernel of the path launched; a timed breakdown of one
     step;
  5. the whole step held against its plain path: at a reduced batch, fp32,
     dropout off, the loss and every gradient from the kernels against the
     same with every kernel swapped for its plain version;
  6. the validation loss through K2 against the plain route;
  7. every kernel at the main path's shapes against its plain version, with
     times beside the bound and the library call.

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

# the train phase: transcripts of U_MIN..U_MAX random tokens, A = 1
U_MIN, U_MAX = 16, 64
TRAIN_STEPS = 5
SCALARS = {"delay_penalty": 0.0, "star_penalty": 0.0}
# the whole-step check: the first CHECK_B utterances, fp32, dropout off.
# Tolerances: the loss 1e-5 relative (sums in another order); a gradient
# 1e-3 of its largest magnitude (both paths round u = exp(z) to bf16 for the
# backward, and a rounding that falls the other way moves a term by one bf16
# ulp, 2^-8, of a softmax numerator)
CHECK_B = 4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
# the joint kernels against their plain versions: 1e-4 of the output's scale
# (fp32 accumulation in another order); u one bf16 ulp (2^-7 relative)
JOINT_RTOL, U_RTOL = 1e-4, 2 ** -7
# the validation loss, K2 route against the plain route (sums in another
# order over H and over the 8,704 classes)
VAL_RTOL = 1e-5

# (name, module, wrapper, CUDA source, the Pallas kernel it replaces)
KERNELS = [
    ("K1 lstm_recurrence_fwd", "lstm_kernel", "lstm_recurrence", "lstm_recurrence.cu",
     "caiman_asr_tpu/ops/pallas_lstm.py:56"),
    ("K3a lstm_recurrence_fwd_sg", "lstm_kernel", "lstm_recurrence_sg", "lstm_recurrence.cu",
     "caiman_asr_tpu/ops/pallas_lstm.py:86"),
    ("K3b lstm_recurrence_bwd", "lstm_kernel", "lstm_recurrence_bwd",
     "lstm_recurrence_bwd.cu", "caiman_asr_tpu/ops/pallas_lstm.py:182"),
    ("K2 joint_fwd", "joint_kernel", "joint_fwd", "joint_fwd.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:41"),
    ("K5-store joint_fwd_store", "joint_kernel", "joint_fwd_store", "joint_fwd.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:77"),
    ("K5-A joint_bwd_dh", "joint_kernel", "joint_bwd_dh", "joint_bwd.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:369"),
    ("K5-B joint_bwd_dw", "joint_kernel", "joint_bwd_dw", "joint_bwd.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:408"),
]
TRAIN_KERNELS = ("lstm_recurrence_sg", "lstm_recurrence_bwd", "joint_fwd_store",
                 "joint_bwd_dh", "joint_bwd_dw")


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


def module(name: str):
    from caiman_asr_tpu_torch.ops import joint_kernel, lstm_kernel

    return {"lstm_kernel": lstm_kernel, "joint_kernel": joint_kernel}[name]


def wrappers() -> dict:
    """Every kernel wrapper by its name."""
    return {wrapper: getattr(module(mod), wrapper) for _, mod, wrapper, _, _ in KERNELS}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def plain_path():
    """A context in which every kernel wrapper is its plain version."""
    import contextlib

    from caiman_asr_tpu_torch.ops import joint_kernel as jk
    from caiman_asr_tpu_torch.ops import lstm_kernel as lk

    stack = contextlib.ExitStack()
    for mod, name, plain in (
        (lk, "lstm_recurrence", lk.lstm_recurrence_plain),
        (lk, "lstm_recurrence_sg", lk.lstm_recurrence_sg_plain),
        (lk, "lstm_recurrence_bwd", lk.lstm_recurrence_bwd_plain),
        (jk, "joint_fwd", jk.joint_fwd_plain),
        (jk, "joint_fwd_store", jk.joint_fwd_store_plain),
        (jk, "joint_bwd_dh", jk.joint_bwd_dh_plain),
        (jk, "joint_bwd_dw", jk.joint_bwd_dw_plain),
    ):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and operations over the peak
    for the type: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def recurrence_bound_ms(T: int, dtype: str) -> tuple[float, str]:
    """Least time for one layer's recurrence: w_hh read once, gx read, ys and
    cs written, h0/c0 read, against HBM rate; 2*B*H*4H FLOPs per step against
    the peak for the type. Returns (ms, what bounds it)."""
    es = 4 if dtype == "float32" else 2
    nbytes = es * (4 * H * H + T * B * 4 * H + 2 * T * B * H + 2 * B * H)
    return bound_ms(nbytes, 2.0 * B * H * 4 * H * T, dtype)


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


# ------------------------------------------------------------ train path
def lstm_inputs(T: int, dtype, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = 1.0 / math.sqrt(H)
    gx = (torch.randn((T, B, 4 * H), generator=g, device="cuda") * 0.5).to(dtype)
    w_hh = ((torch.rand((4 * H, H), generator=g, device="cuda") * 2 - 1) * bound).to(dtype)
    h0 = (torch.randn((B, H), generator=g, device="cuda") * 0.1).to(dtype)
    c0 = (torch.randn((B, H), generator=g, device="cuda") * 0.1).to(dtype)
    dys = (torch.randn((T, B, H), generator=g, device="cuda") * 0.1).to(dtype)
    dcs = (torch.randn((T, B, H), generator=g, device="cuda") * 0.03).to(dtype)
    return gx, w_hh, h0, c0, dys, dcs


def max_err(got, want) -> float:
    return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))


def check_lstm_train(T: int, dtype_name: str, hard: bool, timed: bool) -> dict:
    """K3a and K3b against their plain versions on the card at [T, B, 4H];
    timed, also their times, bounds and the cuDNN yardsticks."""
    import torch

    from caiman_asr_tpu_torch.ops import lstm_kernel as lk

    dtype = getattr(torch, dtype_name)
    gx, w_hh, h0, c0, dys, dcs = lstm_inputs(T, dtype, 11 * T + int(hard))
    sg = lk.lstm_recurrence_sg(gx, w_hh, h0, c0, hard)
    torch.cuda.synchronize()
    sg_ref = lk.lstm_recurrence_sg_plain(gx, w_hh, h0, c0, hard)
    gs, cs = sg_ref[2], sg_ref[1]
    c_prev = torch.cat([c0[None], cs[:-1]])
    bwd_args = (gs, c_prev, cs, dys, dcs, w_hh, hard)
    bwd = lk.lstm_recurrence_bwd(*bwd_args)
    torch.cuda.synchronize()
    bwd_ref = lk.lstm_recurrence_bwd_plain(*bwd_args)
    scale = max(1.0, bwd_ref[0].float().abs().max().item())
    out = {"K3a": {"max_abs_err": max_err(sg, sg_ref), "tol": TOL[dtype_name]},
           "K3b": {"max_abs_err": max_err(bwd, bwd_ref), "tol": TOL[dtype_name] * scale}}
    for name, r in out.items():
        log(f"  {name} T={T} B={B} H={H} {dtype_name} hard={hard}: max|kernel - plain| = "
            f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g})")
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{name} disagrees with its plain version: {r}")
    if not timed:
        return out
    es = 4 if dtype_name == "float32" else 2
    k3a, k3b = out["K3a"], out["K3b"]
    k3a["ms"] = cuda_ms(lambda: lk.lstm_recurrence_sg(gx, w_hh, h0, c0, hard))
    k3a["plain_ms"] = cuda_ms(lambda: lk.lstm_recurrence_sg_plain(gx, w_hh, h0, c0, hard),
                              reps=3, warmup=1)
    k3a["bound_ms"], k3a["bound_by"] = bound_ms(
        es * (4 * H * H + 2 * T * B * 4 * H + 2 * T * B * H + 2 * B * H),
        2.0 * B * H * 4 * H * T, dtype_name)
    k3b["ms"] = cuda_ms(lambda: lk.lstm_recurrence_bwd(*bwd_args))
    k3b["plain_ms"] = cuda_ms(lambda: lk.lstm_recurrence_bwd_plain(*bwd_args), reps=3, warmup=1)
    k3b["bound_ms"], k3b["bound_by"] = bound_ms(
        es * (4 * H * H + 2 * T * B * 4 * H + 4 * T * B * H) + 4 * 2 * B * H,
        2.0 * B * 4 * H * H * (T + 1), dtype_name)
    # library yardsticks: one cuDNN LSTM layer, its training forward and its
    # backward (both also do the input-projection GEMMs, and the backward
    # the weight gradients)
    lib = torch.nn.LSTM(H, H, device="cuda", dtype=dtype)
    lib.flatten_parameters()
    x = torch.randn((T, B, H), device="cuda").to(dtype).requires_grad_()
    state = (h0[None], c0[None])
    k3a["library_ms"] = cuda_ms(lambda: lib(x, state))
    y, _ = lib(x, state)
    leaves = [x, *lib.parameters()]
    k3b["library_ms"] = cuda_ms(lambda: torch.autograd.grad(y, leaves, dys, retain_graph=True))
    for name, r in out.items():
        log(f"    {name}: kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | cuDNN {r['library_ms']:.4f} ms")
    return out


def joint_inputs(N: int, Hj: int, K: int, dtype, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.relu(torch.randn((N, Hj), generator=g, device="cuda")).to(dtype)
    wt = ((torch.rand((K, Hj), generator=g, device="cuda") * 2 - 1) / math.sqrt(Hj)).to(dtype)
    b = (torch.rand((K,), generator=g, device="cuda") * 2 - 1) / math.sqrt(Hj)
    labels = torch.randint(0, K - 1, (N,), generator=g, device="cuda", dtype=torch.int32)
    cb = torch.randn((N,), generator=g, device="cuda")
    cl = torch.randn((N,), generator=g, device="cuda")
    return h, wt, b, labels, cb, cl


def rel_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item() / max(
        want.float().abs().max().item(), 1e-30)


def check_joint(N: int, Hj: int, K: int, dtype_name: str, timed: bool) -> dict:
    """K2, K5-store, K5-A and K5-B against their plain versions on the card;
    timed, also their times, bounds and library yardsticks."""
    import torch

    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    dtype = getattr(torch, dtype_name)
    h, wt, b, labels, cb, cl = joint_inputs(N, Hj, K, dtype, N + K)
    sums, _ = jk.joint_fwd(h, wt, b)
    sums_s, u = jk.joint_fwd_store(h, wt, b)
    torch.cuda.synchronize()
    ref_sums, ref_u = jk.joint_fwd_store_plain(h, wt, b)
    cs = (cb + cl) / ref_sums  # the softmax row scale folded in, as the backward does
    w = wt.t().contiguous()
    smear = jk.joint_bwd_dh(ref_u, w, cs)
    dw, db = jk.joint_bwd_dw(h, ref_u, cs, cl, labels)
    torch.cuda.synchronize()
    ref_smear = jk.joint_bwd_dh_plain(ref_u, w, cs)
    ref_dw, ref_db = jk.joint_bwd_dw_plain(h, ref_u, cs, cl, labels)
    out = {
        "K2": {"rel_err": rel_err(sums, ref_sums), "tol": JOINT_RTOL,
               "max_abs_err": (sums.log() - ref_sums.log()).abs().max().item(),
               "err_of": "log of the row sums"},
        "K5-store": {"rel_err": max(rel_err(sums_s, ref_sums),
                                    ((u.float() - ref_u.float()).abs()
                                     / ref_u.float().abs().clamp_min(1e-30)).max().item()),
                     "tol": U_RTOL, "max_abs_err": (u.float() - ref_u.float()).abs().max().item(),
                     "err_of": "u"},
        "K5-A": {"rel_err": rel_err(smear, ref_smear), "tol": JOINT_RTOL,
                 "max_abs_err": (smear - ref_smear).abs().max().item(), "err_of": "smear"},
        "K5-B": {"rel_err": max(rel_err(dw, ref_dw), rel_err(db, ref_db)), "tol": JOINT_RTOL,
                 "max_abs_err": max((dw - ref_dw).abs().max().item(),
                                    (db - ref_db).abs().max().item()), "err_of": "dw, db"},
    }
    for name, r in out.items():
        log(f"  {name} N={N} Hj={Hj} K={K} {dtype_name}: relative err {r['rel_err']:.3g} "
            f"(tol {r['tol']:.3g}), max abs err of {r['err_of']} {r['max_abs_err']:.3g}")
        if not r["rel_err"] <= r["tol"]:
            raise AssertionError(f"{name} disagrees with its plain version: {r}")
    if not timed:
        return out
    es = 4 if dtype_name == "float32" else 2
    flops = 2.0 * N * Hj * K
    fwd_bytes = es * (N * Hj + K * Hj) + 4 * (K + N)
    bounds = {
        "K2": bound_ms(fwd_bytes, flops, dtype_name),
        "K5-store": bound_ms(fwd_bytes + 2 * N * K, flops, dtype_name),
        "K5-A": bound_ms(2 * N * K + es * Hj * K + 4 * N + 4 * N * Hj, flops, dtype_name),
        "K5-B": bound_ms(es * N * Hj + 2 * N * K + 12 * N + 4 * (Hj * K + K), flops,
                         dtype_name),
    }
    runs = {
        "K2": (lambda: jk.joint_fwd(h, wt, b), lambda: jk.joint_fwd_plain(h, wt, b)),
        "K5-store": (lambda: jk.joint_fwd_store(h, wt, b),
                     lambda: jk.joint_fwd_store_plain(h, wt, b)),
        "K5-A": (lambda: jk.joint_bwd_dh(ref_u, w, cs),
                 lambda: jk.joint_bwd_dh_plain(ref_u, w, cs)),
        "K5-B": (lambda: jk.joint_bwd_dw(h, ref_u, cs, cl, labels),
                 lambda: jk.joint_bwd_dw_plain(h, ref_u, cs, cl, labels)),
    }
    b_c, w_bf, u_c = b.to(dtype), w.to(torch.bfloat16), ref_u.to(dtype)
    lse = lambda: torch.logsumexp(torch.addmm(b_c, h, wt.t()), 1)
    library = {"K2": lse, "K5-store": lse, "K5-A": lambda: torch.matmul(ref_u, w_bf.t()),
               "K5-B": lambda: torch.matmul(h.t(), u_c)}
    for name, r in out.items():
        kernel, plain = runs[name]
        r["ms"] = cuda_ms(kernel, reps=5, warmup=1)
        r["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
        r["bound_ms"], r["bound_by"] = bounds[name]
        r["library_ms"] = cuda_ms(library[name], reps=5, warmup=1)
        log(f"    {name}: kernel {r['ms']:.3f} ms | plain {r['plain_ms']:.3f} ms | bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | library {r['library_ms']:.3f} ms")
    return out


def check_fused_joint_lse() -> None:
    """The whole joint forward + backward on the card, kernels against the
    plain route, N and K unaligned, the blank in a non-final tile."""
    import torch

    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    N, Hj, K, blank = 1000, 96, 1000, 100
    h, wt, b, labels, cb, cl = joint_inputs(N, Hj, K, torch.float32, 7)

    def run():
        leaves = [t.clone().requires_grad_() for t in (h, wt.t(), b)]
        lb, ll = jk.fused_joint_lse(*leaves, labels, blank)
        loss = (lb * cb).sum() + (ll * cl).sum()
        return (lb, ll) + torch.autograd.grad(loss, leaves)

    got = run()
    with plain_path():
        want = run()
    err = max(rel_err(g.detach(), w.detach()) for g, w in zip(got, want))
    log(f"  fused_joint_lse N={N} Hj={Hj} K={K} blank={blank} fp32, kernels vs plain "
        f"route: relative err {err:.3g} (tol {GRAD_RTOL})")
    if not err <= GRAD_RTOL:
        raise AssertionError(f"fused_joint_lse kernels vs plain route: {err}")


def train_batch(fp, n_classes: int, seed: int) -> dict:
    """The smoke utterances with U_MIN..U_MAX random tokens each, A = 1."""
    import numpy as np
    import torch

    audio_np, lens_np = synthetic_audio(seed)
    feats, feat_lens = fp(torch.from_numpy(audio_np).cuda(), torch.from_numpy(lens_np).cuda())
    rng = np.random.default_rng(seed + 2)
    u_lens = rng.integers(U_MIN, U_MAX + 1, N_UTTS)
    u_lens[0] = U_MAX
    txt = rng.integers(0, n_classes - 1, (N_UTTS, U_MAX))
    return {"feats": feats[None], "feat_lens": feat_lens[None],
            "txt": torch.from_numpy(txt).cuda()[None],
            "txt_lens": torch.from_numpy(u_lens).cuda()[None]}


def lattice_rows(batch, stack_time_factor: int) -> int:
    """B * T' * (U+1): the rows of the joint for ``batch``."""
    T_post = -(-batch["feats"].shape[1] // stack_time_factor)
    return batch["feats"].shape[2] * T_post * (batch["txt"].shape[2] + 1)


def run_train(batch, dtype_name: str) -> dict:
    """TRAIN_STEPS steps of base-85M on ``batch``; per step its time, loss,
    gradient norm, skip flag and kernel launches."""
    import torch

    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
    from caiman_asr_tpu_torch.training.step import init_train_state, make_train_step

    model = base_85m("cuda")
    opt = Lamb(OptimizerConfig(warmup_steps=0), model.param_lr_factors())
    state = init_train_state(model, opt, device="cuda")
    compute = None if dtype_name == "float32" else getattr(torch, dtype_name)
    step = make_train_step(model, opt, model.n_classes - 1, compute_dtype=compute,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen, SCALARS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        row = {"ms": ms, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "skipped": int(m["skipped"]), "launches": read_counts()}
        rows.append(row)
        log(f"  train {dtype_name} step {i + 1}: {ms:.1f} ms, loss {row['loss']:.4f}, "
            f"grad_norm {row['grad_norm']:.4f}, skipped {row['skipped']}")
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or any(r["skipped"] for r in rows):
        raise AssertionError(f"{dtype_name}: a loss is not finite or a step was skipped: {rows}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{dtype_name}: the loss did not fall: {losses}")
    counts = rows[-1]["launches"]
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    log(f"  train {dtype_name}: launches per step {counts}; peak memory {peak / 2**30:.2f} GiB")
    if missing:
        raise AssertionError(f"{dtype_name}: kernels not launched by the train step: {missing}")
    return {"rows": rows, "model": model, "opt": opt, "state": state, "gen": gen,
            "compute": compute, "peak_bytes": peak, "step": step}


def step_breakdown(run: dict, batch) -> dict:
    """Two more steps of ``run``'s model, phase by phase, each phase ending
    in a synchronise: ms per phase of the second (the first pays one-time
    allocations: it measured 3.8 s in the joint backward where the second
    measured 0.2 s)."""
    _step_phases(run, batch)
    times = _step_phases(run, batch)
    total = sum(times.values())
    log(f"  step breakdown, {'bf16' if run['compute'] is not None else 'fp32'} (ms, share): "
        + "; ".join(f"{k} {v:.1f} ({v / total:.0%})" for k, v in times.items()))
    return times


def _step_phases(run: dict, batch) -> dict:
    import torch

    from caiman_asr_tpu_torch.ops import transducer_loss as tl
    from caiman_asr_tpu_torch.training.step import _cast_compute
    from caiman_asr_tpu_torch.training.tree import tree_items

    model, state = run["model"], run["state"]
    mb = {k: v[0] for k, v in batch.items()}
    blank = model.n_classes - 1
    paths, leaves = zip(*tree_items(state.params))
    times = {}
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[name] = 1e3 * (now - last[0])
        last[0] = now

    p, feats = _cast_compute(state.params, mb["feats"], run["compute"])
    (f, f_lens), (g, _) = model.enc_pred(feats, mb["feat_lens"], mb["txt"], mb["txt_lens"],
                                         params=p, train=True, generator=run["gen"])
    mark("encoder + predictor forward (K3a)")
    w_fc, b_fc = p["joint_fc"]["w"], p["joint_fc"]["b"]
    lp_b, lp_l = tl._fused_joint_scores(f, g, w_fc, b_fc, mb["txt"], blank, run["gen"],
                                        model.cfg.joint_dropout)
    mark("joint forward (K5-store)")
    null, emit = tl._penalised_scores(lp_b, lp_l, mb["txt"], f_lens, tl.LossModifiers())
    loss = tl.rnnt_lattice(null, emit, f_lens, mb["txt_lens"]).sum() / mb["feats"].shape[1]
    mark("lattice forward")
    d_lp = torch.autograd.grad(loss, (lp_b, lp_l))
    mark("lattice backward")
    joint_in = (f, g, w_fc, b_fc)
    d_joint = torch.autograd.grad((lp_b, lp_l), joint_in, d_lp)
    mark("joint backward (K5-A, K5-B)")
    grads = torch.autograd.grad(joint_in, leaves, d_joint, allow_unused=True)
    mark("encoder + predictor backward (K3b)")
    run["opt"].update(state.params, state.ema_params, state.opt_state,
                      dict(zip(paths, grads)), True, 0.999)
    mark("optimizer (LAMB + EMA)")
    return times


def profile_step(run: dict, batch) -> dict:
    """One train step of ``run`` under torch.profiler: the device's busy
    share of the step's wall time and the device time per kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run["state"], _ = run["step"](run["state"], batch, run["gen"], SCALARS)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    log(f"  profiled step, {'bf16' if run['compute'] is not None else 'fp32'}: wall "
        f"{wall_ms:.1f} ms, device busy {busy:.1f} ms ({busy / wall_ms:.0%}); top kernels: "
        + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top))
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "top_kernels_ms": dict(top)}


def whole_step_check(batch) -> dict:
    """The loss and every gradient of one fp32 step with dropout off, at
    CHECK_B utterances: kernels against the plain path, on the card."""
    import dataclasses

    import torch

    from caiman_asr_tpu_torch.ops.transducer_loss import LossModifiers
    from caiman_asr_tpu_torch.training.step import _micro_loss
    from caiman_asr_tpu_torch.training.tree import tree_items

    model = base_85m("cuda")
    model.cfg = dataclasses.replace(model.cfg, enc_dropout=0.0, pred_dropout=0.0,
                                    joint_dropout=0.0)
    lens = batch["feat_lens"][0, :CHECK_B]
    T = int(lens.max())
    U = int(batch["txt_lens"][0, :CHECK_B].max())
    mb = {"feats": batch["feats"][0, :T, :CHECK_B], "feat_lens": lens,
          "txt": batch["txt"][0, :CHECK_B, :U], "txt_lens": batch["txt_lens"][0, :CHECK_B]}
    leaves = [leaf for _, leaf in tree_items(model.param_tree())]
    names = [".".join(path) for path, _ in tree_items(model.param_tree())]

    def grads():
        loss = _micro_loss(model, model.param_tree(), mb, None, LossModifiers(), CHECK_B,
                           model.n_classes - 1)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    reset_counts()
    loss_k, g_k = grads()
    counts = read_counts()
    with plain_path():
        loss_p, g_p = grads()
    if read_counts() != counts:
        raise AssertionError("the plain path launched a kernel")
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = {n: rel_err(a, b) for n, a, b in zip(names, g_k, g_p)}
    worst = max(errs, key=errs.get)
    log(f"  whole step, fp32, B={CHECK_B} T={T} U={U}: loss {float(loss_k):.6f} vs plain "
        f"{float(loss_p):.6f} (relative {loss_err:.3g}, tol {LOSS_RTOL}); worst gradient "
        f"{worst}: {errs[worst]:.3g} of its largest magnitude (tol {GRAD_RTOL}); kernel "
        f"launches {counts}")
    if not loss_err <= LOSS_RTOL or not errs[worst] <= GRAD_RTOL:
        raise AssertionError(f"the kernel path differs from the plain path: {loss_err}, {errs}")
    if any(counts[k] == 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"the kernel path did not launch every kernel: {counts}")
    return {"loss_rel_err": loss_err, "grad_rel_err": errs[worst], "worst": worst}


def val_check(model, batch) -> dict:
    """The validation loss through K2 (and K1) against the plain route."""
    import torch

    from caiman_asr_tpu_torch.training.step import make_val_loss_step

    vb = {k: v[0] for k, v in batch.items()}
    val = make_val_loss_step(model, model.n_classes - 1, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    s_k, n = val(model.param_tree(), vb)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    with plain_path():
        s_p, _ = val(model.param_tree(), vb)
    err = abs(float(s_k) - float(s_p)) / abs(float(s_p))
    log(f"  validation loss, fp32, B={int(n)}: {float(s_k) / n:.6f} per utterance "
        f"(plain route {float(s_p) / n:.6f}, relative {err:.3g}, tol {VAL_RTOL}); {ms:.1f} ms; "
        f"launches {counts}")
    if not err <= VAL_RTOL:
        raise AssertionError(f"validation loss, K2 route vs plain route: {err}")
    if counts["joint_fwd"] == 0 or counts["lstm_recurrence"] == 0:
        raise AssertionError(f"the validation loss did not launch K2 and K1: {counts}")
    if any(counts[k] for k in TRAIN_KERNELS):
        raise AssertionError(f"the validation loss launched a train kernel: {counts}")
    return {"ms": ms, "launches": counts, "loss": float(s_k) / n}


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
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.models.config import PipelineConfig, RNNTModelConfig
    from caiman_asr_tpu_torch.ops import cuda_build
    from caiman_asr_tpu_torch.ops.joint_kernel import store_plan
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig

    t_start = time.perf_counter()
    # 1. set-up
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"== setup: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}; {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_logs = cuda_build.build_kernels()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s into {cuda_build.BUILD_DIR}")
    for stem, text in build_logs.items():
        for line in text.strip().splitlines():
            log(f"  [{stem}] {line}")

    # 2. each kernel against its plain version
    log("== kernels vs plain versions")
    for dtype in ("float32", "bfloat16"):
        for hard in (False, True):
            check_recurrence(64, dtype, hard, timed=not hard)
            check_lstm_train(64, dtype, hard, timed=False)
        check_joint(1000, 96, 1000, dtype, timed=False)  # N and K unaligned
    check_fused_joint_lse()

    # 3. the slice at full width
    log("== slice: offline greedy transcription, base-85M")
    sl = run_slice()

    # 4. the train step at full width
    log("== train step: base-85M, B=16, A=1, LAMB (warmup 0, lr 4e-3)")
    fp = FeaturePipeline(PipelineConfig(logmel=LogMelConfig(dither=0.0)), device="cuda")
    batch = train_batch(fp, 8704, SEED)
    N = lattice_rows(batch, RNNTModelConfig().enc_stack_time_factor)
    plan = store_plan(N, 768, 8704)
    log(f"  batch: T={batch['feats'].shape[1]} (pre-stack), U={batch['txt'].shape[2]}, "
        f"lattice rows N={N}; u slab: {plan['dtype']} over {plan['cols']} of "
        f"{plan['Kp']} padded columns (Np={plan['Np']}), {plan['slab_bytes']} bytes")
    if plan["dtype"] != "bf16":
        raise AssertionError(f"the smoke cell should store the bf16 slab: {plan}")
    runs, breakdown, profiled = {}, {}, {}
    for dtype in ("bfloat16", "float32"):
        runs[dtype] = run_train(batch, dtype)
        breakdown[dtype] = step_breakdown(runs[dtype], batch)
        profiled[dtype] = profile_step(runs[dtype], batch)

    # 5. the whole step against its plain path
    log("== whole step: kernels vs plain path")
    whole = whole_step_check(batch)

    # 6. the validation loss
    log("== validation loss")
    val = val_check(runs["float32"]["model"], batch)
    for run in runs.values():
        for k in ("model", "opt", "state", "step"):
            run.pop(k)
    torch.cuda.empty_cache()

    # 7. every kernel at the main path's shapes
    log("== kernels at the main path's shapes")
    per_shape = {}
    for name in ("float32", "bfloat16"):
        for T in (sl["T_pre"], sl["T_post"]):
            per_shape[(name, T)] = check_recurrence(T, name, False, timed=True)
    lstm_train = check_lstm_train(sl["T_pre"], "bfloat16", False, timed=True)
    joint = check_joint(N, 768, 8704, "bfloat16", timed=True)

    train_counts = runs["bfloat16"]["rows"][-1]["launches"]
    layer = f"T={sl['T_pre']} B={B} H={H} bfloat16 (one encoder layer)"
    joint_shape = f"N={N} Hj=768 K=8704 bfloat16"
    rows = {
        "lstm_recurrence": (per_shape[("bfloat16", sl["T_pre"])], sl["bfloat16"]["launches"],
                            layer, "transcription"),
        "lstm_recurrence_sg": (lstm_train["K3a"], train_counts["lstm_recurrence_sg"], layer,
                               "train step"),
        "lstm_recurrence_bwd": (lstm_train["K3b"], train_counts["lstm_recurrence_bwd"], layer,
                                "train step"),
        "joint_fwd": (joint["K2"], val["launches"]["joint_fwd"], joint_shape,
                      "validation batch"),
        "joint_fwd_store": (joint["K5-store"], train_counts["joint_fwd_store"], joint_shape,
                            "train step"),
        "joint_bwd_dh": (joint["K5-A"], train_counts["joint_bwd_dh"], joint_shape, "train step"),
        "joint_bwd_dw": (joint["K5-B"], train_counts["joint_bwd_dw"], joint_shape, "train step"),
    }
    kernels = []
    for name, _, wrapper, src, replaces in KERNELS:
        r, launches, shape, per = rows[wrapper]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"caiman_asr_tpu_torch/ops/csrc/{src}", "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": shape, "launches_per": per,
        })
    summary = {dt: {"step_ms": [r["ms"] for r in run["rows"]],
                    "loss": [r["loss"] for r in run["rows"]],
                    "grad_norm": [r["grad_norm"] for r in run["rows"]],
                    "peak_gib": run["peak_bytes"] / 2 ** 30, "breakdown_ms": breakdown[dt],
                    "profile": profiled[dt]}
               for dt, run in runs.items()}
    log("train summary: " + json.dumps({"train": summary, "whole_step": whole,
                                        "validation": val, "store_plan": plan}))
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
