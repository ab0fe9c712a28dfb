#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (caiman_asr_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases:
  1. set-up: card name and power limit, kernel build (nvcc, into
     build/kernels/), TF32 off;
  2. every kernel against its plain PyTorch version at small unaligned
     shapes (the per-pass recompute also over a range of vocab columns; the
     wavefront at G = 1, 2, 3, soft and hard, masks on and off, and at
     base-85M's post-stack width, G=6, where most of each block's rows
     stream), at large-196M's LSTM widths, and every joint kernel once past
     2^31 slab elements (N = 131,072 rows at large-196M's Hj and K);
  3. the slice at full width: base-85M (random weights from a seeded
     generator) transcribes 16 synthetic utterances offline with greedy
     decoding, in fp32 and bf16; the launch counts must equal the expected
     number and the fp32 result must equal the plain path's;
  4. the train step at full width: base-85M with its dropouts takes LAMB
     steps on one batch of the same 16 utterances with random transcripts,
     in bf16 and in fp32 compute; every loss finite, none skipped, the loss
     falling; every kernel of the path launched; a timed breakdown of one
     step;
  5. the whole step held against its plain path: at a reduced batch, fp32,
     dropout off, the loss and every gradient from the kernels against the
     same with every kernel swapped for its plain version;
  6. the validation loss through K2 against the plain route;
  7. large-196M at full width on that batch and on it tiled 2x and 4x: the
     store policy's route at each batch size (bf16 slab, int8 slab, no
     slab) shown by the launch counts, bf16 steps and one fp32 step each,
     breakdowns, the routes against each other and each against its plain
     path, the validation loss and offline transcription;
  7b. large-196M at full width forced, by the policy's knobs, onto each
     remaining route of the joint's backward: the fused stored-u backward
     (B=16), the two-kernel int8 backward (B=32), the rechunked backward and
     the per-pass recompute (B=64), the hybrid split (B=32); two bf16 steps
     each, the route shown by the launch counts; then each of these routes
     against its plain path and against the bf16-slab route;
  8. every kernel at the main path's shapes against its plain version, with
     times beside the bound and the library call (the LSTM kernels, one
     launch a layer, at a base-85M encoder layer and at large-196M's
     post-stack layer at B=64, bf16 and fp32: the median of 5 rounds, µs a
     step, their plan and step floor, and cuDNN's layer, training forward
     and backward as the median of 5 rounds, also less the GEMMs it does
     beside the recurrence, in the lstm summary; K8-fwd and K8-bwd at
     base-85M's post-stack, G=6, beside cuDNN's 6-layer nn.LSTM, and in
     the k8 summary in bf16 and fp32 with their plan, µs a superstep and
     superstep floor, fp32 beside the per-superstep kernels' time), the bf16
     derivation alone beside a fill of the bytes it stores, and the plans
     of the bf16 passes A and B, the forward and the derivation (staging,
     tile, cluster, grid, waves) in the pass A, pass B, forward and derive
     summaries;
  9. the wavefront multi-layer LSTM (run_lstm_stack_wavefront, K8-fwd and
     K8-bwd) at full width, bf16, forward and forward + backward: base-85M's
     and large-196M's post-stacks (G=6) and the JAX A/B script's default
     (G=2, H=1536, B=96, T=200), one case with dropout 0.1; the launches
     counted (one a call); each against the plain path (the fp32 forward,
     the bf16 gradients); each shape's plans, kernel times and superstep
     floors; the per-layer stack timed beside it.

Prints the kernels line and, last, {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; without a GPU it exits non-zero at once.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
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

# The two product models with their numbers written out (the machine with
# the card has no YAML reader): `__graft_entry__.py:14-27` /
# `configs/base-8703sp.yaml` and `configs/large-17407sp.yaml`; the classes
# are the sentencepieces plus the blank.
MODELS = {
    "base-85M": (dict(
        in_feats=240, enc_n_hid=1024, enc_pre_rnn_layers=2, enc_post_rnn_layers=6,
        enc_stack_time_factor=2, pred_n_hid=512, pred_rnn_layers=2, joint_n_hid=768), 8704),
    "large-196M": (dict(
        in_feats=240, enc_n_hid=1536, enc_pre_rnn_layers=2, enc_post_rnn_layers=6,
        enc_stack_time_factor=2, enc_dropout=0.1, enc_batch_norm=False, enc_freeze=False,
        pred_n_hid=768, pred_rnn_layers=2, pred_dropout=0.3, pred_batch_norm=False,
        joint_n_hid=1024, joint_dropout=0.3, joint_net_lr_factor=0.243, forget_gate_bias=1.0,
        quantize=False, enc_rw_dropout=0.0, pred_rw_dropout=0.0), 17408),
}

B, H = 16, 1024
N_UTTS, MIN_S, MAX_S, SR = 16, 2.0, 8.0, 16000
SEED = 0
# A random joint almost never ranks blank first among thousands of classes,
# so greedy decoding would emit the maximum number of symbols on every frame.
# The blank bias is raised so that blank wins all but EMIT_SHARE of
# the decisions, near what a trained model emits; it also keeps
# most greedy decisions far from ties between the kernel and plain paths.
EMIT_SHARE = 0.1
CALIB_TOKENS = 4
MIN_START_EMIT = 0.01

# the train phase: transcripts of U_MIN..U_MAX random tokens, A = 1
U_MIN, U_MAX = 16, 64
TRAIN_STEPS = 5        # base-85M, per dtype
LARGE_STEPS = 3        # large-196M, bf16, per batch size (and one fp32 step)
LARGE_TILES = (1, 2, 4)  # the batch of 16 tiled to B = 16, 32, 64
SCALARS = {"delay_penalty": 0.0, "star_penalty": 0.0}
# the whole-step check: the first CHECK_B utterances, fp32, dropout off.
# Tolerances: the loss 1e-5 relative (sums in another order); a gradient
# 1e-3 of its largest magnitude (both paths round u = exp(z) to bf16 for the
# backward, and a rounding that falls the other way moves a term by one bf16
# ulp, 2^-8, of a softmax numerator; on the int8 route one step, 1/127)
CHECK_B = 4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
# the routes against each other, each gradient against the bf16-slab route's,
# of its largest magnitude: the no-slab route differs by the bf16 rounding of
# u; the int8 route quantises u to 1/127 of each tile's maximum (the JAX
# package's own bound for that route, tests/ops/test_pallas_joint.py)
ROUTE_RTOL = {"i8": 5e-2, "i8_two": 5e-2, None: 1e-3, "fused_u": 1e-3, "rechunk": 1e-3,
              "recompute": 1e-3, "hybrid": 1e-3}
# the joint kernels against their plain versions: 1e-4 of the output's scale
# (fp32 accumulation in another order); u one bf16 ulp (2^-7 relative);
# K6-fused with bf16 inputs 1e-3, since it rounds u and dz to bf16 inside
# from values that differ in their last fp32 bits from the plain version's,
# and a rounding that falls the other way moves one term by 2^-8; the same
# for K6-derive-a, K4-A and K4-B, which round what they derive
JOINT_RTOL, U_RTOL, FUSED_BF16_RTOL = 1e-4, 2 ** -7, 1e-3
# the int8 slab: entries equal to the plain version's or one step apart on at
# most Q_SHARE of them (u * (127 / m) differs in its last bit at a rounding
# boundary); the scales, each one value of u, as the row sums
Q_SHARE, SCALE_RTOL = 1e-3, 1e-5
# the validation loss, K2 route against the plain route (sums in another
# order over H and over the classes)
VAL_RTOL = 1e-5
# past 2^31 elements of an [N, K] slab at large-196M's widths
BIG_N, BIG_HJ, BIG_K = 131072, 1024, 17408

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
    ("K7-store8 joint_fwd_store8", "joint_kernel", "joint_fwd_store8", "joint_fwd.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:110"),
    ("K7-fused-u8 joint_bwd_fused_u8", "joint_kernel", "joint_bwd_fused_u8",
     "joint_bwd_fused.cu", "caiman_asr_tpu/ops/pallas_joint.py:314"),
    ("K6-fused joint_bwd_fused", "joint_kernel", "joint_bwd_fused", "joint_bwd_fused.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:190"),
    ("K5-fused-u joint_bwd_fused_u", "joint_kernel", "joint_bwd_fused_u", "joint_bwd_fused.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:258"),
    ("K7-A8 joint_bwd_dh_u8", "joint_kernel", "joint_bwd_dh_u8", "joint_bwd.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:388"),
    ("K7-B8 joint_bwd_dw_u8", "joint_kernel", "joint_bwd_dw_u8", "joint_bwd.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:459"),
    ("K6-derive-a joint_derive_a", "joint_kernel", "joint_derive_a", "joint_bwd_recompute.cu",
     "caiman_asr_tpu/ops/pallas_joint.py:165"),
    ("K4-A joint_bwd_dh_recompute", "joint_kernel", "joint_bwd_dh_recompute",
     "joint_bwd_recompute.cu", "caiman_asr_tpu/ops/pallas_joint.py:144"),
    ("K4-B joint_bwd_dw_recompute", "joint_kernel", "joint_bwd_dw_recompute",
     "joint_bwd_recompute.cu", "caiman_asr_tpu/ops/pallas_joint.py:502"),
    ("K8-fwd lstm_wavefront", "wavefront_kernel", "lstm_wavefront", "lstm_wavefront.cu",
     "caiman_asr_tpu/ops/pallas_wavefront.py:85"),
    ("K8-bwd lstm_wavefront_bwd", "wavefront_kernel", "lstm_wavefront_bwd",
     "lstm_wavefront_bwd.cu", "caiman_asr_tpu/ops/pallas_wavefront.py:234"),
]
# Wrappers counted and swapped for their plain versions like those above,
# with no row of their own: K8-fwd storing its gates (the K8-fwd row reports
# it beside the plain forward, as one Pallas kernel does both).
MORE_WRAPPERS = (("wavefront_kernel", "lstm_wavefront_sg"),)
LSTM_TRAIN_KERNELS = ("lstm_recurrence_sg", "lstm_recurrence_bwd")
# Phase 9, the wavefront at full width: (G, H, I0, B, T; None is the smoke
# batch's encoder T after stacking). The post-stacks of base-85M and
# large-196M (input 2H after stacking by 2), and the JAX A/B script's
# default (`scripts/bench_wavefront.py`: G=2, H=1536, B=96, T=200, I0=H).
WAVEFRONT_SHAPES = {
    "base-85M post-stack": (6, 1024, 2048, 16, None),
    "large-196M post-stack": (6, 1536, 3072, 32, None),
    "JAX A/B default": (2, 1536, 1536, 96, 200),
}
WAVEFRONT_DROPOUT = 0.1  # large-196M's enc_dropout, on its shape
# K8 in fp32 at base-85M's post-stack (G=6, T=134, B=16, H=1024), ms a call,
# forward and backward: the per-superstep kernels the persistent ones
# replaced, as PERF.md §6 records them (bench_wavefront.kernel_times run
# from the older checkout, its first reading in the A/B of the two on one
# NVIDIA H100 80GB HBM3 at 700 W)
K8_PER_SUPERSTEP_FP32_MS = (19.655, 26.798)
# the fp32 forward against the plain path at full width: 1e-3 (fp32 sums in
# another order over 2H = 3072, carried through 134 steps and 6 layers)
WAVEFRONT_FWD_TOL = 1e-3
# The routes of the joint under a gradient: the three the default policy
# takes, named by the slab its plan stores ("bf16", "i8", None), and the five
# the policy's knobs lead to. Per route: the joint kernels a train step
# launches (and no other route's) and a name.
ROUTE_KERNELS = {
    "bf16": ("joint_fwd_store", "joint_bwd_dh", "joint_bwd_dw"),
    "i8": ("joint_fwd_store8", "joint_bwd_fused_u8"),
    None: ("joint_fwd", "joint_bwd_fused"),
    "fused_u": ("joint_fwd_store", "joint_bwd_fused_u"),
    "i8_two": ("joint_fwd_store8", "joint_bwd_dh_u8", "joint_bwd_dw_u8"),
    "rechunk": ("joint_fwd", "joint_derive_a", "joint_bwd_dw"),
    "recompute": ("joint_fwd", "joint_bwd_dh_recompute", "joint_bwd_dw_recompute"),
    "hybrid": ("joint_fwd_store", "joint_fwd", "joint_bwd_dh", "joint_bwd_dw",
               "joint_bwd_dh_recompute", "joint_bwd_dw_recompute"),
}
ROUTE_NAME = {
    "bf16": "bf16 slab (K5-store, K5-A, K5-B)", "i8": "int8 slab (K7-store8, K7-fused-u8)",
    None: "no slab (K2, K6-fused)", "fused_u": "bf16 slab, fused (K5-store, K5-fused-u)",
    "i8_two": "int8 slab, two kernels (K7-store8, K7-A8, K7-B8)",
    "rechunk": "no slab, rechunked (K2, K6-derive-a + K5-B per row chunk)",
    "recompute": "no slab, per-pass recompute (K2, K4-A, K4-B)",
    "hybrid": "hybrid split (K5-store + K2, K5-A + K5-B, K4-A + K4-B)",
}
# what the plan must say on a knob's route: (the slab's dtype, the backward
# over the stored columns); only the hybrid split stores some of the columns
ROUTE_PLAN = {"fused_u": ("bf16", "K5-fused-u"), "i8_two": ("i8", "K7-A8 + K7-B8"),
              "rechunk": (None, "K6-derive-a + K5-B"), "recompute": (None, "K4-A + K4-B"),
              "hybrid": ("bf16", "K5-A + K5-B")}
# The knobs a user sets to reach each of the five (the attributes of
# joint_kernel that the CAIMAN_JOINT_* variables set), and the batch of 16
# tiled to the size at which the default budgets then lead there.
KNOBS = {"fused_u": dict(FUSED_BWD=True), "i8_two": dict(FUSED_BWD=False),
         "rechunk": dict(FUSED_BWD=False),
         "recompute": dict(FUSED_BWD=False, RECHUNK_LIMIT_BYTES=0),
         "hybrid": dict(Z_STORE_PARTIAL=True)}
KNOB_TILES = {"fused_u": 1, "i8_two": 2, "rechunk": 4, "recompute": 4, "hybrid": 2}
KNOB_STEPS = 2  # bf16 steps per forced route
# The plan forced whatever the batch's size (the small whole-step checks).
# The hybrid split's budget is set from the rows: half the vocab tiles.
SLAB = {"bf16": (1 << 62, "bf16"), "i8": (1 << 62, "i8"), None: (0, "auto"),
        "fused_u": (1 << 62, "bf16"), "i8_two": (1 << 62, "i8"), "rechunk": (0, "auto"),
        "recompute": (0, "auto")}
JOINT_KERNELS = ("K2", "K5-store", "K7-store8", "K5-A", "K5-B", "K7-fused-u8", "K6-fused",
                 "K5-fused-u", "K7-A8", "K7-B8", "K6-derive-a", "K4-A", "K4-B")


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
    from caiman_asr_tpu_torch.ops import joint_kernel, lstm_kernel, wavefront_kernel

    return {"lstm_kernel": lstm_kernel, "joint_kernel": joint_kernel,
            "wavefront_kernel": wavefront_kernel}[name]


def wrapper_names() -> list:
    """(module, wrapper) of every counted kernel wrapper."""
    return [(mod, wrapper) for _, mod, wrapper, _, _ in KERNELS] + list(MORE_WRAPPERS)


def wrappers() -> dict:
    """Every kernel wrapper by its name."""
    return {wrapper: getattr(module(mod), wrapper) for mod, wrapper in wrapper_names()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def plain_path():
    """A context in which every kernel wrapper is its plain version."""
    stack = contextlib.ExitStack()
    for mod, wrapper in wrapper_names():
        stack.enter_context(mock.patch.object(module(mod), wrapper,
                                              getattr(module(mod), wrapper + "_plain")))
    return stack


@contextlib.contextmanager
def policy(**attrs):
    """The store policy's attributes (of ``joint_kernel``) set for a while."""
    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    with contextlib.ExitStack() as stack:
        for name, value in attrs.items():
            stack.enter_context(mock.patch.object(jk, name, value))
        yield


def forced_route(route, rows: int = 0, Hj: int = 0, K: int = 0):
    """The joint forced onto ``route`` (a key of ROUTE_KERNELS) whatever the
    batch's size; the hybrid split needs the rows and widths to set a budget
    that holds half the vocab tiles."""
    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    if route == "hybrid":
        tp, kt = jk._tiles(Hj)[:2]
        limit = -(-rows // tp) * tp * 2 * kt * (-(-K // kt) // 2)
        return policy(Z_STORE_LIMIT_BYTES=limit, **KNOBS[route])
    limit, dtype = SLAB[route]
    return policy(Z_STORE_LIMIT_BYTES=limit, _ZSTORE_DTYPE=dtype, **KNOBS.get(route, {}))


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and operations over the peak
    for the type: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def recurrence_bound_ms(T: int, dtype: str, B: int = B, H: int = H) -> tuple[float, str]:
    """Least time for one layer's recurrence: w_hh read once, gx read, ys and
    cs written, h0/c0 read, against HBM rate; 2*B*H*4H FLOPs per step against
    the peak for the type. Returns (ms, what bounds it)."""
    es = 4 if dtype == "float32" else 2
    nbytes = es * (4 * H * H + T * B * 4 * H + 2 * T * B * H + 2 * B * H)
    return bound_ms(nbytes, 2.0 * B * H * 4 * H * T, dtype)


def check_recurrence(T: int, dtype_name: str, hard: bool, B: int = B, H: int = H) -> dict:
    """K1 vs its plain version on the card at [T, B, 4H]."""
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


def model_config(name: str):
    """The ``rnnt`` configuration of one of MODELS."""
    from caiman_asr_tpu_torch.models.config import RNNTModelConfig

    return RNNTModelConfig(**MODELS[name][0])


def build_model(name: str, device: str):
    """One of MODELS at full width and depth, weights drawn from SEED."""
    import torch

    from caiman_asr_tpu_torch.models.rnnt import RNNT

    model = RNNT(model_config(name), MODELS[name][1], device=device)
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


def run_slice(name: str = "base-85M") -> dict:
    import torch

    from caiman_asr_tpu_torch import offline
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.ops import lstm_kernel
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig

    model = build_model(name, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    if not all(p.device.type == "cuda" for p in model.parameters()):
        raise AssertionError("model parameters are not all on the GPU")
    log(f"  {name}: {n_params} parameters, all on {torch.cuda.get_device_name(0)}")

    audio_np, lens_np = synthetic_audio(SEED)
    audio = torch.from_numpy(audio_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    audio_secs = float(lens_np.sum()) / SR
    pipe = PipelineConfig(logmel=LogMelConfig(dither=0.0))
    fp = FeaturePipeline(pipe, device="cuda")

    feats, feat_lens = fp(audio, lens)
    T_pre = feats.shape[0]
    T_post = -(-T_pre // model.cfg.enc_stack_time_factor)
    expected = model.cfg.enc_pre_rnn_layers + model.cfg.enc_post_rnn_layers  # one a layer
    log(f"  {N_UTTS} utterances, {audio_secs:.2f} s of audio; encoder T={T_pre} "
        f"(pre) / {T_post} (post), B={N_UTTS}")
    log(f"  blank bias raised by {calibrate_blank(model, feats, feat_lens):.4f} "
        f"(emit share {EMIT_SHARE}, start-state floor {MIN_START_EMIT})")

    out = {"T_pre": T_pre, "T_post": T_post, "expected_launches": expected}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        responses = offline.transcribe(model, audio, lens, device="cuda", dtype=dtype,
                                       pipeline=pipe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lstm_kernel.lstm_recurrence.launches
        log(f"  transcribe {dname}: {wall * 1e3:.1f} ms, "
            f"{audio_secs / wall:.1f} audio-s/s; lstm_recurrence_fwd launches "
            f"{launches} (expected {expected})")
        if launches != expected:
            raise AssertionError(f"{dname}: {launches} launches, expected {expected}")
        out[dname] = {"responses": responses, "launches": launches, "wall_s": wall}

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
        out[dname].update(featurize_ms=1e3 * (t1 - t0), encode_ms=1e3 * (t2 - t1),
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
    for dname in ("float32", "bfloat16"):
        e = out[dname]["encs"]
        if not (torch.isfinite(e).all() and e.shape == (N_UTTS, T_post, model.cfg.joint_n_hid)):
            raise AssertionError(f"{dname} encoder output is not finite or has shape {e.shape}")

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
    for dname in ("float32", "bfloat16"):
        for k in ("encs", "enc_lens", "responses"):
            out[dname].pop(k)
    return out


# ------------------------------------------------------------ train path
def lstm_inputs(T: int, dtype, seed: int, B: int = B, H: int = H):
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


def check_lstm_train(T: int, dtype_name: str, hard: bool, B: int = B, H: int = H) -> dict:
    """K3a and K3b against their plain versions on the card at [T, B, 4H]."""
    import torch

    from caiman_asr_tpu_torch.ops import lstm_kernel as lk

    dtype = getattr(torch, dtype_name)
    gx, w_hh, h0, c0, dys, dcs = lstm_inputs(T, dtype, 11 * T + int(hard), B, H)
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
    return out


def time_lstm(T: int, B: int, H: int, dtype_name: str = "bfloat16") -> dict:
    """K1, K3a and K3b at [T, B, 4H] (``bench_lstm``): the median of 5
    rounds and their spread, µs per step, the plan, the step floor (the
    plan's grid passing only its barriers); the plain versions' times; the
    bounds; cuDNN's layer (K1), training forward (K3a) and backward (K3b) as
    the library times, the median of 5 rounds, and each also less the GEMMs
    cuDNN does beside the recurrence, timed alone."""
    import torch

    from caiman_asr_tpu_torch import bench_lstm
    from caiman_asr_tpu_torch.ops import lstm_kernel as lk

    dtype = getattr(torch, dtype_name)
    out = bench_lstm.time_kernels(T, B, H, dtype, rounds=5)
    yard = bench_lstm.cudnn_yardsticks(T, B, H, dtype, rounds=5)
    fwd, bwd = bench_lstm.layer_inputs(T, B, H, dtype)
    es = 4 if dtype_name == "float32" else 2
    k1, k3a, k3b = out["K1"], out["K3a"], out["K3b"]
    k1["plain_ms"] = cuda_ms(lambda: lk.lstm_recurrence_plain(*fwd, False), reps=3, warmup=1)
    k3a["plain_ms"] = cuda_ms(lambda: lk.lstm_recurrence_sg_plain(*fwd, False), reps=3, warmup=1)
    k3b["plain_ms"] = cuda_ms(lambda: lk.lstm_recurrence_bwd_plain(*bwd, False), reps=3,
                              warmup=1)
    k1["bound_ms"], k1["bound_by"] = recurrence_bound_ms(T, dtype_name, B, H)
    k3a["bound_ms"], k3a["bound_by"] = bound_ms(
        es * (4 * H * H + 2 * T * B * 4 * H + 2 * T * B * H + 2 * B * H),
        2.0 * B * H * 4 * H * T, dtype_name)
    k3b["bound_ms"], k3b["bound_by"] = bound_ms(
        es * (4 * H * H + 2 * T * B * 4 * H + 4 * T * B * H) + 4 * 2 * B * H,
        2.0 * B * 4 * H * H * (T + 1), dtype_name)
    for r, lib, less, gemms in ((k1, "layer", "layer_less_gemm_ms", "input_gemm_ms"),
                                (k3a, "train_forward", "train_forward_less_gemm_ms",
                                 "input_gemm_ms"),
                                (k3b, "backward", "backward_less_gemms_ms", "backward_gemms_ms")):
        r.update(library_ms=yard[lib]["ms"], library_spread=yard[lib]["spread"],
                 library_less_gemms_ms=yard[less], kernel_plus_gemms_ms=r["ms"] + yard[gemms],
                 library_flat_weights=yard["flat_weights"])
    for name, r in out.items():
        log(f"    {name} T={T} B={B} H={H} {dtype_name}: kernel {r['ms']:.4f} ms "
            f"({r['us_per_step']:.2f} us a step, spread {r['spread']:.3f}; floor "
            f"{r['floor_us_per_step']:.2f} us) | plain {r['plain_ms']:.4f} | bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) | cuDNN {r['library_ms']:.4f} (spread "
            f"{r['library_spread']:.3f}; less its GEMMs {r['library_less_gemms_ms']:.4f}; "
            f"kernel + those GEMMs {r['kernel_plus_gemms_ms']:.4f}; weights flat: "
            f"{r['library_flat_weights']})")
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


def slab_errs(got, want, rows: int = 16384) -> tuple[float, float, float]:
    """(largest absolute, largest relative difference, share of entries that
    differ) of two [N, K] slabs, walked in row chunks so that the fp32
    copies stay small."""
    worst_abs = worst_rel = differ = 0.0
    for lo in range(0, got.shape[0], rows):
        a, b = got[lo:lo + rows].float(), want[lo:lo + rows].float()
        d = (a - b).abs()
        worst_abs = max(worst_abs, d.max().item())
        worst_rel = max(worst_rel, (d / b.abs().clamp_min(1e-30)).max().item())
        differ += (d != 0).sum().item()
    return worst_abs, worst_rel, differ / got.numel()


def peak_extra(fn):
    """(fn(), the bytes it allocated at its peak beyond what was held)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = fn()
    torch.cuda.synchronize()
    return got, torch.cuda.max_memory_allocated() - before


def check_joint(N: int, Hj: int, K: int, dtype_name: str, timed: bool,
                only: tuple = JOINT_KERNELS, reps: int = 5, cols: tuple = (0, None)) -> dict:
    """The joint kernels named in ``only`` against their plain versions on
    the card at [N, Hj] x [Hj, K]; timed, also their times, bounds and
    library yardsticks. Slabs are made once, by the plain versions, and every
    backward kernel and its plain version read the same one. ``cols``: the
    range of vocab columns K4-A and K4-B take, the labels shifted to it."""
    import torch

    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    dtype = getattr(torch, dtype_name)
    h, wt, b, labels, cb, cl = joint_inputs(N, Hj, K, dtype, N + K)
    w = wt.t().contiguous()
    kt = jk._tiles(Hj)[1]
    n_kt = -(-K // kt)
    ref_sums, _ = jk.joint_fwd_plain(h, wt, b)
    cs = (cb + cl) / ref_sums  # the softmax row scale folded in, as the backward does
    ref_u = (jk.joint_fwd_store_plain(h, wt, b)[1]
             if {"K5-store", "K5-A", "K5-B", "K5-fused-u"} & set(only) else None)
    ref_q, ref_s = (jk.joint_fwd_store8_plain(h, wt, b, kt)[1:]
                    if {"K7-store8", "K7-fused-u8", "K7-A8", "K7-B8"} & set(only)
                    else (None, None))
    fused_tol = JOINT_RTOL if dtype_name == "float32" else FUSED_BF16_RTOL
    # the per-pass recompute: the unscaled coefficient, the row's log-sum-exp
    # over all K, the column range and the labels relative to its start
    c, denom = cb + cl, ref_sums.log()
    lo, hi = cols[0], K if cols[1] is None else cols[1]
    Kc, rel = hi - lo, labels - cols[0]

    def three(got, want, tol):
        return {"rel_err": max(rel_err(g, r) for g, r in zip(got, want)), "tol": tol,
                "max_abs_err": max((g - r).abs().max().item() for g, r in zip(got, want)),
                "err_of": "smear, dw, db"}

    def k2():
        sums, _ = jk.joint_fwd(h, wt, b)
        return {"rel_err": rel_err(sums, ref_sums), "tol": JOINT_RTOL,
                "max_abs_err": (sums.log() - ref_sums.log()).abs().max().item(),
                "err_of": "log of the row sums"}

    def k5_store():
        sums, u = jk.joint_fwd_store(h, wt, b)
        u_abs, u_rel, _ = slab_errs(u, ref_u)
        return {"rel_err": max(rel_err(sums, ref_sums), u_rel), "tol": U_RTOL,
                "max_abs_err": u_abs, "err_of": "u"}

    def k7_store8():
        sums, q, s = jk.joint_fwd_store8(h, wt, b, kt)
        q_abs, _, share = slab_errs(q, ref_q)
        s_rel = ((s - ref_s).abs() / ref_s.abs().clamp_min(1e-30)).max().item()
        ok = (rel_err(sums, ref_sums) <= JOINT_RTOL and s_rel <= SCALE_RTOL and q_abs <= 1
              and share <= Q_SHARE and int(q.max()) == 127 and int(q.min()) >= 0)
        log(f"    K7-store8: scales relative err {s_rel:.3g} (tol {SCALE_RTOL}); q differs by "
            f"at most {q_abs:.0f} step on a share {share:.3g} of entries (tol {Q_SHARE})")
        # rel_err: the share of entries one step apart, against Q_SHARE
        return {"rel_err": share if ok else float("inf"), "tol": Q_SHARE,
                "max_abs_err": q_abs, "err_of": "q (int8 steps)"}

    def same_twice(name, call):
        """call() twice; the two results must be equal bit for bit."""
        got, again = call(), call()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name}: two calls on the same inputs differ")
        return got

    def k5_a():
        smear = same_twice("K5-A", lambda: (jk.joint_bwd_dh(ref_u, w, cs),))[0]
        ref = jk.joint_bwd_dh_plain(ref_u, w, cs)
        return {"rel_err": rel_err(smear, ref), "tol": JOINT_RTOL,
                "max_abs_err": (smear - ref).abs().max().item(), "err_of": "smear"}

    def k5_b():
        got = same_twice("K5-B", lambda: jk.joint_bwd_dw(h, ref_u, cs, cl, labels))
        want = jk.joint_bwd_dw_plain(h, ref_u, cs, cl, labels)
        return {**three(got, want, JOINT_RTOL), "err_of": "dw, db"}

    def k7_fused_u8():
        return three(jk.joint_bwd_fused_u8(h, ref_q, ref_s, w, cs, cl, labels, kt),
                     jk.joint_bwd_fused_u8_plain(h, ref_q, ref_s, w, cs, cl, labels, kt),
                     JOINT_RTOL)

    def no_slab(name, fn, outputs: int):
        """fn() with what it allocates at its peak held to its outputs, the
        fixed workspace and two copies of w's columns: no array of N x K
        elements (an [N, K] bf16 array is the slab these routes go without)."""
        got, extra = peak_extra(fn)
        limit = jk.FUSED_WS_BYTES + outputs + 2 * h.element_size() * Hj * K + (64 << 20)
        log(f"    {name}: one call allocated {extra / 2**20:.0f} MiB at its peak (limit "
            f"{limit / 2**20:.0f} MiB: workspace, outputs, w's copies; an [N, K] bf16 array "
            f"would be {2 * N * K / 2**20:.0f} MiB)")
        if extra > limit:
            raise AssertionError(f"{name} allocated {extra} bytes, more than {limit}")
        return got

    def k6_fused():
        got = no_slab("K6-fused", lambda: jk.joint_bwd_fused(h, w, b, cs, cl, labels),
                      4 * (N * Hj + Hj * K + K))
        return three(got, jk.joint_bwd_fused_plain(h, w, b, cs, cl, labels), fused_tol)

    def k5_fused_u():
        return three(jk.joint_bwd_fused_u(h, ref_u, w, cs, cl, labels),
                     jk.joint_bwd_fused_u_plain(h, ref_u, w, cs, cl, labels), JOINT_RTOL)

    def k7_a8():
        smear = same_twice("K7-A8", lambda: (jk.joint_bwd_dh_u8(ref_q, ref_s, w, cs, kt),))[0]
        ref = jk.joint_bwd_dh_u8_plain(ref_q, ref_s, w, cs, kt)
        return {"rel_err": rel_err(smear, ref), "tol": JOINT_RTOL,
                "max_abs_err": (smear - ref).abs().max().item(), "err_of": "smear"}

    def k7_b8():
        got = same_twice("K7-B8", lambda: jk.joint_bwd_dw_u8(h, ref_q, ref_s, cs, cl, labels, kt))
        return {**three(got, jk.joint_bwd_dw_u8_plain(h, ref_q, ref_s, cs, cl, labels, kt),
                        JOINT_RTOL), "err_of": "dw, db"}

    def k6_derive_a():
        # a chunk of rows: the bf16 tile is an output here
        u, smear = jk.joint_derive_a(h, w, b, cs)
        want_u, want = jk.joint_derive_a_plain(h, w, b, cs)
        _, u_rel, _ = slab_errs(u, want_u)
        if not u_rel <= U_RTOL:
            raise AssertionError(f"K6-derive-a: the bf16 tile differs by {u_rel} (tol {U_RTOL})")
        return {"rel_err": rel_err(smear, want), "tol": fused_tol,
                "max_abs_err": (smear - want).abs().max().item(), "err_of": "smear (u checked)"}

    def k4_a():
        smear = no_slab("K4-A", lambda: jk.joint_bwd_dh_recompute(h, w, b, denom, c, lo, hi),
                        4 * N * Hj)
        ref = jk.joint_bwd_dh_recompute_plain(h, w, b, denom, c, lo, hi)
        return {"rel_err": rel_err(smear, ref), "tol": fused_tol,
                "max_abs_err": (smear - ref).abs().max().item(),
                "err_of": f"smear, columns [{lo}, {hi})"}

    def k4_b():
        got = no_slab("K4-B",
                      lambda: jk.joint_bwd_dw_recompute(h, w, b, denom, c, cl, rel, lo, hi),
                      4 * (Hj * Kc + Kc))
        want = jk.joint_bwd_dw_recompute_plain(h, w, b, denom, c, cl, rel, lo, hi)
        return {**three(got, want, fused_tol), "err_of": f"dw, db, columns [{lo}, {hi})"}

    checks = {"K2": k2, "K5-store": k5_store, "K7-store8": k7_store8, "K5-A": k5_a,
              "K5-B": k5_b, "K7-fused-u8": k7_fused_u8, "K6-fused": k6_fused,
              "K5-fused-u": k5_fused_u, "K7-A8": k7_a8, "K7-B8": k7_b8,
              "K6-derive-a": k6_derive_a, "K4-A": k4_a, "K4-B": k4_b}
    out = {}
    for name in only:
        r = out[name] = checks[name]()
        torch.cuda.synchronize()
        log(f"  {name} N={N} Hj={Hj} K={K} {dtype_name}: relative err {r['rel_err']:.3g} "
            f"(tol {r['tol']:.3g}), max abs err of {r['err_of']} {r['max_abs_err']:.3g}")
        if not r["rel_err"] <= r["tol"]:
            raise AssertionError(f"{name} disagrees with its plain version: {r}")
    if not timed:
        return out
    es = 4 if dtype_name == "float32" else 2
    flops = 2.0 * N * Hj * K
    fwd_bytes = es * (N * Hj + K * Hj) + 4 * (K + N)
    i8_bytes = N * K + 4 * n_kt * N
    bwd_out = 4 * (N * Hj + Hj * K + K)
    bounds = {
        "K2": (fwd_bytes, flops),
        "K5-store": (fwd_bytes + 2 * N * K, flops),
        "K7-store8": (fwd_bytes + i8_bytes, flops),
        "K5-A": (2 * N * K + es * Hj * K + 4 * N + 4 * N * Hj, flops),
        "K5-B": (es * N * Hj + 2 * N * K + 12 * N + 4 * (Hj * K + K), flops),
        "K7-fused-u8": (es * (N * Hj + Hj * K) + i8_bytes + 12 * N + bwd_out, 2 * flops),
        "K6-fused": (es * (N * Hj + Hj * K) + 4 * K + 12 * N + bwd_out, 3 * flops),
        "K5-fused-u": (es * (N * Hj + Hj * K) + 2 * N * K + 12 * N + bwd_out, 2 * flops),
        "K7-A8": (i8_bytes + es * Hj * K + 4 * N + 4 * N * Hj, flops),
        "K7-B8": (es * N * Hj + i8_bytes + 12 * N + 4 * (Hj * K + K), flops),
        "K6-derive-a": (es * (N * Hj + Hj * K) + 4 * K + 4 * N + 2 * N * K + 4 * N * Hj,
                        2 * flops),
        "K4-A": (es * (N * Hj + Hj * Kc) + 4 * Kc + 8 * N + 4 * N * Hj, 2 * flops * Kc / K),
        "K4-B": (es * (N * Hj + Hj * Kc) + 4 * Kc + 16 * N + 4 * (Hj * Kc + Kc),
                 2 * flops * Kc / K),
    }
    runs = {
        "K2": (lambda: jk.joint_fwd(h, wt, b), lambda: jk.joint_fwd_plain(h, wt, b)),
        "K5-store": (lambda: jk.joint_fwd_store(h, wt, b),
                     lambda: jk.joint_fwd_store_plain(h, wt, b)),
        "K7-store8": (lambda: jk.joint_fwd_store8(h, wt, b, kt),
                      lambda: jk.joint_fwd_store8_plain(h, wt, b, kt)),
        "K5-A": (lambda: jk.joint_bwd_dh(ref_u, w, cs),
                 lambda: jk.joint_bwd_dh_plain(ref_u, w, cs)),
        "K5-B": (lambda: jk.joint_bwd_dw(h, ref_u, cs, cl, labels),
                 lambda: jk.joint_bwd_dw_plain(h, ref_u, cs, cl, labels)),
        "K7-fused-u8": (
            lambda: jk.joint_bwd_fused_u8(h, ref_q, ref_s, w, cs, cl, labels, kt),
            lambda: jk.joint_bwd_fused_u8_plain(h, ref_q, ref_s, w, cs, cl, labels, kt)),
        "K6-fused": (lambda: jk.joint_bwd_fused(h, w, b, cs, cl, labels),
                     lambda: jk.joint_bwd_fused_plain(h, w, b, cs, cl, labels)),
        "K5-fused-u": (lambda: jk.joint_bwd_fused_u(h, ref_u, w, cs, cl, labels),
                       lambda: jk.joint_bwd_fused_u_plain(h, ref_u, w, cs, cl, labels)),
        "K7-A8": (lambda: jk.joint_bwd_dh_u8(ref_q, ref_s, w, cs, kt),
                  lambda: jk.joint_bwd_dh_u8_plain(ref_q, ref_s, w, cs, kt)),
        "K7-B8": (lambda: jk.joint_bwd_dw_u8(h, ref_q, ref_s, cs, cl, labels, kt),
                  lambda: jk.joint_bwd_dw_u8_plain(h, ref_q, ref_s, cs, cl, labels, kt)),
        "K6-derive-a": (lambda: jk.joint_derive_a(h, w, b, cs),
                        lambda: jk.joint_derive_a_plain(h, w, b, cs)),
        "K4-A": (lambda: jk.joint_bwd_dh_recompute(h, w, b, denom, c, lo, hi),
                 lambda: jk.joint_bwd_dh_recompute_plain(h, w, b, denom, c, lo, hi)),
        "K4-B": (lambda: jk.joint_bwd_dw_recompute(h, w, b, denom, c, cl, rel, lo, hi),
                 lambda: jk.joint_bwd_dw_recompute_plain(h, w, b, denom, c, cl, rel, lo, hi)),
    }
    # library yardsticks, one PyTorch call per product: the forwards
    # logsumexp(addmm); the backwards their matmuls on a bf16 u (the fused
    # ones both; the ones that derive u again also the addmm + exp that
    # makes it)
    b_c, w_bf = b.to(dtype), w.to(torch.bfloat16)
    lib_u = ref_u
    if lib_u is None and set(only) - {"K2", "K5-store", "K7-store8"}:
        lib_u = jk.joint_fwd_store_plain(h, wt, b)[1]
    u_c = lib_u.to(dtype) if lib_u is not None else None
    lse = lambda: torch.logsumexp(torch.addmm(b_c, h, wt.t()), 1)
    derive = lambda: torch.addmm(b_c, h, wt.t()).exp_()
    mm_a = lambda: torch.matmul(lib_u, w_bf.t())
    mm_b = lambda: torch.matmul(h.t(), u_c)
    # the same over the column range of K4-A and K4-B
    derive_c = lambda: torch.addmm(b_c[lo:hi], h, wt[lo:hi].t()).exp_()
    mm_a_c = lambda: torch.matmul(lib_u[:, lo:hi], w_bf[:, lo:hi].t())
    mm_b_c = lambda: torch.matmul(h.t(), u_c[:, lo:hi])
    library = {"K2": lse, "K5-store": lse, "K7-store8": lse, "K5-A": mm_a, "K5-B": mm_b,
               "K7-fused-u8": lambda: (mm_a(), mm_b()),
               "K6-fused": lambda: (derive(), mm_a(), mm_b()),
               "K5-fused-u": lambda: (mm_a(), mm_b()), "K7-A8": mm_a, "K7-B8": mm_b,
               "K6-derive-a": lambda: (derive(), mm_a()), "K4-A": lambda: (derive_c(), mm_a_c()),
               "K4-B": lambda: (derive_c(), mm_b_c())}
    for name in only:
        r = out[name]
        kernel, plain = runs[name]
        r["ms"] = cuda_ms(kernel, reps=reps, warmup=1)
        r["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
        r["bound_ms"], r["bound_by"] = bound_ms(*bounds[name], dtype_name)
        r["library_ms"] = cuda_ms(library[name], reps=reps, warmup=1)
        r["tflops"] = bounds[name][1] / r["ms"] / 1e9
        log(f"    {name}: kernel {r['ms']:.3f} ms ({r['tflops']:.1f} TFLOP/s of the function's "
            f"operations) | plain {r['plain_ms']:.3f} ms | bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) | library {r['library_ms']:.3f} ms")
        if name in ("K5-B", "K7-B8"):
            plan = r["pass_b"] = jk.pass_b_plan(h, ref_u if name == "K5-B" else ref_q)
            log(f"    {name}, pass B: h staged by {plan['h']}, u by {plan['u']}; tile "
                f"{plan['tile']}, grid {plan['grid']} = {plan['blocks']} blocks = "
                f"{plan['waves']:.2f} waves of one block per SM; {plan['stages']} stages, "
                f"{plan['smem_bytes']} bytes of shared memory")
        if name in ("K2", "K5-store", "K7-store8"):
            plan = r["forward"] = jk.fwd_plan(h, wt, kt if name == "K7-store8" else None)
            log(f"    {name}, forward: h staged by {plan['h']}, wt by {plan['wt']}; tile "
                f"{plan['tile']}, clusters of {plan['cluster']}, grid {plan['grid']} blocks, "
                f"{plan['rounds']} rounds of 2,048 columns (idle share {plan['idle_share']:.3f}); "
                f"{plan['clusters_resident']} clusters resident = {plan['waves']:.2f} waves; "
                f"{plan['stages']} stages, {plan['smem_bytes']} bytes of shared memory")
        if name in ("K6-fused", "K6-derive-a", "K4-A", "K4-B"):
            # the derivation of one chunk of the fp32 workspace (of the whole
            # call for K6-derive-a's bf16 tile)
            rows = N if name == "K6-derive-a" else jk.fused_workspace_rows(N, Kc)
            wt_c = wt if name in ("K6-fused", "K6-derive-a") else wt[lo:hi].contiguous()
            plan = r["derive"] = jk.derive_plan(h[:rows], wt_c)
            log(f"    {name}, derivation: h staged by {plan['h']}, wt by {plan['wt']}; tile "
                f"{plan['tile']}, {plan['tiles']} tiles on a persistent grid of "
                f"{plan['blocks']} blocks = {plan['waves']:.2f} tiles per block; "
                f"{plan['stages']} stages, {plan['smem_bytes']} bytes of shared memory")
        if name in ("K5-A", "K7-A8"):
            plan = r["pass_a"] = jk.pass_a_plan(ref_u if name == "K5-A" else ref_q, w_bf)
            log(f"    {name}, pass A: u staged by {plan['u']}, w by {plan['w']}; tile "
                f"{plan['tile']}, grid {plan['grid']} (row tiles, Hj tiles fastest) = "
                f"{plan['blocks']} blocks = {plan['waves']:.2f} waves of one block per SM; "
                f"{plan['stages']} stages, {plan['smem_bytes']} bytes of shared memory")
    return out


def time_derivation(N: int, Hj: int, K: int) -> dict:
    """The bf16 derivation alone (``joint_derive``, the first launch of each
    chunk of K6-fused, K6-derive-a, K4-A and K4-B) at [N, Hj] x [Hj, K],
    writing the fp32 workspace (K4, K6-fused) and the bf16 tile
    (K6-derive-a), beside the store alone: a fill of the same bytes. Each
    output against the plain version."""
    import torch

    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    h, wt, b, *_ = joint_inputs(N, Hj, K, torch.bfloat16, N + K)
    shift = jk.joint_fwd_plain(h, wt, b)[0].log()
    out = {"plan": jk.derive_plan(h, wt)}
    for tag, (o32, o16) in {"fp32": (True, False), "bf16": (False, True)}.items():
        got = [t for t in jk.joint_derive(h, wt, b, shift, o32, o16) if t is not None][0]
        want = [t for t in jk.joint_derive_plain(h, wt, b, shift, o32, o16) if t is not None][0]
        _, err, _ = slab_errs(got, want)
        tol = 1e-3 if o32 else U_RTOL  # z's last fp32 bits; one bf16 step
        if not err <= tol:
            raise AssertionError(f"the derivation ({tag}) differs by {err} (tol {tol})")
        del got, want
        ms = cuda_ms(lambda: jk.joint_derive(h, wt, b, shift, o32, o16), reps=5, warmup=1)
        target = torch.empty((N, K), dtype=torch.float32 if o32 else torch.bfloat16,
                             device="cuda")
        fill = cuda_ms(lambda: target.fill_(1.0), reps=5, warmup=1)
        del target
        nbytes = N * K * (4 if o32 else 2)
        out[tag] = {"ms": ms, "rel_err": err, "tflops": 2.0 * N * Hj * K / ms / 1e9,
                    "store_alone_ms": fill, "bound_ms": bound_ms(
                        2 * (N * Hj + K * Hj) + 4 * (K + N) + nbytes, 2.0 * N * Hj * K,
                        "bfloat16")[0]}
        log(f"  derivation alone N={N} Hj={Hj} K={K}, {tag} out: {ms:.3f} ms "
            f"({out[tag]['tflops']:.1f} TFLOP/s), relative err {err:.3g} (tol {tol:.3g}); the "
            f"store alone (a fill of its {nbytes / 2**20:.0f} MiB) {fill:.3f} ms; bound "
            f"{out[tag]['bound_ms']:.4f} ms")
    return out


def time_rechunked(N: int, Hj: int, K: int, dtype_name: str) -> dict:
    """The rechunked backward as a whole (K6-derive-a + K5-B per row chunk)
    at [N, Hj] x [Hj, K]: against the plain versions, its time and what one
    call allocates at its peak."""
    import torch

    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    dtype = getattr(torch, dtype_name)
    h, wt, b, labels, cb, cl = joint_inputs(N, Hj, K, dtype, N + K)
    w = wt.t().contiguous()
    cs = (cb + cl) / jk.joint_fwd_plain(h, wt, b)[0]
    rows = jk.rechunk_rows(N, Hj, K)
    reset_counts()
    got, extra = peak_extra(lambda: jk.joint_bwd_rechunked(h, w, b, cs, cl, labels))
    counts = {k: v for k, v in read_counts().items() if v}
    limit = (2 * rows * K + 4 * (N * Hj + rows * Hj + Hj * K + K) + 2 * h.element_size() * Hj * K
             + (jk.FUSED_WS_BYTES if dtype_name == "float32" else 0) + (64 << 20))
    log(f"  rechunked backward N={N} Hj={Hj} K={K} {dtype_name}: {-(-N // rows)} chunks of "
        f"{rows} rows, launches {counts}; one call allocated {extra / 2**20:.0f} MiB at its "
        f"peak (limit {limit / 2**20:.0f} MiB: one chunk's bf16 tile, outputs, w's copies; "
        f"an [N, K] bf16 array would be {2 * N * K / 2**20:.0f} MiB)")
    if extra > limit:
        raise AssertionError(f"the rechunked backward allocated {extra} bytes, over {limit}")
    with plain_path():
        want = jk.joint_bwd_rechunked(h, w, b, cs, cl, labels)
    tol = JOINT_RTOL if dtype_name == "float32" else FUSED_BF16_RTOL
    err = max(rel_err(g, r) for g, r in zip(got, want))
    abs_err = max((g - r).abs().max().item() for g, r in zip(got, want))
    log(f"    vs plain: relative err {err:.3g} (tol {tol:.3g}), max abs err of smear, dw, db "
        f"{abs_err:.3g}")
    if not err <= tol:
        raise AssertionError(f"the rechunked backward disagrees with its plain version: {err}")
    del want
    ms = cuda_ms(lambda: jk.joint_bwd_rechunked(h, w, b, cs, cl, labels), reps=2, warmup=1)
    log(f"    rechunked backward: {ms:.3f} ms ({3 * 2.0 * N * Hj * K / ms / 1e9:.1f} TFLOP/s of "
        f"its three products)")
    return {"ms": ms, "rel_err": err, "max_abs_err": abs_err, "peak_extra_bytes": extra,
            "chunks": -(-N // rows), "rows": rows}


def check_fused_joint_lse() -> None:
    """The whole joint forward + backward on the card on every route, kernels
    against the plain route, N and K unaligned, the blank in a non-final
    tile; the hybrid split at three vocab tiles, the first stored."""
    import torch

    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    for route in ROUTE_KERNELS:
        N, Hj, K, blank = (1000, 96, 1000, 100) if route != "hybrid" else (1000, 96, 2500, 100)
        h, wt, b, labels, cb, cl = joint_inputs(N, Hj, K, torch.float32, 7)

        def run():
            leaves = [t.clone().requires_grad_() for t in (h, wt.t(), b)]
            lb, ll = jk.fused_joint_lse(*leaves, labels, blank)
            loss = (lb * cb).sum() + (ll * cl).sum()
            return (lb, ll) + torch.autograd.grad(loss, leaves)

        with forced_route(route, N, Hj, K):
            plan = jk.store_plan(N, Hj, K)
            reset_counts()
            got = run()
            counts = read_counts()
            with plain_path():
                want = run()
        err = max(rel_err(g.detach(), w.detach()) for g, w in zip(got, want))
        log(f"  fused_joint_lse N={N} Hj={Hj} K={K} blank={blank} fp32, {ROUTE_NAME[route]} "
            f"[{plan['backward']}], kernels vs plain route: relative err {err:.3g} "
            f"(tol {GRAD_RTOL})")
        if not err <= GRAD_RTOL:
            raise AssertionError(f"fused_joint_lse kernels vs plain route, {route}: {err}")
        check_route(counts, route, "fused_joint_lse", lstm=False)


def train_batch(fp, n_classes: int, seed: int, tile: int = 1) -> dict:
    """The smoke utterances with U_MIN..U_MAX random tokens each, A = 1,
    the batch repeated ``tile`` times along B."""
    import numpy as np
    import torch

    audio_np, lens_np = synthetic_audio(seed)
    feats, feat_lens = fp(torch.from_numpy(audio_np).cuda(), torch.from_numpy(lens_np).cuda())
    rng = np.random.default_rng(seed + 2)
    u_lens = rng.integers(U_MIN, U_MAX + 1, N_UTTS)
    u_lens[0] = U_MAX
    txt = rng.integers(0, n_classes - 1, (N_UTTS, U_MAX))
    return {"feats": feats.repeat(1, tile, 1)[None], "feat_lens": feat_lens.repeat(tile)[None],
            "txt": torch.from_numpy(txt).cuda().repeat(tile, 1)[None],
            "txt_lens": torch.from_numpy(u_lens).cuda().repeat(tile)[None]}


def lattice_rows(batch, stack_time_factor: int) -> int:
    """B * T' * (U+1): the rows of the joint for ``batch``."""
    T_post = -(-batch["feats"].shape[1] // stack_time_factor)
    return batch["feats"].shape[2] * T_post * (batch["txt"].shape[2] + 1)


def batch_plan(name: str, batch) -> tuple[int, dict]:
    """(lattice rows, the store policy's plan) of ``batch`` for model ``name``."""
    from caiman_asr_tpu_torch.ops.joint_kernel import store_plan

    cfg = model_config(name)
    N = lattice_rows(batch, cfg.enc_stack_time_factor)
    return N, store_plan(N, cfg.joint_n_hid, MODELS[name][1])


def run_train(batch, dtype_name: str, name: str = "base-85M", steps: int = TRAIN_STEPS,
              store="bf16") -> dict:
    """``steps`` steps of model ``name`` on ``batch``; per step its time,
    loss, gradient norm, skip flag and kernel launches. ``store``: the slab
    the store policy keeps for this batch, whose kernels, and no other
    route's, must have been launched."""
    import torch

    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
    from caiman_asr_tpu_torch.training.step import init_train_state, make_train_step

    model = build_model(name, "cuda")
    opt = Lamb(OptimizerConfig(warmup_steps=0), model.param_lr_factors())
    state = init_train_state(model, opt, device="cuda")
    compute = None if dtype_name == "float32" else getattr(torch, dtype_name)
    step = make_train_step(model, opt, model.n_classes - 1, compute_dtype=compute,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tag = f"{name} B={batch['feats'].shape[2]} {dtype_name}"
    rows = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen, SCALARS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        row = {"ms": ms, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "skipped": int(m["skipped"]), "launches": read_counts()}
        rows.append(row)
        log(f"  train {tag} step {i + 1}: {ms:.1f} ms, loss {row['loss']:.4f}, "
            f"grad_norm {row['grad_norm']:.4f}, skipped {row['skipped']}")
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or any(r["skipped"] for r in rows):
        raise AssertionError(f"{tag}: a loss is not finite or a step was skipped: {rows}")
    if steps > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: the loss did not fall: {losses}")
    counts = rows[-1]["launches"]
    log(f"  train {tag}: launches per step {counts}; peak memory {peak / 2**30:.2f} GiB")
    check_route(counts, store, tag)
    return {"rows": rows, "model": model, "opt": opt, "state": state, "gen": gen,
            "compute": compute, "peak_bytes": peak, "step": step}


def check_route(counts: dict, store, tag: str, lstm: bool = True) -> None:
    """The launches are those of a train step on the route ``store`` names
    (a key of ROUTE_KERNELS): the LSTM train kernels (unless ``lstm`` is
    off: the joint alone) and the route's joint kernels, and no other
    route's."""
    want = (LSTM_TRAIN_KERNELS if lstm else ()) + ROUTE_KERNELS[store]
    missing = [k for k in want if counts[k] == 0]
    other = [k for kernels in ROUTE_KERNELS.values() for k in kernels
             if k not in want and counts[k]]
    if missing or other:
        raise AssertionError(f"{tag}: expected the route {ROUTE_NAME[store]}; not launched: "
                             f"{missing}; launched from another route: {other}")


def step_breakdown(run: dict, batch) -> dict:
    """Two more steps of ``run``'s model, phase by phase, each phase ending
    in a synchronise: ms per phase of the second (the first pays one-time
    allocations)."""
    _step_phases(run, batch)
    times = _step_phases(run, batch)
    total = sum(times.values())
    log(f"  step breakdown, B={batch['feats'].shape[2]} "
        f"{'bf16' if run['compute'] is not None else 'fp32'} (ms, share): "
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
    mark("joint forward")
    null, emit = tl._penalised_scores(lp_b, lp_l, mb["txt"], f_lens, tl.LossModifiers())
    loss = tl.rnnt_lattice(null, emit, f_lens, mb["txt_lens"]).sum() / mb["feats"].shape[1]
    mark("lattice forward")
    d_lp = torch.autograd.grad(loss, (lp_b, lp_l))
    mark("lattice backward")
    joint_in = (f, g, w_fc, b_fc)
    d_joint = torch.autograd.grad((lp_b, lp_l), joint_in, d_lp)
    mark("joint backward")
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
    log(f"  profiled step, B={batch['feats'].shape[2]} "
        f"{'bf16' if run['compute'] is not None else 'fp32'}: wall "
        f"{wall_ms:.1f} ms, device busy {busy:.1f} ms ({busy / wall_ms:.0%}); top kernels: "
        + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top))
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "top_kernels_ms": dict(top)}


def release(run: dict) -> dict:
    """Drop what holds device memory from a finished run."""
    for k in ("model", "opt", "state", "step", "gen"):
        run.pop(k, None)
    return run


def step_grads(model, mb, n_utts: int):
    """(loss, gradients by parameter name) of one fp32 microbatch."""
    import torch

    from caiman_asr_tpu_torch.ops.transducer_loss import LossModifiers
    from caiman_asr_tpu_torch.training.step import _micro_loss
    from caiman_asr_tpu_torch.training.tree import tree_items

    items = list(tree_items(model.param_tree()))
    loss = _micro_loss(model, model.param_tree(), mb, None, LossModifiers(), n_utts,
                       model.n_classes - 1)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in items])
    return loss.detach(), {".".join(path): g for (path, _), g in zip(items, grads)}


def no_dropout(name: str):
    import dataclasses

    model = build_model(name, "cuda")
    model.cfg = dataclasses.replace(model.cfg, enc_dropout=0.0, pred_dropout=0.0,
                                    joint_dropout=0.0)
    return model


def check_microbatch(batch, name: str) -> tuple[dict, int]:
    """(the first CHECK_B utterances of ``batch``, their lattice rows)."""
    lens = batch["feat_lens"][0, :CHECK_B]
    T = int(lens.max())
    U = int(batch["txt_lens"][0, :CHECK_B].max())
    mb = {"feats": batch["feats"][0, :T, :CHECK_B], "feat_lens": lens,
          "txt": batch["txt"][0, :CHECK_B, :U], "txt_lens": batch["txt_lens"][0, :CHECK_B]}
    return mb, CHECK_B * -(-T // model_config(name).enc_stack_time_factor) * (U + 1)


def whole_step_check(batch, name: str = "base-85M", store="bf16", model=None,
                     against=None) -> dict:
    """The loss and every gradient of one fp32 step with dropout off, at
    CHECK_B utterances, on the route ``store`` names (a key of
    ROUTE_KERNELS): kernels against the plain path, on the card; and, given
    ``against`` = (loss, gradients) of the bf16-slab route on the same
    utterances, against those at ROUTE_RTOL."""
    model = model or no_dropout(name)
    mb, rows = check_microbatch(batch, name)
    Hj, K = model.cfg.joint_n_hid, model.n_classes
    with forced_route(store, rows, Hj, K):
        reset_counts()
        loss_k, g_k = step_grads(model, mb, CHECK_B)
        counts = read_counts()
        with plain_path():
            loss_p, g_p = step_grads(model, mb, CHECK_B)
    if read_counts() != counts:
        raise AssertionError("the plain path launched a kernel")
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = {n: rel_err(g_k[n], g_p[n]) for n in g_k}
    worst = max(errs, key=errs.get)
    log(f"  whole step, {name}, {ROUTE_NAME[store]}, fp32, B={CHECK_B} rows={rows}: loss "
        f"{float(loss_k):.6f} vs plain {float(loss_p):.6f} (relative {loss_err:.3g}, tol "
        f"{LOSS_RTOL}); worst gradient {worst}: {errs[worst]:.3g} of its largest magnitude "
        f"(tol {GRAD_RTOL}); kernel launches {counts}")
    if not loss_err <= LOSS_RTOL or not errs[worst] <= GRAD_RTOL:
        raise AssertionError(f"the kernel path differs from the plain path: {loss_err}, {errs}")
    check_route(counts, store, f"whole step {name}")
    out = {"loss_rel_err": loss_err, "grad_rel_err": errs[worst], "worst": worst}
    if against is not None:
        out["vs_bf16_slab"] = compare_routes((loss_k, g_k), against, store, name, CHECK_B)
    return out


def compare_routes(got, ref, store, name: str, n_utts: int) -> dict:
    """(loss, gradients) of the route ``store`` against the bf16-slab
    route's on the same utterances, at LOSS_RTOL and ROUTE_RTOL."""
    (loss, grads), (loss_ref, g_ref) = got, ref
    loss_err = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    errs = {n: rel_err(grads[n], g_ref[n]) for n in grads}
    worst = max(errs, key=errs.get)
    log(f"  routes, {name}, fp32, B={n_utts}: {ROUTE_NAME[store]} vs the bf16 slab: loss "
        f"relative {loss_err:.3g} (tol {LOSS_RTOL}); worst gradient {worst}: "
        f"{errs[worst]:.3g} of its largest magnitude (tol {ROUTE_RTOL[store]})")
    if not loss_err <= LOSS_RTOL or not errs[worst] <= ROUTE_RTOL[store]:
        raise AssertionError(f"route {store} differs from the bf16-slab route: {errs}")
    return {"loss_rel_err": loss_err, "grad_rel_err": errs[worst], "worst": worst}


def routes_check(batch, name: str, model) -> dict:
    """The three routes against each other on the whole ``batch``, fp32,
    dropout off: the loss and every gradient of the int8 and the no-slab
    route against the bf16-slab route's."""
    mb = {k: v[0] for k, v in batch.items()}
    n_utts = mb["feats"].shape[1]
    got = {}
    for store in ("bf16", "i8", None):
        with forced_route(store):
            reset_counts()
            got[store] = step_grads(model, mb, n_utts)
            check_route(read_counts(), store, f"routes {name}")
    return {str(store): compare_routes(got[store], got["bf16"], store, name, n_utts)
            for store in ("i8", None)}


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
    if any(v for k, v in counts.items() if k not in ("joint_fwd", "lstm_recurrence")):
        raise AssertionError(f"the validation loss launched a train kernel: {counts}")
    return {"ms": ms, "launches": counts, "loss": float(s_k) / n}


def run_large(fp) -> dict:
    """Phase 7: large-196M through the three entry points."""
    import torch

    name = "large-196M"
    n_classes = MODELS[name][1]
    expected = dict(zip(LARGE_TILES, ("bf16", "i8", None)))
    out = {"train": {}}
    for tile in LARGE_TILES:
        batch = train_batch(fp, n_classes, SEED, tile)
        Bt = batch["feats"].shape[2]
        N, plan = batch_plan(name, batch)
        log(f"  B={Bt}: lattice rows N={N}, plan {plan}")
        if plan["dtype"] != expected[tile]:
            raise AssertionError(f"B={Bt}: expected the route {ROUTE_NAME[expected[tile]]}")
        cell = out["train"][Bt] = {"N": N, "plan": plan}
        run = run_train(batch, "bfloat16", name, LARGE_STEPS, plan["dtype"])
        cell["breakdown_ms"] = step_breakdown(run, batch)
        cell["profile"] = profile_step(run, batch)
        cell["bfloat16"] = release(run)
        del run
        torch.cuda.empty_cache()
        cell["float32"] = release(run_train(batch, "float32", name, 1, plan["dtype"]))
        torch.cuda.empty_cache()

    log("== large-196M: the routes against each other and against their plain paths")
    batch = train_batch(fp, n_classes, SEED)
    model = no_dropout(name)
    out["routes"] = routes_check(batch, name, model)
    out["whole_step"] = {str(store): whole_step_check(batch, name, store, model)
                         for store in ("bf16", "i8", None)}
    log("== large-196M: validation loss")
    out["validation"] = val_check(model, batch)
    del model, batch
    torch.cuda.empty_cache()
    log("== large-196M: offline greedy transcription")
    out["slice"] = run_slice(name)
    torch.cuda.empty_cache()
    return out


def run_knob_routes(fp) -> dict:
    """Phase 7b: large-196M at full width on each route only the policy's
    knobs reach. Per route KNOB_STEPS bf16 train steps at the batch size at
    which the knob leads there; then, at CHECK_B utterances in fp32 with
    dropout off, each route against its plain path and against the
    bf16-slab route."""
    import torch

    name = "large-196M"
    tile = batch = None
    out = {"train": {}}
    for route, knobs in KNOBS.items():
        if KNOB_TILES[route] != tile:
            tile, batch = KNOB_TILES[route], None  # one batch on the card at a time
            batch = train_batch(fp, MODELS[name][1], SEED, tile)
        with policy(**knobs):
            N, plan = batch_plan(name, batch)
            log(f"  {knobs}, B={batch['feats'].shape[2]}: lattice rows N={N}, plan {plan}")
            partial = 0 < plan["ks"] < MODELS[name][1]
            if ((plan["dtype"], plan["route"]) != ROUTE_PLAN[route]
                    or partial != (route == "hybrid")):
                raise AssertionError(f"{knobs} should lead to {ROUTE_NAME[route]}: {plan}")
            run = release(run_train(batch, "bfloat16", name, KNOB_STEPS, route))
        out["train"][route] = {"N": N, "B": batch["feats"].shape[2], "knobs": knobs,
                               "plan": plan, "bfloat16": run}
        torch.cuda.empty_cache()

    log("== large-196M: each knob's route against its plain path and the bf16-slab route")
    batch = train_batch(fp, MODELS[name][1], SEED)
    model = no_dropout(name)
    with forced_route("bf16"):
        ref = step_grads(model, check_microbatch(batch, name)[0], CHECK_B)
    out["whole_step"] = {route: whole_step_check(batch, name, route, model, against=ref)
                         for route in KNOBS}
    return out


def wavefront_inputs(G: int, T: int, B: int, H: int, dtype, seed: int, with_masks: bool):
    """K8-fwd's operands (gates_x0, biases, w0_hh, w_cats, h0, c0, masks)
    and cotangents dys, dcs [G, T, B, H], random from a seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape, s: (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)
    uni = lambda *shape, b: ((torch.rand(shape, generator=g, device="cuda") * 2 - 1) * b).to(dtype)
    masks = None
    if with_masks:
        keep = torch.rand((G - 1, T, B, H), generator=g, device="cuda") < 0.9
        masks = torch.where(keep, 1 / 0.9, 0.0).to(dtype)
    ops = (rnd(T, B, 4 * H, s=0.5),
           torch.randn((max(G - 1, 1), 4 * H), generator=g, device="cuda") * 0.1,
           uni(4 * H, H, b=1 / math.sqrt(H)), uni(G - 1, 4 * H, 2 * H, b=1 / math.sqrt(2 * H)),
           rnd(G, B, H, s=0.1), rnd(G, B, H, s=0.1), masks)
    return ops, rnd(G, T, B, H, s=0.1), rnd(G, T, B, H, s=0.03)


def check_wavefront(T: int, B: int, H: int, G: int, dtype_name: str, hard: bool,
                    with_masks: bool, timed: bool = False, I0: int = 0) -> dict:
    """K8-fwd (without and with stored gates) and K8-bwd against their plain
    versions on the card; timed, also their times, bounds, the plain
    versions' times and cuDNN's G-layer ``nn.LSTM`` (input width I0)."""
    import torch

    from caiman_asr_tpu_torch.ops import wavefront_kernel as wk

    dtype = getattr(torch, dtype_name)
    fwd_args, dys, dcs = wavefront_inputs(G, T, B, H, dtype, 13 * T + 5 * G + int(hard), with_masks)
    gx, biases, w0, w_cats, h0, c0, masks = fwd_args
    ys, cs = wk.lstm_wavefront(*fwd_args, hard)
    sg = wk.lstm_wavefront_sg(*fwd_args, hard)
    torch.cuda.synchronize()
    ref = wk.lstm_wavefront_sg_plain(*fwd_args, hard)
    gs, cs_ref = ref[2], ref[1]
    c_prev = torch.cat([c0[:, None], cs_ref[:, :-1]], dim=1)
    w_hh = torch.cat([w0[None], w_cats[:, :, H:]])
    w_ih = w_cats[:, :, :H].contiguous()
    bwd_args = (gs, cs_ref, c_prev, dys, dcs, masks, w_hh, w_ih, hard)
    bwd = wk.lstm_wavefront_bwd(*bwd_args)
    torch.cuda.synchronize()
    bwd_ref = wk.lstm_wavefront_bwd_plain(*bwd_args)
    scale = max(1.0, bwd_ref[0].float().abs().max().item())
    tol = TOL[dtype_name]
    # the stored pre-activations: a bf16 rounding that falls the other way
    # moves one by an ulp of its own magnitude, so their scale sets the bound
    gs_scale = max(1.0, gs.float().abs().max().item())
    out = {"K8-fwd": {"max_abs_err": max_err((ys, cs), ref[:2]), "tol": tol},
           "K8-fwd-sg": {"max_abs_err": max_err(sg, ref), "tol": tol * gs_scale},
           "K8-bwd": {"max_abs_err": max_err(bwd, bwd_ref), "tol": tol * scale}}
    for name, r in out.items():
        log(f"  {name} G={G} T={T} B={B} H={H} {dtype_name} hard={hard} masks={with_masks}: "
            f"max|kernel - plain| = {r['max_abs_err']:.3g} (tol {r['tol']:.3g})")
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{name} disagrees with its plain version: {r}")
    if not timed:
        return out
    es = 4 if dtype_name == "float32" else 2
    weights = 4 * H * H + (G - 1) * 4 * H * 2 * H
    streams = G * T * B * H
    n_masks = (G - 1) * T * B * H if with_masks else 0
    fwd_bytes = es * (weights + T * B * 4 * H + n_masks + 2 * G * B * H + 2 * streams) \
        + 4 * (G - 1) * 4 * H
    fwd_flops = 2.0 * T * B * 4 * H * (H + (G - 1) * 2 * H)
    k8f, k8sg, k8b = out["K8-fwd"], out["K8-fwd-sg"], out["K8-bwd"]
    k8f["ms"] = cuda_ms(lambda: wk.lstm_wavefront(*fwd_args, hard))
    k8f["plain_ms"] = cuda_ms(lambda: wk.lstm_wavefront_plain(*fwd_args, hard), reps=2,
                              warmup=1)
    k8f["bound_ms"], k8f["bound_by"] = bound_ms(fwd_bytes, fwd_flops, dtype_name)
    k8sg["ms"] = cuda_ms(lambda: wk.lstm_wavefront_sg(*fwd_args, hard))
    k8sg["plain_ms"] = cuda_ms(lambda: wk.lstm_wavefront_sg_plain(*fwd_args, hard), reps=2,
                               warmup=1)
    k8sg["bound_ms"], k8sg["bound_by"] = bound_ms(fwd_bytes + es * 4 * streams, fwd_flops,
                                                  dtype_name)
    # backward: w_hh of every layer and w_ih of the inner ones read once; gs,
    # cs, c_prev, dys, dcs (and masks) read; dgates written, dh0 / dc0 fp32;
    # (2G-1)·T products of [B, 4H] x [4H, H] (the G·T own ones include dh0)
    k8b["ms"] = cuda_ms(lambda: wk.lstm_wavefront_bwd(*bwd_args))
    k8b["plain_ms"] = cuda_ms(lambda: wk.lstm_wavefront_bwd_plain(*bwd_args), reps=2, warmup=1)
    k8b["bound_ms"], k8b["bound_by"] = bound_ms(
        es * ((2 * G - 1) * 4 * H * H + 8 * streams + 4 * streams + n_masks) + 4 * 2 * G * B * H,
        2.0 * B * 4 * H * H * (2 * G - 1) * T, dtype_name)
    # library yardsticks: cuDNN's G-layer LSTM at the same shape, without
    # dropout; it also does layer 0's input projection (width I0), and its
    # backward the weight gradients
    lib = torch.nn.LSTM(I0, H, num_layers=G, device="cuda", dtype=dtype)
    lib.flatten_parameters()
    x = torch.randn((T, B, I0), device="cuda").to(dtype).requires_grad_()
    with torch.no_grad():
        k8f["library_ms"] = cuda_ms(lambda: lib(x, (h0, c0)))
    k8sg["library_ms"] = cuda_ms(lambda: lib(x, (h0, c0)))
    y, _ = lib(x, (h0, c0))
    leaves = [x, *lib.parameters()]
    k8b["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(y, leaves, dys[-1], retain_graph=True))
    for name, r in out.items():
        log(f"    {name}: kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | cuDNN nn.LSTM(num_layers={G}, input "
            f"{I0}) {r['library_ms']:.4f} ms")
    return out


def k8_times(T_post: int) -> dict:
    """K8 alone at base-85M's post-stack (G=6, B, H) in bf16 and fp32
    (``bench_wavefront.kernel_times``: ms, µs a superstep; and
    ``superstep_floors``: plan, floor), fp32 beside the per-superstep
    kernels' time (K8_PER_SUPERSTEP_FP32_MS)."""
    import torch

    from caiman_asr_tpu_torch import bench_wavefront as bw

    out = {}
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        r = {**bw.kernel_times(6, H, B, T_post, dtype),
             **bw.superstep_floors(6, H, B, T_post, dtype)}
        log(f"  K8 G=6 T={T_post} B={B} H={H} {name}: forward {r['fwd_ms']:.3f} ms "
            f"({r['fwd_us_per_superstep']:.2f} µs a superstep; floor "
            f"{r['fwd_floor_us_per_superstep']:.2f}: {r['fwd_plan']['streamed_MB']:.1f} MB "
            f"streamed, barrier {r['fwd_barrier_us']:.2f} µs), storing gates {r['sg_ms']:.3f} ms, backward "
            f"{r['bwd_ms']:.3f} ms ({r['bwd_us_per_superstep']:.2f} µs; floor "
            f"{r['bwd_floor_us_per_superstep']:.2f}); one launch a call")
        out[f"G=6 T={T_post} B={B} H={H} {name}"] = r
        torch.cuda.empty_cache()
    fp32 = out[f"G=6 T={T_post} B={B} H={H} float32"]
    fp32["per_superstep_kernels_ms"] = K8_PER_SUPERSTEP_FP32_MS
    log(f"  K8 fp32: forward {fp32['fwd_ms']:.3f} ms, backward {fp32['bwd_ms']:.3f} ms; the "
        f"per-superstep kernels (PERF.md) {K8_PER_SUPERSTEP_FP32_MS}")
    return out


def run_wavefront(T_post: int) -> dict:
    """Phase 9: ``run_lstm_stack_wavefront`` at each of WAVEFRONT_SHAPES in
    bf16, forward and forward + backward (and one forward + backward with
    dropout), counted; then each checked against the plain path (the fp32
    forward, the bf16 gradients) and the per-layer stack timed beside it
    with ``bench_wavefront``'s functions."""
    import torch

    from caiman_asr_tpu_torch import bench_wavefront as bw

    cases, expected = {}, {"lstm_wavefront": 0, "lstm_wavefront_sg": 0, "lstm_wavefront_bwd": 0}
    reset_counts()
    for name, (G, Hs, I0, Bs, T) in WAVEFRONT_SHAPES.items():
        T = T or T_post
        layers, x, h0, c0, wy = bw.make_stack(G, Hs, I0, Bs, T, "cuda", seed=SEED)
        runs = [("plain", {})]
        if name.startswith("large-196M"):
            runs.append(("dropout", dict(dropout=WAVEFRONT_DROPOUT)))
        with torch.no_grad():
            y = bw.wavefront_fwd(layers, x, h0, c0)
        expected["lstm_wavefront"] += 1  # one cooperative launch a call
        grads = {}
        for tag, kw in runs:
            if kw:
                kw = dict(kw, generator=torch.Generator(device="cuda").manual_seed(SEED))
            grads[tag] = bw.grads(bw.wavefront_fwd, layers, x, h0, c0, wy, **kw)
            expected["lstm_wavefront_sg"] += 1
            expected["lstm_wavefront_bwd"] += 1
        torch.cuda.synchronize()
        if not (y.shape == (T, Bs, Hs) and torch.isfinite(y).all()
                and all(torch.isfinite(g).all() for gs in grads.values() for g in gs)):
            raise AssertionError(f"wavefront at {name}: non-finite or misshapen output")
        cases[name] = dict(G=G, H=Hs, I0=I0, B=Bs, T=T, stack=(layers, x, h0, c0, wy),
                           runs=runs, grads=grads)
    counts = read_counts()
    got = {k: counts[k] for k in expected}
    log(f"  launches on the wavefront path: {got} (expected {expected})")
    if got != expected:
        raise AssertionError(f"wavefront launches {got}, expected {expected}")

    from caiman_asr_tpu_torch.ops.wavefront import run_lstm_stack_wavefront

    out = {"launches": counts}
    for name, c in cases.items():
        layers, x, h0, c0, wy = c["stack"]
        r = {k: c[k] for k in ("G", "H", "I0", "B", "T")}
        # fp32 forward, kernels against the plain path
        l32 = [{k: v.detach().float() for k, v in p.items()} for p in layers]
        with torch.no_grad():
            fwd = run_lstm_stack_wavefront(l32, x.float(), h0.float(), c0.float())
            with plain_path():
                fwd_ref = run_lstm_stack_wavefront(l32, x.float(), h0.float(), c0.float())
        r["fp32_fwd_max_abs_err"] = max_err(fwd, fwd_ref)
        # bf16 gradients, kernels against the plain path, per weight
        for tag, kw in c["runs"]:
            if kw:
                kw = dict(kw, generator=torch.Generator(device="cuda").manual_seed(SEED))
            with plain_path():
                ref = bw.grads(bw.wavefront_fwd, layers, x, h0, c0, wy, **kw)
            r[f"bf16_grad_max_rel_err_{tag}"] = bw.max_rel(c["grads"][tag], ref)
        log(f"  {name} (G={r['G']} H={r['H']} I0={r['I0']} B={r['B']} T={r['T']}): fp32 "
            f"forward max|kernel - plain| = {r['fp32_fwd_max_abs_err']:.3g} (tol "
            f"{WAVEFRONT_FWD_TOL}); bf16 gradients, max over weights of max|kernel - plain| / "
            f"max|plain| = " + ", ".join(f"{r[k]:.3g} ({k.rsplit('_', 1)[1]})" for k in r
                                       if k.startswith("bf16_grad")) + f" (tol {TOL['bfloat16']})")
        if not r["fp32_fwd_max_abs_err"] <= WAVEFRONT_FWD_TOL:
            raise AssertionError(f"wavefront fp32 forward at {name}: {r}")
        if not all(v <= TOL["bfloat16"] for k, v in r.items() if k.startswith("bf16_grad")):
            raise AssertionError(f"wavefront bf16 gradients at {name}: {r}")
        del c["stack"], c["grads"]
        torch.cuda.empty_cache()
        # the kernels alone, bf16: plan, ms, µs a superstep, floor
        r["kernels"] = {**bw.kernel_times(r["G"], r["H"], r["B"], r["T"]),
                        **bw.superstep_floors(r["G"], r["H"], r["B"], r["T"])}
        kt = r["kernels"]
        log(f"    K8 bf16: forward {kt['fwd_ms']:.3f} ms ({kt['fwd_us_per_superstep']:.2f} µs a "
            f"superstep, floor {kt['fwd_floor_us_per_superstep']:.2f}), storing gates "
            f"{kt['sg_ms']:.3f} ms, backward {kt['bwd_ms']:.3f} ms "
            f"({kt['bwd_us_per_superstep']:.2f} µs, floor {kt['bwd_floor_us_per_superstep']:.2f}); "
            f"plan forward {json.dumps(kt['fwd_plan'])}, backward {json.dumps(kt['bwd_plan'])}")
        torch.cuda.empty_cache()
        # the A/B: per-layer stack (K1; K3a + K3b) against the wavefront
        r["ab"] = bw.ab(r["G"], r["H"], r["I0"], r["B"], r["T"], reps=5)
        a = r["ab"]
        log(f"    A/B bf16: forward per-layer {a['fwd_perlayer_ms']:.3f} ms, wavefront "
            f"{a['fwd_wavefront_ms']:.3f} ms ({a['fwd_perlayer_ms'] / a['fwd_wavefront_ms']:.2f}x);"
            f" f+b per-layer {a['fb_perlayer_ms']:.3f} ms, wavefront {a['fb_wavefront_ms']:.3f} "
            f"ms ({a['fb_perlayer_ms'] / a['fb_wavefront_ms']:.2f}x); max|diff| forward "
            f"{a['fwd_max_abs_diff']:.3g}, gradients {a['grad_max_rel_diff']:.3g} of max")
        out[name] = r
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
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.ops import cuda_build
    from caiman_asr_tpu_torch.ops.joint_kernel import rechunk_rows
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
            check_recurrence(64, dtype, hard)
            check_lstm_train(64, dtype, hard)
        # large-196M's widths: the encoder at B=32 (fp32 partly resident),
        # the predictor at B=64 (its batch split)
        for Bl, Hl in ((32, 1536), (64, 768)):
            check_recurrence(32, dtype, False, Bl, Hl)
            check_lstm_train(32, dtype, False, Bl, Hl)
        check_joint(1000, 96, 1000, dtype, timed=False)  # N and K unaligned
        check_joint(300, 96, 2500, dtype, timed=False,   # three scale tiles, the last ragged
                    only=("K7-store8", "K7-fused-u8", "K6-fused", "K7-A8", "K7-B8"))
        # the per-pass recompute over a range of columns, labels on both sides of it
        check_joint(1000, 96, 2500, dtype, timed=False, only=("K4-A", "K4-B"), cols=(1024, None))
        check_joint(300, 96, 1000, dtype, timed=False, only=("K4-A", "K4-B"), cols=(200, 937))
    check_fused_joint_lse()
    log("== the wavefront kernels vs plain versions (K8-fwd, K8-bwd)")
    for dtype in ("float32", "bfloat16"):
        for hard in (False, True):
            for G in (1, 2, 3):
                for with_masks in ((False, True) if G > 1 else (False,)):
                    check_wavefront(11, 5, 136, G, dtype, hard, with_masks)
        check_wavefront(5, 33, 1536, 3, dtype, False, True)  # large-196M's width, 3 batch tiles
        check_wavefront(3, 16, 1024, 6, dtype, False, True)  # base's post-stack: rows stream
    log(f"== joint kernels past 2^31 slab elements ({BIG_N} x {BIG_K} = {BIG_N * BIG_K})")
    for dtype in ("float32", "bfloat16"):
        check_joint(BIG_N, BIG_HJ, BIG_K, dtype, timed=False)
        torch.cuda.empty_cache()
        check_joint(BIG_N, BIG_HJ, BIG_K, dtype, timed=False, only=("K4-A", "K4-B"),
                    cols=(8192, None))
        torch.cuda.empty_cache()

    # 3. the slice at full width
    log("== slice: offline greedy transcription, base-85M")
    sl = run_slice()

    # 4. the train step at full width
    log("== train step: base-85M, B=16, A=1, LAMB (warmup 0, lr 4e-3)")
    fp = FeaturePipeline(PipelineConfig(logmel=LogMelConfig(dither=0.0)), device="cuda")
    batch = train_batch(fp, MODELS["base-85M"][1], SEED)
    N, plan = batch_plan("base-85M", batch)
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
        release(run)
    del batch
    torch.cuda.empty_cache()

    # 7. large-196M
    log("== large-196M: train steps at B=16, 32, 64 (A=1, LAMB warmup 0, lr 4e-3)")
    large = run_large(fp)

    # 7b. large-196M on the routes the knobs reach
    log("== large-196M: train steps on each route the policy's knobs reach")
    knob = run_knob_routes(fp)

    # 8. every kernel at the main path's shapes
    log("== kernels at the main path's shapes")
    # the LSTM kernels at a base-85M encoder layer (and K1 at its post-stack
    # length, as the transcription runs it) and at large-196M's post-stack
    # layer at B=64, in both dtypes: each against its plain version, then
    # timed
    for name in ("float32", "bfloat16"):
        check_recurrence(sl["T_post"], name, False)
    lstm_shapes = {"base": (sl["T_pre"], B, H), "large": (sl["T_post"], 64, 1536)}
    lstm = {}
    for cell, (T, Bs, Hs) in lstm_shapes.items():
        for name in ("bfloat16", "float32"):
            errs = {"K1": check_recurrence(T, name, False, Bs, Hs),
                    **check_lstm_train(T, name, False, Bs, Hs)}
            lstm[cell, name] = time_lstm(T, Bs, Hs, name)
            for kernel, r in lstm[cell, name].items():
                r["max_abs_err"] = errs[kernel]["max_abs_err"]
        torch.cuda.empty_cache()
    joint = check_joint(N, 768, 8704, "bfloat16", timed=True,
                        only=("K2", "K5-store", "K5-A", "K5-B"))
    cells = large["train"]
    Hj_l, K_l = MODELS["large-196M"][0]["joint_n_hid"], MODELS["large-196M"][1]
    n16, n32, n64 = (cells[Bt]["N"] for Bt in sorted(cells))
    torch.cuda.empty_cache()
    large16 = check_joint(n16, Hj_l, K_l, "bfloat16", timed=True,
                          only=("K5-store", "K5-A", "K5-B"), reps=3)
    torch.cuda.empty_cache()
    joint.update(check_joint(n32, Hj_l, K_l, "bfloat16", timed=True,
                             only=("K7-store8", "K7-fused-u8"), reps=3))
    torch.cuda.empty_cache()
    k2_64 = check_joint(n64, Hj_l, K_l, "bfloat16", timed=True, only=("K2",), reps=2)
    torch.cuda.empty_cache()
    joint.update(check_joint(n64, Hj_l, K_l, "bfloat16", timed=True,
                             only=("K6-fused", "K4-A", "K4-B"), reps=2))
    torch.cuda.empty_cache()
    joint.update(check_joint(n16, Hj_l, K_l, "bfloat16", timed=True, only=("K5-fused-u",),
                             reps=3))
    torch.cuda.empty_cache()
    joint.update(check_joint(n32, Hj_l, K_l, "bfloat16", timed=True, only=("K7-A8", "K7-B8"),
                             reps=3))
    torch.cuda.empty_cache()
    # K6-derive-a at one row chunk of the rechunked backward, then that
    # backward as a whole; the hybrid split's kernels at its column ranges
    chunk = rechunk_rows(n64, Hj_l, K_l)
    joint.update(check_joint(chunk, Hj_l, K_l, "bfloat16", timed=True, only=("K6-derive-a",),
                             reps=3))
    derivation = time_derivation(chunk, Hj_l, K_l)
    torch.cuda.empty_cache()
    rechunked = time_rechunked(n64, Hj_l, K_l, "bfloat16")
    ks = knob["train"]["hybrid"]["plan"]["ks"]
    hybrid = {"stored": check_joint(n32, Hj_l, ks, "bfloat16", timed=True,
                                    only=("K5-store", "K5-A", "K5-B"), reps=2),
              "recomputed": check_joint(n32, Hj_l, K_l, "bfloat16", timed=True,
                                        only=("K4-A", "K4-B"), reps=2, cols=(ks, None))}
    torch.cuda.empty_cache()
    k8 = check_wavefront(sl["T_post"], B, H, 6, "bfloat16", False, False, timed=True,
                         I0=2 * H)
    torch.cuda.empty_cache()
    k8_summary = k8_times(sl["T_post"])

    # 9. the wavefront multi-layer LSTM at full width
    log("== wavefront: run_lstm_stack_wavefront at full width, bf16, forward and f+b")
    wavefront = run_wavefront(sl["T_post"])

    train_counts = runs["bfloat16"]["rows"][-1]["launches"]
    counts32 = cells[sorted(cells)[1]]["bfloat16"]["rows"][-1]["launches"]
    counts64 = cells[sorted(cells)[2]]["bfloat16"]["rows"][-1]["launches"]
    layer = f"T={sl['T_pre']} B={B} H={H} bfloat16 (one encoder layer)"
    joint_shape = f"N={N} Hj=768 K=8704 bfloat16"
    shape32 = f"N={n32} Hj={Hj_l} K={K_l} bfloat16"
    shape64 = f"N={n64} Hj={Hj_l} K={K_l} bfloat16"
    base_step, large32, large64 = ("base-85M train step", "large-196M train step, B=32",
                                   "large-196M train step, B=64")
    shape16 = f"N={n16} Hj={Hj_l} K={K_l} bfloat16"
    wf_shape = (f"G=6 T={sl['T_post']} B={B} H={H} bfloat16, no dropout (base-85M's post-stack; "
                "library: cuDNN nn.LSTM(num_layers=6) with layer 0's input projection, I0=2048)")
    wf_per = "phase 9: the wavefront at three full-width shapes, forward and f+b"

    def knob_row(check: str, route: str, wrapper: str, shape: str):
        cell = knob["train"][route]
        return (joint[check], cell["bfloat16"]["rows"][-1]["launches"][wrapper], shape,
                f"large-196M train step, B={cell['B']}, {cell['knobs']}")
    rows = {
        "lstm_recurrence": (lstm["base", "bfloat16"]["K1"], sl["bfloat16"]["launches"], layer,
                            "base-85M transcription"),
        "lstm_recurrence_sg": (lstm["base", "bfloat16"]["K3a"],
                               train_counts["lstm_recurrence_sg"], layer, base_step),
        "lstm_recurrence_bwd": (lstm["base", "bfloat16"]["K3b"],
                                train_counts["lstm_recurrence_bwd"], layer, base_step),
        "joint_fwd": (joint["K2"], val["launches"]["joint_fwd"], joint_shape,
                      "base-85M validation batch"),
        "joint_fwd_store": (joint["K5-store"], train_counts["joint_fwd_store"], joint_shape,
                            base_step),
        "joint_bwd_dh": (joint["K5-A"], train_counts["joint_bwd_dh"], joint_shape, base_step),
        "joint_bwd_dw": (joint["K5-B"], train_counts["joint_bwd_dw"], joint_shape, base_step),
        "joint_fwd_store8": (joint["K7-store8"], counts32["joint_fwd_store8"], shape32, large32),
        "joint_bwd_fused_u8": (joint["K7-fused-u8"], counts32["joint_bwd_fused_u8"], shape32,
                               large32),
        "joint_bwd_fused": (joint["K6-fused"], counts64["joint_bwd_fused"], shape64, large64),
        "joint_bwd_fused_u": knob_row("K5-fused-u", "fused_u", "joint_bwd_fused_u", shape16),
        "joint_bwd_dh_u8": knob_row("K7-A8", "i8_two", "joint_bwd_dh_u8", shape32),
        "joint_bwd_dw_u8": knob_row("K7-B8", "i8_two", "joint_bwd_dw_u8", shape32),
        "joint_derive_a": knob_row("K6-derive-a", "rechunk", "joint_derive_a",
                                   f"N={chunk} (one row chunk of {n64}) Hj={Hj_l} K={K_l} "
                                   "bfloat16"),
        "joint_bwd_dh_recompute": knob_row("K4-A", "recompute", "joint_bwd_dh_recompute",
                                           shape64),
        "joint_bwd_dw_recompute": knob_row("K4-B", "recompute", "joint_bwd_dw_recompute",
                                           shape64),
        "lstm_wavefront": (k8["K8-fwd"], wavefront["launches"]["lstm_wavefront"], wf_shape,
                           wf_per),
        "lstm_wavefront_bwd": (k8["K8-bwd"], wavefront["launches"]["lstm_wavefront_bwd"],
                               wf_shape, wf_per),
    }
    if wavefront["launches"]["lstm_wavefront_sg"] == 0:
        raise AssertionError(f"K8-fwd storing its gates was not launched ({wf_per})")
    kernels = []
    for name, _, wrapper, src, replaces in KERNELS:
        r, launches, shape, per = rows[wrapper]
        if launches == 0:
            raise AssertionError(f"{name} was not launched on the main path ({per})")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"caiman_asr_tpu_torch/ops/csrc/{src}", "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": shape, "launches_per": per,
        })
        if wrapper == "lstm_wavefront":  # the same kernel storing its gates
            sg = k8["K8-fwd-sg"]
            kernels[-1].update({
                "launches_store_gates": wavefront["launches"]["lstm_wavefront_sg"],
                "ms_store_gates": sg["ms"], "plain_ms_store_gates": sg["plain_ms"],
                "bound_ms_store_gates": sg["bound_ms"], "library_ms_store_gates": sg["library_ms"],
                "max_abs_err_store_gates": sg["max_abs_err"]})

    def summary(run, extra=None):
        return {"step_ms": [r["ms"] for r in run["rows"]],
                "loss": [r["loss"] for r in run["rows"]],
                "grad_norm": [r["grad_norm"] for r in run["rows"]],
                "peak_gib": run["peak_bytes"] / 2 ** 30, **(extra or {})}

    base = {dt: summary(run, {"breakdown_ms": breakdown[dt], "profile": profiled[dt]})
            for dt, run in runs.items()}
    large_summary = {
        str(Bt): {"N": c["N"], "plan": c["plan"], "bfloat16": summary(c["bfloat16"]),
                  "float32": summary(c["float32"]), "breakdown_ms": c["breakdown_ms"],
                  "profile": c["profile"]}
        for Bt, c in cells.items()}
    log("train summary: " + json.dumps({"train": base, "whole_step": whole,
                                        "validation": val, "store_plan": plan}))
    log("large-196M summary: " + json.dumps({
        "train": large_summary, "routes": large["routes"], "whole_step": large["whole_step"],
        "validation": large["validation"], "slice": large["slice"]}))
    strip = lambda r: {k: v for k, v in r.items() if k not in ("max_abs_err", "err_of")}
    log("large-196M knob routes summary: " + json.dumps({
        "train": {route: {"N": c["N"], "B": c["B"], "knobs": c["knobs"], "plan": c["plan"],
                          "bfloat16": summary(c["bfloat16"]),
                          "launches": c["bfloat16"]["rows"][-1]["launches"]}
                  for route, c in knob["train"].items()},
        "whole_step": knob["whole_step"], "rechunked_backward": rechunked,
        "hybrid_kernels": {part: {k: strip(r) for k, r in rs.items()}
                           for part, rs in hybrid.items()}}))
    log("pass B summary: " + json.dumps({
        f"K5-B {joint_shape}": strip(joint["K5-B"]), f"K5-B {shape16}": strip(large16["K5-B"]),
        f"K7-B8 {shape32}": strip(joint["K7-B8"]),
        "B halves": {"K5-fused-u": strip(joint["K5-fused-u"]),
                     "K7-fused-u8": strip(joint["K7-fused-u8"]),
                     "K6-fused": strip(joint["K6-fused"]), "K4-B": strip(joint["K4-B"]),
                     "rechunked backward": rechunked}}))
    log("pass A summary: " + json.dumps({
        f"K5-A {joint_shape}": strip(joint["K5-A"]), f"K5-A {shape16}": strip(large16["K5-A"]),
        f"K7-A8 {shape32}": strip(joint["K7-A8"]),
        "A halves": {"K5-fused-u": strip(joint["K5-fused-u"]),
                     "K7-fused-u8": strip(joint["K7-fused-u8"]),
                     "K6-fused": strip(joint["K6-fused"]), "K4-A": strip(joint["K4-A"]),
                     "K6-derive-a": strip(joint["K6-derive-a"])}}))
    log("forward summary: " + json.dumps({
        f"K2 {joint_shape}": strip(joint["K2"]), f"K5-store {joint_shape}": strip(joint["K5-store"]),
        f"K5-store {shape16}": strip(large16["K5-store"]),
        f"K7-store8 {shape32}": strip(joint["K7-store8"]), f"K2 {shape64}": strip(k2_64["K2"]),
        "hybrid K5-store": strip(hybrid["stored"]["K5-store"])}))
    log("derive summary: " + json.dumps({
        f"derivation alone, N={chunk} Hj={Hj_l} K={K_l}": derivation,
        "K6-derive-a": strip(joint["K6-derive-a"]), "K4-A": strip(joint["K4-A"]),
        "K4-B": strip(joint["K4-B"]), "K6-fused": strip(joint["K6-fused"]),
        "hybrid K4-A": strip(hybrid["recomputed"]["K4-A"]),
        "hybrid K4-B": strip(hybrid["recomputed"]["K4-B"])}))
    log("lstm summary: " + json.dumps({
        f"{cell} T={T} B={Bs} H={Hs} {name}": lstm[cell, name]
        for cell, (T, Bs, Hs) in lstm_shapes.items() for name in ("bfloat16", "float32")}))
    log("k8 summary: " + json.dumps(k8_summary))
    log("wavefront summary: " + json.dumps(
        {name: r for name, r in wavefront.items() if name != "launches"}))
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
