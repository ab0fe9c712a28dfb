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
     number and the fp32 result must equal the plain path's; the greedy
     loop runs as CUDA graph replays, one host read a chunk (its
     iterations, chunks and host reads printed), and its replays, first
     and cached, equal its eager chunks on the card bit for bit;
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
     path, the validation loss and offline transcription (its loop checked
     as in phase 3);
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
     floors; the per-layer stack timed beside it;
  10. the streaming engine and server (base-85M, greedy, 4 symbols a tick):
     K1 against its plain version at the tick's shapes (H=1,024, T=2 and
     T=1, B = 4,096, 8,192 and 16,384: one, two and three or more batch
     slices, fp32 and bf16); in fp32 the engine's streamed tokens for the smoke's utterances (cut to
     whole 60 ms chunks), fed a chunk a tick, against offline.transcribe's,
     both at one symbol a frame (past one the two count differently), with
     K1's launches counted on every tick; the CUDA graph's ticks
     against the eager ticks, bit for bit, over 20 ticks with lanes opening
     and closing; K1 at B=8,192 through its batch split (8 layers x 2
     slices a tick); ASRServer.handle and its ticker driven in process
     through a minimal connection object, streams to EOS, an odd-length
     frame and a client past capacity refused; the compute path (ms a graph
     replay at B = 1,024, 4,096, 8,192), K1 alone at those batches at T=2
     and T=1, and bench_serving's engine tiers on a short ladder (8,192,
     4,096);
  11. the router and the clients (base-85M, greedy, fp32, one symbol a
     tick): the smoke's utterances written as WAV, read back by read_audio;
     MultiChipEngine over every visible card and over two engines on one
     card (thread pool, serial captures, concurrent replays, global ids,
     wire mode) against one StreamingEngine, transcript for transcript, K1
     counted on every replay; build_engine with --num_chips past the card
     count exits; the transcriber's loop (FileStreamer, realtime=False) and
     measures.measure against ASRServer.handle over two engines, in
     process: WER 0 against one engine's transcripts, the WER against the
     offline fp32 transcripts of the same audio and the latency fields
     printed;
  12. the beam serving path (base-85M, W=4, E=4): the offline fixed-expansion
     beam (FastBeamDecoder through offline.transcribe) in fp32 and bf16, K1
     counted, the fp32 hypotheses against the plain path's, its chunks as
     CUDA graph replays (frames, chunks, host reads printed) equal to eager
     chunks bit for bit; the host beam (RNNTBeamDecoder) beside it, the share
     of equal best paths printed; StreamingEngine(decoder="beam") with the
     server's thresholds fed a chunk a tick, its live hypotheses against the
     offline beam's, K1 counted on every tick; its graph ticks against eager
     ticks bit for bit over 20 ticks with lanes opening and closing and
     rebases firing; a synthetic n-gram (its device tables: S states x 8,704)
     and keyword list fused offline and streamed, the two equal, fusion
     changing some best path; ASRServer.handle over a beam engine; the beam
     tick's compute path and bench_serving --decoder beam on a short ladder;
  13. the train step as the JAX trainer runs it by default (base-85M, A=2
     microbatches of the smoke's utterances with random transcripts holding
     EOS and star tokens, bf16): the train FeaturePipeline with
     configs/base-8703sp.yaml's SpecAugment (masked entries exactly 0, in
     whole bands, the rest equal to the eval features; the masked share
     beside its expectation) and the mel-normalisation ramp; four steps
     with random state passing (an RSPController carrying state within the
     first steps, its gates printed), the packed joint at pack_cap's cap
     (host lattice sizes equal to the device's; both plans printed), the
     delay penalty's StepSchedule, gradient noise and layer statistics, every
     launch count equal to the expected number; the same step packed and
     dense, timed in turns, with a breakdown of each and the joint's forward
     and backward profiled by kernel; an undercounted cap
     skipping the step with parameters, EMA and moments bit-identical; in
     fp32 without dropout, the packed loss and gradients against the dense
     ones and the RSP step from the carried state against its plain path
     (loss, gradients, returned state); a batch-norm base-85M taking two
     bf16 steps, its folded running stats against the plain path's;
  14. validation as val.py runs it (base-85M from configs/base-8703sp.yaml,
     fp32): the smoke's utterances written as WAV with a manifest of random
     transcripts, the smoke tokenizer, their mel statistics and a checkpoint
     the port writes (the blank calibrated, the EMA a perturbed copy) under
     build/smoke/val/; val.validate on parsed argv (--calc_loss --dump_preds
     --dump_ctm, batches of 8) with the kernels and under plain_path(): the
     model holding the EMA leaves bit for bit, hypotheses and WER identical,
     at least 12 of 16 non-empty, the loss within 1e-5, K1 8 a decoded batch
     and 10 a loss batch, K2 one a batch; the same with --decoder fast_beam;
     ms a batch, audio-s per s, the decode's and the loss's shares;
  15. the training CLI (python -m caiman_asr_tpu_torch.train, base-85M from
     configs/base-8703sp.yaml on the phase-14 workspace with its manifest
     listed twice, the smoke tokenizer, mel statistics from
     generate_mel_stats.main, four seeded noise clips; bf16, A=2 x B=16,
     RSP [99, 0, 1] from step 0, packing, SpecAugment, background noise
     0.25 from step 0, validation and checkpoints every 2 steps, a train
     sample at step 4): 4 steps, then 2 steps and --resume to 4 in another
     directory, the resumed steps' losses and gradient norms and the
     step-4 checkpoint's params, EMA and optimizer leaves equal to the bit
     (else named and held within 1e-6 relative); K3a / K3b / K5 launches a
     step; ms a step, PhaseTimers' shares, ms a validation, a checkpoint's
     MB and save ms; the step-4 checkpoint through create_serving_bundle,
     the server built from the bundle and from --ckpt + --mel_stats_path
     (equal weights and statistics, identical streamed transcripts of the
     16 utterances); a 200-step synthetic_e2e whose mean loss over its last
     20 steps falls below half that of its first 20;
  16. training over several processes (python -m torch.distributed.run
     --standalone --nproc_per_node 2 running this script's rank worker,
     which calls train.main on parsed argv with --multihost, as python -m
     caiman_asr_tpu_torch.train does; base-85M, A=2 x B=8 a rank, two
     ranks on one card over gloo): (a) fp32 over phase 15's manifests with
     nothing random, 4 steps, one validation: each step's loss within 1e-5
     and gradient norm within 1e-4 of a one-process run at B=16 on the
     same global batches; (b) bf16 on tar shards of those utterances
     (data/make_webdataset), the base config's randomness, RSP and
     packing, 4 steps; (c) a new launch resuming (b)'s step-2 checkpoint
     to step 4, equal to (b) to the bit; in each run every rank's final params, EMA and
     moments equal to the bit (SHA-256), K3a, K3b and the joint's kernels
     launched on every step of every rank, and the dev WER and hypotheses
     equal to a one-process validation of the run's step-4 checkpoint; ms
     a step and the gradient all-reduce's ms a step per rank; with two
     cards, (a) again over NCCL;
  17. latency measurement and the data and evaluation tools (the phase-14
     workspace, phase 15's synthetic_e2e model, phase 16's shards): python
     -m caiman_asr_tpu_torch.latency.generate_gt_ctm at base-85M, fp32, B=8,
     with the kernels and under plain_path(): K1 10 a batch, the lattice
     scores within 1e-4, the alignments equal or a tie's scores within 1e-4,
     ms a batch split into the host's Viterbi and the rest; --segment_len 1
     on the 16 utterances joined (81 s, two segments) giving the whole
     utterance's CTM; val.py --dump_ctm --calculate_emission_latency --gt_ctm
     on that CTM and measure_latency on the two CTMs, their mean and median
     emission latency equal, for base-85M and the trained synthetic_e2e
     model; val_multiple over two checkpoints x two manifests with
     --calc_loss, each row's WER and hypotheses equal to a separate
     val.validate run's and its loss within 1e-5, K1 and K2 counted;
     torch_export then torch_import giving the .npz back to the bit, the .pt
     loaded by the port transcribing phase 3's utterances to the same tokens;
     spm_train and generate_mel_stats with --read_from_tar on the dev shards
     equal to their runs on the manifest;
  18. the rest of inference (phase 14's workspace, phase 15's synthetic_e2e
     model): (a) a 3-gram by train_ngram over phase 14's transcripts in the
     smoke tokenizer's pieces, written as a kenlm PROBING and a TRIE binary:
     every n-gram's score equal across the three files (the binaries' to
     each other, the ARPA's within 1e-6), the device tables equal, and
     val.py's fp32 fast beam (W=4, E=8) fused from each file giving
     identical hypotheses, K1 8 a batch; (b) val.py --decoder beam
     --beam_parallel_procs 2 on the two shortest utterances, its tokens
     equal to the one-process host beam with the workers' kwargs on the
     CPU, K1 the parent's 8; (c) sweep_scale_factor over three scales on
     the synthetic_e2e model with a 3-gram from its train transcripts, scale
     0 equal to a beam run without the LM; (d) base-85M with quantize: true
     validated greedy on the shortest utterance: no K1, each layer
     quantized once; its LSTM output on the card bit-equal to the CPU's (a
     share stated, the rest within one brain-float ulp), its encoder output
     within the stated tolerance of the CPU's and far from the unquantized
     model's on the same weights, the greedy tokens equal to the CPU's; a bf16
     serving engine's tick captured as a CUDA graph whose replays equal its
     eager ticks bit for bit;
  19. the pruned loss and the model-parallel train step (base-85M's widths):
     (a) the pruned loss at phase 4's batch (bf16, B=16, band 5): its kernels
     (K5-store, K5-A, K5-B on the banded rows) against the plain path, loss
     1e-5, fp32 gradients 1e-3 and bf16 gradients one bf16 ulp (2^-7 of the
     largest magnitude: both paths round their fp32 sums to bf16), and both
     paths' gradients against the same inputs in fp32 end to end, the
     kernels' no farther from it than the plain path's + 1e-3; the full band
     against the dense loss; one
     pruned train step against one dense step, warm and in turns, and the
     pruned loss's stages (the simple stage, the posteriors and ranges, the
     banded joint, the banded lattice) against the dense loss's; (b) and (c)
     in one python -m torch.distributed.run launch of two ranks on one card
     (gloo), this script's --rank-worker: (b) the vocab-parallel joint on two
     shards of 4,352 classes at 16,384 rows, its slab over 2,048 columns of
     each, so that K2, K5-store, K5-A, K5-B, K4-A and K4-B all launch on
     every rank, against one process's fused_joint_lse and against its plain
     version (lp 1e-5, db 1e-3, dh and dW one bf16 ulp) and against the
     fp32 reference (no farther than one process's + 1e-3), timed; (c)
     train.main --model_parallel 2 three times in those ranks, A=2 x B=8,
     2 steps each: fp32 with nothing random, each step's loss within 1e-5
     and gradient norm within 1e-4 of one process's, its validation (the
     EMA's vocab shards gathered) equal in WER and hypotheses to one
     process's of its checkpoint; bf16 packed; the pruned loss, whose
     checkpoint (whole arrays) one process resumes for a step; (d)
     synthetic_e2e --pruned 4 for phase 15's 200 steps, its loss falling
     below half;
  20. the fused LAMB finish (F0, F1, F2: ops/csrc/lamb_finish.cu, the three
     passes of training/fused_finish.py) at base-85M's and large-196M's 47
     leaves from a seeded generator: 3 finishes in a row of the kernels
     beside their plain versions, each pass on the same inputs, the moments
     equal to the bit, the norms within 1e-6 relative, the parameters and
     EMA within 1e-6 of each leaf's largest magnitude; each pass and the
     whole finish (Lamb.update, 3 launches) timed warm as the median of 20,
     kernels and plain versions, beside the bound (52 bytes a parameter at
     the HBM rate) and torch.optim.Adam(fused=True)'s step over the same
     leaves (Adam, one pass, not LAMB).

The train steps of phases 4, 7, 13, 15, 16 and 19 also count the finish:
each pass once a taken step, pass 0 alone on a skipped one. Phase 2 holds
the finish's passes against their plain versions at leaves of 1, 3, 4,097
and 2^20 + 5 elements (one without a gradient, one overwritten, NaN and inf
entries), with and without the clip.

Prints the kernels line and, last, {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; without a GPU it exits non-zero at once.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import difflib
import functools
import json
import math
import os
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
    # the fused LAMB finish's passes 0, 1, 2: no Pallas site, their JAX
    # counterpart is XLA's fusion of training/fused_finish.py:96's passes
    ("F0 lamb_finish_norms (no Pallas site)", "finish_kernel", "lamb_finish_norms",
     "lamb_finish.cu", "caiman_asr_tpu/training/fused_finish.py:127"),
    ("F1 lamb_finish_moments (no Pallas site)", "finish_kernel", "lamb_finish_moments",
     "lamb_finish.cu", "caiman_asr_tpu/training/fused_finish.py:151"),
    ("F2 lamb_finish_apply (no Pallas site)", "finish_kernel", "lamb_finish_apply",
     "lamb_finish.cu", "caiman_asr_tpu/training/fused_finish.py:178"),
]
# Wrappers counted and swapped for their plain versions like those above,
# with no row of their own: K8-fwd storing its gates (the K8-fwd row reports
# it beside the plain forward, as one Pallas kernel does both).
MORE_WRAPPERS = (("wavefront_kernel", "lstm_wavefront_sg"),)
LSTM_TRAIN_KERNELS = ("lstm_recurrence_sg", "lstm_recurrence_bwd")
# The fused LAMB finish: each pass launches once a taken step (a skipped
# step runs pass 0 alone, for the gradient norm)
FINISH_KERNELS = ("lamb_finish_norms", "lamb_finish_moments", "lamb_finish_apply")
FINISH_STEP = dict.fromkeys(FINISH_KERNELS, 1)
FINISH_SKIPPED = {"lamb_finish_norms": 1}
# Phases 2 and 20: the finish's passes against their plain versions. Phase
# 2's leaves (unaligned, one without a gradient, one overwritten, NaN and
# inf entries); the tolerances: the moments equal to the bit (the plain
# version's operation order, no FMA contraction); the norms 1e-6 relative
# (sums in another order); the parameters and EMA 1e-6 of each leaf's
# largest magnitude (the trust ratio from those norms). Phase 20: 3 finishes in a row at each model's leaves,
# timed warm as the median of 20; 52 bytes a parameter (pass 0 reads 4,
# pass 1 reads 16 and writes 8, pass 2 reads 16 and writes 8).
FINISH_SIZES = (1, 3, 4097, 2 ** 20 + 5)
FINISH_RTOL = 1e-6
FINISH_STEPS, FINISH_REPS = 3, 20
FINISH_BYTES = {"lamb_finish_norms": 4, "lamb_finish_moments": 24, "lamb_finish_apply": 24}
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


@functools.cache
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


@contextlib.contextmanager
def loop_runs():
    """Within: each GreedyDecoder.decode_encs call's loop statistics
    (iterations, chunks, host reads, graph), in order."""
    from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder

    runs, real = [], GreedyDecoder.decode_encs

    def decode_encs(self, *args, **kw):
        out = real(self, *args, **kw)
        runs.append(dict(self.last_run, chunk_iters=self.chunk_iters))
        return out

    with mock.patch.object(GreedyDecoder, "decode_encs", decode_encs):
        yield runs


_T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase's header (``== ...``) with the seconds since
    the script started."""
    if msg.startswith("== "):
        msg += f" [{time.perf_counter() - _T_START:.1f} s]"
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
    from caiman_asr_tpu_torch.ops import finish_kernel, joint_kernel, lstm_kernel, wavefront_kernel

    return {"lstm_kernel": lstm_kernel, "joint_kernel": joint_kernel,
            "wavefront_kernel": wavefront_kernel, "finish_kernel": finish_kernel}[name]


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


def calibrate_blank(model, feats, feat_lens, start_emit: float = MIN_START_EMIT) -> float:
    """Raise the blank bias so that blank is the argmax on all but EMIT_SHARE
    of the (frame, prediction state) pairs, the states being the start state
    and those after CALIB_TOKENS random tokens — but on no more than
    1 - start_emit of the frames from the start state, so that decoding
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
            torch.quantile(margin[..., 0][valid], 1.0 - start_emit),
        )
        model.joint_net[2].bias[-1] += raise_by
    return float(raise_by)


def tokens(responses):
    from caiman_asr_tpu_torch.decoding.response import frame_responses_to_tokens

    return [frame_responses_to_tokens(r) for r in responses]


def run_slice(name: str = "base-85M") -> dict:
    import numpy as np
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
        with loop_runs() as runs:
            responses = offline.transcribe(model, audio, lens, device="cuda", dtype=dtype,
                                           pipeline=pipe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lstm_kernel.lstm_recurrence.launches
        loop = runs[-1]
        log(f"  transcribe {dname}: {wall * 1e3:.1f} ms (greedy loop on the device, its CUDA "
            f"graph captured in this call; the host loop before it: 1981.1 ms at base-85M fp32, "
            f"PERF.md §5), "
            f"{audio_secs / wall:.1f} audio-s/s on {card()}; lstm_recurrence_fwd launches "
            f"{launches} (expected {expected}); greedy loop: {loop['iters']} iterations in "
            f"{loop['chunks']} chunks of {loop['chunk_iters']}, {loop['host_reads']} host reads")
        if launches != expected:
            raise AssertionError(f"{dname}: {launches} launches, expected {expected}")
        if len(runs) != 1 or not loop["graph"] or loop["host_reads"] != loop["chunks"]:
            raise AssertionError(f"{dname}: the greedy loop did not replay one graph a chunk, "
                                 f"one host read each: {runs}")
        out[dname] = {"responses": responses, "launches": launches, "wall_s": wall,
                      "loop": loop}

        # layer times of this run's path, each ending in a synchronise; the
        # loop as a first call (capture and replays), from the cache, and as
        # eager chunks on the card
        with torch.inference_mode():
            decoder = GreedyDecoder(model, model.n_classes - 1)
            t0 = time.perf_counter()
            f_in, fl = fp(audio, lens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            encs, enc_lens, _ = model.encode(f_in.to(dtype), fl)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            first = decoder.decode_encs(encs, enc_lens)
            t3 = time.perf_counter()
            cached = decoder.decode_encs(encs, enc_lens)
            t4 = time.perf_counter()
            eager_decoder = GreedyDecoder(model, model.n_classes - 1, cuda_graph=False)
            eager = eager_decoder.decode_encs(encs, enc_lens)
            t5 = time.perf_counter()
        same = all(np.array_equal(a, b) and np.array_equal(a, c)
                   for a, b, c in zip(first, cached, eager))
        if not (decoder.last_run["graph"] and not eager_decoder.last_run["graph"]):
            raise AssertionError(f"{dname}: the loops did not take the routes asked for")
        out[dname].update(featurize_ms=1e3 * (t1 - t0), encode_ms=1e3 * (t2 - t1),
                          decode_first_ms=1e3 * (t3 - t2), decode_cached_ms=1e3 * (t4 - t3),
                          decode_eager_ms=1e3 * (t5 - t4), encs=encs, enc_lens=enc_lens,
                          graph_equals_eager=same)
        log(f"    featurize {1e3 * (t1 - t0):.2f} ms | encode {1e3 * (t2 - t1):.2f} ms"
            f" | greedy decode: first call (capture + replays) {1e3 * (t3 - t2):.2f} ms, "
            f"cached graph {1e3 * (t4 - t3):.2f} ms, eager chunks {1e3 * (t5 - t4):.2f} ms; "
            f"graph replays vs eager chunks: tokens, frames, log-probs and counts bit-equal: "
            f"{same}")
        if not same:
            raise AssertionError(f"{dname}: the greedy loop's graph replays differ from its "
                                 "eager chunks")

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
        r["plain_ms"] = cuda_ms(plain, reps=1, warmup=1)
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
    for i, r in enumerate(rows):
        check_finish_launches(r["launches"], f"{tag} step {i + 1}")
    return {"rows": rows, "model": model, "opt": opt, "state": state, "gen": gen,
            "compute": compute, "peak_bytes": peak, "step": step}


def check_finish_launches(counts: dict, tag: str, taken: bool = True) -> None:
    """The fused LAMB finish's launches in one step's ``counts``: each pass
    once (a skipped step: pass 0 alone)."""
    got = {k: counts.get(k, 0) for k in FINISH_KERNELS}
    want = {k: (FINISH_STEP if taken else FINISH_SKIPPED).get(k, 0) for k in FINISH_KERNELS}
    if got != want:
        raise AssertionError(f"{tag}: the LAMB finish launched {got}, expected {want}")


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


def step_breakdown(run: dict, batch, pack_to=None) -> dict:
    """Two more steps of ``run``'s model on the first microbatch of
    ``batch`` (packed to ``pack_to`` rows when given), phase by phase, each
    phase ending in a synchronise: ms per phase of the second (the first
    pays one-time allocations)."""
    _step_phases(run, batch, pack_to)
    times = _step_phases(run, batch, pack_to)
    total = sum(times.values())
    log(f"  step breakdown, B={batch['feats'].shape[2]} "
        f"{'bf16' if run['compute'] is not None else 'fp32'}"
        f"{'' if pack_to is None else f', packed to {pack_to} rows'} (ms, share): "
        + "; ".join(f"{k} {v:.1f} ({v / total:.0%})" for k, v in times.items()))
    return times


def _step_phases(run: dict, batch, pack_to=None) -> dict:
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
    (f, f_lens), (g, _), _ = model.enc_pred(feats, mb["feat_lens"], mb["txt"], mb["txt_lens"],
                                            params=p, train=True, generator=run["gen"])
    mark("encoder + predictor forward (K3a)")
    w_fc, b_fc = p["joint_fc"]["w"], p["joint_fc"]["b"]
    if pack_to is None:
        lp_b, lp_l = tl._fused_joint_scores(f, g, w_fc, b_fc, mb["txt"], blank, run["gen"],
                                            model.cfg.joint_dropout)
    else:
        lp_b, lp_l = tl._packed_joint_scores(f, g, w_fc, b_fc, mb["txt"], f_lens,
                                             mb["txt_lens"], blank, pack_to, run["gen"],
                                             model.cfg.joint_dropout)
    mark("joint forward" if pack_to is None else f"joint forward, packed to {pack_to} rows")
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


def profile_joint(run: dict, batch, pack_to=None, top: int = 8) -> dict:
    """The joint's forward and backward on the first microbatch of
    ``batch`` (packed to ``pack_to`` rows when given), from f and g to their
    gradients, under torch.profiler: device ms by kernel, the ``top``
    largest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from caiman_asr_tpu_torch.ops import transducer_loss as tl
    from caiman_asr_tpu_torch.training.step import _cast_compute

    model = run["model"]
    mb = {k: v[0] for k, v in batch.items()}
    p, feats = _cast_compute(run["state"].params, mb["feats"], run["compute"])
    with torch.no_grad():
        (f, f_lens), (g, _), _ = model.enc_pred(feats, mb["feat_lens"], mb["txt"],
                                                mb["txt_lens"], params=p)
    leaves = [t.detach().requires_grad_() for t in (f, g, p["joint_fc"]["w"],
                                                    p["joint_fc"]["b"])]
    blank, rate = model.n_classes - 1, model.cfg.joint_dropout

    def joint():
        f_, g_, w_, b_ = leaves
        if pack_to is None:
            out = tl._fused_joint_scores(f_, g_, w_, b_, mb["txt"], blank, run["gen"], rate)
        else:
            out = tl._packed_joint_scores(f_, g_, w_, b_, mb["txt"], f_lens, mb["txt_lens"],
                                          blank, pack_to, run["gen"], rate)
        torch.autograd.grad(out, leaves, [torch.ones_like(o) for o in out])

    joint()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        joint()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    route = "dense" if pack_to is None else f"packed to {pack_to} rows"
    log(f"  the joint forward and backward, {route}: {total:.2f} device ms; "
        + "; ".join(f"{k[:70]} {v:.2f}" for k, v in ranked))
    return {"device_ms": total, "top_ms": dict(ranked)}


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


def step_grads(model, mb, **kw):
    """(loss, gradients by parameter name, new state) of one fp32
    microbatch; ``kw`` as ``_micro_loss`` takes them (``pack_to``,
    ``rnnt_state``, ``gate``, ``bn_updates``)."""
    import torch

    from caiman_asr_tpu_torch.ops.transducer_loss import LossModifiers
    from caiman_asr_tpu_torch.training.step import _micro_loss
    from caiman_asr_tpu_torch.training.tree import tree_items

    items = [(p, leaf) for p, leaf in tree_items(model.param_tree()) if leaf.requires_grad]
    loss, state = _micro_loss(model, model.param_tree(), mb, None, LossModifiers(),
                              mb["feats"].shape[1], model.n_classes - 1, **kw)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in items])
    return loss.detach(), {".".join(p): g for (p, _), g in zip(items, grads)}, state


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
        loss_k, g_k = step_grads(model, mb)[:2]
        counts = read_counts()
        with plain_path():
            loss_p, g_p = step_grads(model, mb)[:2]
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


def compare_grads(got, want, what: str, grad_rtol: float = GRAD_RTOL) -> dict:
    """(loss, gradients by name) against another such pair: the loss at
    LOSS_RTOL, each gradient at ``grad_rtol`` of its largest magnitude."""
    (loss, grads), (loss_ref, g_ref) = got, want
    loss_err = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    errs = {n: rel_err(grads[n], g_ref[n]) for n in grads}
    worst = max(errs, key=errs.get)
    log(f"  {what}: loss {float(loss):.6f} vs {float(loss_ref):.6f} (relative {loss_err:.3g}, "
        f"tol {LOSS_RTOL}); worst gradient {worst}: {errs[worst]:.3g} of its largest "
        f"magnitude (tol {grad_rtol})")
    if not loss_err <= LOSS_RTOL or not errs[worst] <= grad_rtol:
        raise AssertionError(f"{what}: {loss_err}, {errs}")
    return {"loss_rel_err": loss_err, "grad_rel_err": errs[worst], "worst": worst}


def compare_routes(got, ref, store, name: str, n_utts: int) -> dict:
    """(loss, gradients) of the route ``store`` against the bf16-slab
    route's on the same utterances, at LOSS_RTOL and ROUTE_RTOL."""
    return compare_grads(got, ref, f"routes, {name}, fp32, B={n_utts}: {ROUTE_NAME[store]} vs "
                         "the bf16 slab", ROUTE_RTOL[store])


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
            got[store] = step_grads(model, mb)[:2]
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
        ref = step_grads(model, check_microbatch(batch, name)[0])[:2]
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


# ------------------------------------------------------------ serving path
SERVE_MSYM = 4           # bench.py's max_symbols_per_step
# streamed against offline tokens at one symbol a frame: past one the two
# decoders count differently (the streaming step up to its cap a frame, the
# offline loop, the reference's batched greedy, until a count kept across
# frames reaches it), and a random model has states that emit without end
SERVE_CHECK_MSYM = 1
SERVE_COMPUTE_B = (1024, 4096, 8192)
SERVE_LADDER = (8192, 4096)
SERVE_GRAPH_B, SERVE_GRAPH_TICKS = 64, 20
SERVE_COUNT_B = 8192     # K1 counted on real ticks through its batch split
SERVE_K1_B = (4096, 8192, 16384)  # K1 vs plain at the tick's batches and slices
SERVE_STREAMS = 4        # streams the in-process server drives to EOS
# the blank raised less than in the slice, so that streams emit from the
# start state on a fifth of the frames: the token comparison is not vacuous
SERVE_START_EMIT = 0.2


class _Recorder:
    """An engine's serializer, recording each packed tick output it reads."""

    def __init__(self, ser):
        self.ser, self.packed = ser, []

    def __getattr__(self, name):
        return getattr(self.ser, name)

    def greedy_tick(self, packed, adv):
        import numpy as np

        self.packed.append((np.array(packed), np.array(adv)))
        return self.ser.greedy_tick(packed, adv)



class _Connection:
    """The little of a ``websockets`` connection that ``ASRServer.handle``
    uses: the request path, the client's frames as an async iterator, send
    and close."""

    def __init__(self, path: str, frames: list, gap_s: float = 0.0):
        from types import SimpleNamespace

        self.request = SimpleNamespace(path=path)
        self.frames, self.gap_s = frames, gap_s
        self.sent, self.closed = [], None

    async def _iter(self):
        import asyncio

        for f in self.frames:
            await asyncio.sleep(self.gap_s)
            yield f

    def __aiter__(self):
        return self._iter()

    async def send(self, msg):
        self.sent.append(msg)

    async def close(self, code: int = 1000, reason: str = ""):
        if self.closed is None:
            self.closed = (code, reason)


def _serving_model(name: str = "base-85M"):
    """base-85M at full width with the smoke's audio cut to whole 60 ms
    chunks, dataset mel statistics of that audio, and the blank raised as
    in the slice. Returns (model, audio [B, S] int16-grid fp32, lens,
    mel_stats, pipeline)."""
    import numpy as np
    import torch

    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig, LogMelFrontend

    audio, lens = synthetic_audio(SEED)
    lens = lens // 960 * 960
    audio = np.rint(audio[:, :int(lens.max())] * 32768.0).clip(-32768, 32767) / 32768.0
    audio = (audio * (np.arange(audio.shape[1])[None] < lens[:, None])).astype(np.float32)
    pipe = PipelineConfig(logmel=LogMelConfig(dither=0.0))
    with torch.inference_mode():
        mel, mel_lens = LogMelFrontend(pipe.logmel, device="cuda")(
            torch.from_numpy(audio).cuda(), torch.from_numpy(lens).cuda())
        mel = mel.transpose(1, 2)  # [B, T, n_mels]
        vals = mel[torch.arange(mel.shape[1], device="cuda")[None] < mel_lens[:, None]]
        mel_stats = (vals.mean(0).cpu().numpy(), vals.std(0).cpu().numpy())
    model = build_model(name, "cuda")
    fp = FeaturePipeline(pipe, mel_stats, device="cuda")
    feats, feat_lens = fp(torch.from_numpy(audio).cuda(), torch.from_numpy(lens).cuda(), None,
                          1.0)
    raised = calibrate_blank(model, feats, feat_lens, start_emit=SERVE_START_EMIT)
    return model, audio, lens, mel_stats, pipe, raised


def _stream_tokens(engine, audio, lens) -> list:
    """Every utterance on its own lane, 60 ms a tick, to EOS. Returns each
    utterance's tokens, read from the packed tick outputs."""
    import numpy as np

    rec = engine._native_ser = _Recorder(engine._native_ser)
    lanes = [engine.open_stream() for _ in range(len(lens))]
    ticks = int(lens.max()) // 960
    for t in range(ticks):
        for i, (lane, n) in enumerate(zip(lanes, lens)):
            if t * 960 < n:
                engine.push_audio(lane, np.rint(audio[i, t * 960:(t + 1) * 960] * 32768
                                                ).astype(np.int16))
            if (t + 1) * 960 >= n:
                engine.close_stream(lane)
        engine.tick()
    while engine.streams:
        engine.tick()
    toks = [[int(x) for p, adv in rec.packed if adv[lane] for x in p[lane, :p[lane, -1]]]
            for lane in lanes]
    return toks


def _graph_script(engine, ticks: int, seed: int, recorder=None) -> list:
    """Lanes opening, advancing unevenly and closing over ``ticks`` ticks;
    returns the packed outputs the serializer read."""
    import numpy as np

    rec = engine._native_ser = (recorder or _Recorder)(engine._native_ser)
    rng = np.random.default_rng(seed)
    lanes = [engine.open_stream() for _ in range(engine.B // 2)]
    for t in range(ticks):
        if t == ticks // 3:
            for lane in lanes[::4]:
                engine.close_stream(lane)
        if t == ticks // 2:
            lanes = lanes + [engine.open_stream() for _ in range(engine.B // 4)]
        for i, lane in enumerate(lanes):
            if lane in engine.streams and not engine.streams[lane].closed and (t + i) % 5:
                engine.push_audio(lane, (rng.normal(size=960) * 2000).astype(np.int16))
        engine.tick()
    return rec.packed


def _drive_server(engine, audio) -> dict:
    """``ASRServer.handle`` and its ticker in process, on ``engine``: the
    first 2 s of SERVE_STREAMS of the smoke's utterances (``audio``, on the
    int16 grid) in 100 ms frames to EOS, one odd-length frame (refused,
    1003) and, with every lane taken, one client past capacity (1013)."""
    import asyncio

    import numpy as np

    from caiman_asr_tpu_torch.serving.server import ASRServer

    path = "/asr/v0.1/stream?content_type=audio/x-raw;format=S16LE;channels=1;rate=16000"

    def frames(x):
        pcm = np.rint(x * 32768).astype("<i2").tobytes()
        return [pcm[i:i + 3200] for i in range(0, len(pcm), 3200)] + [b""]

    async def scenario():
        server = ASRServer(engine, tick_interval=0.005)
        ticker = asyncio.create_task(server._ticker())
        conns = [_Connection(path, frames(audio[i, :2 * SR]), 0.002)
                 for i in range(SERVE_STREAMS)]
        odd = _Connection(path, [b"\x00\x00\x00"])
        await asyncio.wait_for(asyncio.gather(*(server.handle(c) for c in conns + [odd])), 120)
        held = [engine.open_stream() for _ in range(engine.B)]
        full = _Connection(path, [b""])
        await server.handle(full)
        for lane in held:
            engine.close_stream(lane)
        while engine.streams:
            await asyncio.sleep(0.01)
        ticker.cancel()
        return conns, odd, full

    t0 = time.perf_counter()
    conns, odd, full = asyncio.run(scenario())
    msgs = [json.loads(m) for c in conns for m in c.sent]
    # each stream's finals in the order of their frames: none rewrites another
    starts = [[json.loads(m)["start"] for m in c.sent if not json.loads(m)["is_provisional"]]
              for c in conns]
    res = {"streams": len(conns), "responses": len(msgs), "wall_s": time.perf_counter() - t0,
           "closed": [c.closed for c in conns], "odd_frame": odd.closed, "past_capacity":
           full.closed, "finals_in_order": all(s == sorted(s) for s in starts)}
    if not all(c.closed == (1000, "") for c in conns):
        raise AssertionError(f"a stream did not end cleanly: {res}")
    if odd.closed[0] != 1003 or full.closed[0] != 1013:
        raise AssertionError(f"the server did not refuse as it should: {res}")
    if not msgs or not all({"start", "end", "alternatives"} <= set(m) for m in msgs):
        raise AssertionError(f"no well-formed responses from the server: {res}")
    if not res["finals_in_order"]:
        raise AssertionError(f"a stream's finals are out of order: {res}")
    return res


def run_serving() -> dict:
    """Phase 10: the streaming engine (one CUDA graph a tick) and server."""
    import numpy as np
    import torch

    from caiman_asr_tpu_torch import bench_serving, offline
    from caiman_asr_tpu_torch.decoding.response import frame_responses_to_tokens
    from caiman_asr_tpu_torch.ops import lstm_kernel
    from caiman_asr_tpu_torch.serving.engine import StreamingEngine

    # K1 against its plain version at the tick's shapes, through its batch
    # split: the encoder's H at T=2 (pre-stack) and T=1 (post-stack)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"k1_checks": []}
    for dtype in ("float32", "bfloat16"):
        for Bs in SERVE_K1_B:
            n = lstm_kernel.batch_slices(Bs, H, getattr(torch, dtype), sms)
            log(f"  K1 at B={Bs} {dtype}: {n} batch slice(s) of {-(-Bs // n)} rows")
            for T in (2, 1):
                res = check_recurrence(T, dtype, False, Bs, H)
                out["k1_checks"].append(dict(res, B=Bs, slices=n))
                torch.cuda.empty_cache()

    k1 = lstm_kernel.lstm_recurrence
    model, audio, lens, mel_stats, pipe, raised = _serving_model()
    n_classes = model.n_classes
    out["blank_raised"] = raised

    tokenizer = bench_serving.bench_tokenizer(n_classes)

    def engine(B, dtype, msym=SERVE_MSYM, **kw):
        return StreamingEngine(model, n_classes - 1, tokenizer, mel_stats, max_streams=B,
                               max_symbols_per_step=msym, dtype=dtype, device="cuda", **kw)

    # streamed tokens against offline transcription, fp32
    resp = offline.transcribe(model, audio, lens, mel_stats, device="cuda",
                              dtype=torch.float32, pipeline=pipe,
                              max_symbols_per_step=SERVE_CHECK_MSYM)
    want = [frame_responses_to_tokens(r) for r in resp]
    eng = engine(N_UTTS, torch.float32, SERVE_CHECK_MSYM, pipeline_depth=2,
                 logmel=pipe.logmel)
    eng.warmup()
    reset_counts()
    got = _stream_tokens(eng, audio, lens)
    counts = read_counts()
    ticks = int(lens.max()) // 960
    eng.close()
    n_tok = sum(map(len, want))
    same = sum(a == b for a, b in zip(got, want))
    log(f"  fp32 streamed vs offline tokens: {same}/{N_UTTS} utterances identical, "
        f"{n_tok} tokens offline, {sum(map(len, got))} streamed ({ticks} ticks of 60 ms, "
        f"{SERVE_CHECK_MSYM} symbol a frame)")
    if got != want or n_tok == 0:
        raise AssertionError("fp32 streamed tokens differ from offline transcription's")
    if counts["lstm_recurrence"] != ticks * eng.k1_launches_per_tick or any(
            v for name, v in counts.items() if name != "lstm_recurrence"):
        raise AssertionError(f"the serving path's launches: {counts} for {ticks}+ ticks")
    out["streaming_vs_offline"] = {"utterances": N_UTTS, "tokens": n_tok, "ticks": ticks,
                                   "launches": counts["lstm_recurrence"]}

    # the graph replay against the eager tick, bit for bit
    packed = {}
    for graph in (True, False):
        eng = engine(SERVE_GRAPH_B, torch.bfloat16, cuda_graph=graph)
        packed[graph] = _graph_script(eng, SERVE_GRAPH_TICKS, SEED)
        state = [t.clone() for hc in eng.enc_state for t in hc] + list(eng.dec_state)
        packed[graph, "state"] = state
        eng.close()
    equal = len(packed[True]) == len(packed[False]) >= SERVE_GRAPH_TICKS - 2 and all(
        np.array_equal(a, b) and np.array_equal(aa, ba)
        for (a, aa), (b, ba) in zip(packed[True], packed[False])) and all(
        torch.equal(a, b) for a, b in zip(packed[True, "state"], packed[False, "state"]))
    log(f"  graph replay vs eager tick, B={SERVE_GRAPH_B} bf16, {len(packed[True])} ticks with "
        f"lanes opening and closing: packed outputs and state bit-equal: {equal}")
    if not equal:
        raise AssertionError("the CUDA graph's ticks differ from the eager ticks")

    # K1 counted through the capture on real ticks at B=8192: 8 x slices
    slices = lstm_kernel.batch_slices(SERVE_COUNT_B, H, torch.bfloat16,
                                      torch.cuda.get_device_properties(0).multi_processor_count)
    eng = engine(SERVE_COUNT_B, torch.bfloat16, wire_responses=True)
    for _ in range(SERVE_COUNT_B):
        eng.open_stream()
    eng.warmup()
    block = (np.random.default_rng(SEED).normal(size=(SERVE_COUNT_B, 960)) * 2000).astype(
        np.int16)
    reset_counts()
    for _ in range(3):
        eng.push_audio_block(block)
        eng.tick()
    counts = read_counts()
    per_tick = eng.k1_launches_per_tick
    eng.close()
    layers = MODELS["base-85M"][0]["enc_pre_rnn_layers"] + MODELS["base-85M"][0][
        "enc_post_rnn_layers"]
    log(f"  B={SERVE_COUNT_B} bf16: K1 {per_tick} launches a tick ({layers} layers x {slices} "
        f"batch slices); 3 ticks counted {counts['lstm_recurrence']}")
    if per_tick != layers * slices or counts["lstm_recurrence"] != 3 * per_tick:
        raise AssertionError(f"K1 launches at B={SERVE_COUNT_B}: {per_tick} a tick, "
                             f"{counts['lstm_recurrence']} in 3 ticks")
    out["k1"] = {"B": SERVE_COUNT_B, "slices": slices, "per_tick": per_tick,
                 "launches_3_ticks": counts["lstm_recurrence"]}

    # the server, in process, on the card
    eng = engine(SERVE_STREAMS + 1, torch.float32, pipeline_depth=1, logmel=pipe.logmel)
    eng.warmup()
    out["server"] = _drive_server(eng, audio)
    eng.close()
    log(f"  server: {out['server']}")

    # timing: the compute path, then the engine tiers
    del model
    torch.cuda.empty_cache()
    bench_model = bench_serving.build_model("cuda", SEED)
    out["compute"] = []
    for Bc in SERVE_COMPUTE_B:
        c = bench_serving.compute_ms(bench_model, Bc)
        out["compute"].append(c)
        log(f"  compute path B={Bc} bf16: {c['ms_per_tick']:.3f} ms a graph replay, "
            f"K1 {c['k1_launches_per_tick']} launches a tick")
    out["k1"] = bench_serving.k1_times(SERVE_COMPUTE_B)
    log("  K1 alone at the tick's shapes, bf16: " + "; ".join(
        f"T={r['T']} B={r['b']} {r['ms']:.3f} ms ({r['launches']} launches)" for r in out["k1"]))
    out["ladder"] = bench_serving.run_ladder(bench_model, SERVE_LADDER, log=log)["rungs"]
    out["headline"] = bench_serving.headline(out["ladder"])
    log(f"  ladder headline: {out['headline']}")
    del bench_model
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ router and clients
ROUTER_DEVICES = ("cuda:0", "cuda:0")  # two engines on one card: the pool, gids, wire


class _End:
    """One end of an in-process duplex connection: the little of a
    ``websockets`` connection that ``ASRServer.handle`` (server end: the
    request path) and ``transcriber.stream_file`` (client end) use; closing
    either end ends the other end's iteration."""

    CLOSE = object()

    def __init__(self, inbox, outbox, path=None):
        from types import SimpleNamespace

        self.request = SimpleNamespace(path=path)
        self.inbox, self.outbox, self.closed = inbox, outbox, None

    @classmethod
    def pair(cls, path: str):
        import asyncio

        a, b = asyncio.Queue(), asyncio.Queue()
        return cls(a, b), cls(b, a, path)  # (client, server)

    async def send(self, msg):
        await self.outbox.put(msg)

    async def close(self, code: int = 1000, reason: str = ""):
        if self.closed is None:
            self.closed = (code, reason)
            await self.outbox.put(self.CLOSE)

    def __aiter__(self):
        return self

    async def __anext__(self):
        msg = await self.inbox.get()
        if msg is self.CLOSE:
            raise StopAsyncIteration
        return msg


def _stream_texts(engine, pcm: list) -> tuple:
    """Every utterance (int16 PCM, whole 60 ms chunks) on its own stream,
    a chunk a tick, to EOS, through the engine's public interface (global
    ids on a router). Returns (the stream ids, each stream's transcript)."""
    from caiman_asr_tpu_torch.serving.engine import WireTick

    gids = [engine.open_stream() for _ in pcm]
    parts = {g: [] for g in gids}

    def collect(out):
        if isinstance(out, WireTick):
            out = out.to_dict()
        for g, msgs in out.items():
            for m in msgs if isinstance(msgs, list) else [msgs]:
                m = json.loads(m) if isinstance(m, (str, bytes)) else m
                if m.get("alternatives"):
                    parts[g].append(m["alternatives"][0]["transcript"])

    for t in range(max(map(len, pcm)) // 960):
        for g, x in zip(gids, pcm):
            if t * 960 < len(x):
                engine.push_audio(g, x[t * 960:(t + 1) * 960])
                if (t + 1) * 960 >= len(x):
                    engine.close_stream(g)
        collect(engine.tick())
    while engine.streams:
        collect(engine.tick())
    return gids, ["".join(parts[g]).strip() for g in gids]


def _k1_expected(engines) -> int:
    """K1's launches over the ticks the engines dispatched."""
    return sum(e._tick_count * e.k1_launches_per_tick for e in engines)


def run_router_clients() -> dict:
    """Phase 11: MultiChipEngine over every visible card and over two
    engines on one card, build_engine past the card count, and the
    transcriber and measures against ASRServer.handle in process."""
    import asyncio
    import tempfile
    import wave
    from argparse import Namespace

    import numpy as np
    import torch

    from caiman_asr_tpu_torch import bench_serving, offline
    from caiman_asr_tpu_torch.data.audio import read_audio
    from caiman_asr_tpu_torch.decoding.response import frame_responses_to_tokens
    from caiman_asr_tpu_torch.inference import measures, transcriber
    from caiman_asr_tpu_torch.inference.file_streamer import FileStreamer
    from caiman_asr_tpu_torch.serving import server
    from caiman_asr_tpu_torch.serving.engine import StreamingEngine
    from caiman_asr_tpu_torch.serving.multi_chip import MultiChipEngine

    model, audio, lens, mel_stats, pipe, _ = _serving_model()
    n_classes = model.n_classes
    tokenizer = bench_serving.bench_tokenizer(n_classes)
    kw = dict(mel_stats=mel_stats, max_symbols_per_step=SERVE_CHECK_MSYM, dtype=torch.float32,
              logmel=pipe.logmel)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the smoke's utterances as WAV, read back, and the PCM the file
        # streamer sends of each (it scales by 32767 / 32768, truncating)
        paths, pcm = [], []
        for i, n in enumerate(lens):
            path = f"{tmp}/u{i:02d}.wav"
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SR)
                w.writeframes(np.rint(audio[i, :n] * 32768).astype("<i2").tobytes())
            if not np.array_equal(read_audio(path), audio[i, :n]):
                raise AssertionError(f"read_audio did not give back {path}'s samples")
            paths.append(path)
            pcm.append(np.frombuffer(b"".join(FileStreamer(path, realtime=False)), "<i2"))
        sent = np.zeros(audio.shape, np.float32)
        for i, x in enumerate(pcm):
            sent[i, :len(x)] = x / 32768.0

        # offline fp32 transcripts of that audio at one symbol a frame, and
        # one engine's streamed transcripts of it (phase 10 holds the two
        # equal on the smoke's own audio; on this audio they may part where
        # a decision is a near-tie, as their fp32 arithmetic differs)
        resp = offline.transcribe(model, sent, lens, mel_stats, device="cuda",
                                  dtype=torch.float32, pipeline=pipe,
                                  max_symbols_per_step=SERVE_CHECK_MSYM)
        refs = ["".join(tokenizer.id_to_piece(t) for t in frame_responses_to_tokens(r)
                        ).replace("\u2581", " ").strip() for r in resp]
        one = StreamingEngine(model, n_classes - 1, tokenizer, max_streams=N_UTTS,
                              device="cuda", **kw)
        one.warmup()
        _, want = _stream_texts(one, pcm)
        one.close()
        if not any(want):
            raise AssertionError("the streamed transcripts are empty: the checks are vacuous")
        same = sum(a == b for a, b in zip(want, refs))
        out["offline_vs_one_engine"] = {"identical_streams": same, "streams": len(refs)}
        log(f"  one engine's streamed transcripts vs offline fp32 at one symbol a frame, on "
            f"the audio the file streamer sends: {same}/{len(refs)} streams identical")

        routers = {}
        for label, devices, extra in (
                ("every card", None, {}),
                ("two engines on cuda:0", ROUTER_DEVICES,
                 dict(wire_responses=True, pipeline_depth=1))):
            n_eng = torch.cuda.device_count() if devices is None else len(devices)
            per_chip = -(-N_UTTS // n_eng)
            mc = MultiChipEngine(model, n_classes - 1, tokenizer, devices=devices,
                                 max_streams_per_chip=per_chip, **kw, **extra)
            mc.warmup()
            reset_counts()
            gids, got = _stream_texts(mc, pcm)
            counts = read_counts()
            k1_want = _k1_expected(mc.engines)
            mc.close()
            engines_used = sorted({g // per_chip for g in gids})
            res = {"devices": [str(d) for d in mc.devices], "gids": gids,
                   "engines_used": engines_used, "k1_launches": counts["lstm_recurrence"],
                   "k1_expected": k1_want, "same_as_one_engine": got == want}
            routers[label] = res
            log(f"  MultiChipEngine over {label} ({res['devices']}): gids {gids}; "
                f"transcripts equal one engine's: {got == want}; K1 launches "
                f"{counts['lstm_recurrence']} (expected {k1_want})")
            if got != want:
                raise AssertionError(f"{label}: the router's transcripts differ from one "
                                     "engine's")
            if counts["lstm_recurrence"] != k1_want or k1_want == 0 or any(
                    v for name, v in counts.items() if name != "lstm_recurrence"):
                raise AssertionError(f"{label}: the router's launches {counts}, K1 expected "
                                     f"{k1_want}")
            if engines_used != list(range(len(mc.engines))):
                raise AssertionError(f"{label}: streams were not spread over the engines")
        out["routers"] = routers

        past = torch.cuda.device_count() + 1
        try:
            server.build_engine(Namespace(num_chips=past, device="cuda", ckpt=None,
                                          serving_bundle=None, model_config=None))
        except SystemExit as e:
            out["num_chips_past_the_cards"] = str(e)
            log(f"  build_engine --num_chips {past}: SystemExit({e})")
        else:
            raise AssertionError(f"build_engine --num_chips {past} did not exit")

        # the transcriber's loop and measures against ASRServer.handle in
        # process, over two engines on one card
        mc = MultiChipEngine(model, n_classes - 1, tokenizer, devices=ROUTER_DEVICES,
                             max_streams_per_chip=N_UTTS // 2, pipeline_depth=1, **kw)
        mc.warmup()
        path_q = ("/asr/v0.1/stream?" + transcriber.QUERY)

        async def scenario():
            srv = server.ASRServer(mc, tick_interval=0.005)
            ticker = asyncio.create_task(srv._ticker())
            pairs = [_End.pair(path_q) for _ in paths]
            results = [transcriber.TranscriptionResult(fname=p, duration=len(x) / SR)
                       for p, x in zip(paths, pcm)]
            await asyncio.wait_for(asyncio.gather(
                *(srv.handle(s_end) for _, s_end in pairs),
                *(transcriber.stream_file(c_end, FileStreamer(p, realtime=False), r)
                  for (c_end, _), p, r in zip(pairs, paths, results))), 300)
            ticker.cancel()
            return results

        reset_counts()
        t0 = time.perf_counter()
        results = asyncio.run(scenario())
        wall = time.perf_counter() - t0
        counts = read_counts()
        mc.close()
        stats = measures.measure(results, want)
        vs_offline = measures.measure(results, refs)
        out["clients"] = {"wall_s": wall, "measures": stats, "vs_offline": vs_offline,
                          "k1_launches": counts["lstm_recurrence"]}
        log(f"  transcriber + measures against ASRServer.handle over two engines on cuda:0, "
            f"{len(paths)} WAV files, realtime=False: {wall:.2f} s; against one engine's "
            f"streamed transcripts {json.dumps(stats)}; WER against offline fp32 "
            f"{vs_offline['wer']} over {vs_offline['n_words']} words; K1 launches "
            f"{counts['lstm_recurrence']}")
        if stats["wer"] != 0.0 or stats["n_words"] == 0 or [r.transcript for r in results] != want:
            raise AssertionError(f"the clients' transcripts differ from one engine's: {stats}")
        if counts["lstm_recurrence"] == 0:
            raise AssertionError("the server's ticks launched no K1")
    return out


# ------------------------------------------------------------------ the beam
BEAM_W = 4               # the server's default width
BEAM_MSYM = 4            # bench.py's max_symbols_per_step: E = 4 expansion trips
BEAM_THRESH = dict(score_thresh=0.4, topk_thresh=1.5)  # the server's defaults
BEAM_SCORE_TOL = 1e-4    # streamed against offline beams: the encoders' fp32 sums differ
# graph replay against eager ticks: a cap and window small enough, and the
# blank lowered enough, that rebases fire within the ticks
BEAM_GRAPH_B, BEAM_GRAPH_TICKS, BEAM_GRAPH_CAP, BEAM_GRAPH_WIN = 32, 20, 16, 8
BEAM_GRAPH_BLANK_DROP = 4.0
# the synthetic n-gram: a bigram over BEAM_LM_WORDS of the pieces (its states
# are the root and those words), BEAM_LM_NEXT continuations a word
BEAM_LM_WORDS, BEAM_LM_NEXT, BEAM_ALPHA = 3000, 5, 0.5
BEAM_KEYWORDS, BEAM_KEYWORD_WEIGHT = 4, 3.0
# bench_serving --decoder beam: a short ladder, its windows cut to the phase's time
BEAM_LADDER = (4096, 2048, 1024)
BEAM_PROFILE_B = 2048  # the eager beam tick by operator
BEAM_TICKS, BEAM_PACED_TICKS = 40, 100


class _BeamRecorder(_Recorder):
    def beam_tick(self, packed, adv):
        import numpy as np

        self.packed.append((np.array(packed), np.array(adv)))
        return self.ser.beam_tick(packed, adv)


@contextlib.contextmanager
def beam_runs():
    """Within: each FastBeamDecoder.decode_encs call's loop statistics."""
    from caiman_asr_tpu_torch.decoding.fast_beam import FastBeamDecoder

    runs, real = [], FastBeamDecoder.decode_encs

    def decode_encs(self, *args, **kw):
        out = real(self, *args, **kw)
        runs.append(dict(self.last_run))
        return out

    with mock.patch.object(FastBeamDecoder, "decode_encs", decode_encs):
        yield runs


def _live_beams(toks, lens, scores) -> list:
    """[(tokens, score)] of one utterance's live hypotheses, by normalised
    score."""
    import numpy as np

    order = np.argsort(-(scores / np.maximum(lens + 1, 1)), kind="stable")
    return [(toks[w, :lens[w]].tolist(), float(scores[w])) for w in order if scores[w] > -1e29]


def _beams_agree(got: list, want: list) -> bool:
    """The same live hypotheses (token sequences), each one's score within
    BEAM_SCORE_TOL (relative and absolute); the order of two hypotheses
    whose normalised scores tie to the last bits may differ."""
    import numpy as np

    def key(beam):
        return sorted(beam, key=lambda h: h[0])

    return len(got) == len(want) and all(
        [a[0] for a in key(g)] == [b[0] for b in key(w)]
        and np.allclose([a[1] for a in key(g)], [b[1] for b in key(w)], rtol=BEAM_SCORE_TOL,
                        atol=BEAM_SCORE_TOL) for g, w in zip(got, want))


def _beam_diff(got: list, want: list) -> str:
    """The first utterance whose beams differ, for the log."""
    for i, (g, w) in enumerate(zip(got, want)):
        if not _beams_agree([g], [w]):
            short = lambda b: [(h[0][-8:], len(h[0]), round(h[1], 4)) for h in b]  # noqa: E731
            return f"utterance {i}: {short(g)} against {short(w)}"
    return "none"


def _stream_beams(engine, audio, lens, frames=None) -> list:
    """Every utterance on its own lane, a chunk a tick, to EOS; each lane's
    live beams as its last tick left them (read at its close). With
    ``frames`` (a dict; the engine's tick eager), each lane's encoder frames
    as the beam step took them go there."""
    import numpy as np

    final, real = {}, engine._beam_tail
    if frames is not None:
        step = engine._beam.step

        def recording_step(params, f_t, state):
            for lane in np.flatnonzero(engine._in_meta[:engine.B].cpu().numpy()).tolist():
                frames.setdefault(lane, []).append(f_t[lane].clone())
            return step(params, f_t, state)

        engine._beam.step = recording_step

    def tail(lane):
        out = real(lane)
        final[lane] = _live_beams(*(engine.dec_state[k][lane].cpu().numpy()
                                    for k in ("toks", "lens", "scores")))
        return out

    engine._beam_tail = tail
    lanes = [engine.open_stream() for _ in range(len(lens))]
    for t in range(int(lens.max()) // 960):
        for i, (lane, n) in enumerate(zip(lanes, lens)):
            if t * 960 < n:
                engine.push_audio(lane, np.rint(audio[i, t * 960:(t + 1) * 960] * 32768
                                                ).astype(np.int16))
            if (t + 1) * 960 >= n:
                engine.close_stream(lane)
        engine.tick()
    while engine.streams:
        engine.tick()
    return [final[lane] for lane in lanes]


def _synthetic_fusion(pieces, blank: int):
    """A bigram over random pieces (natural-log probabilities and back-offs
    from the seed) and BEAM_KEYWORDS keywords of two pieces each; their
    device tables over the vocabulary."""
    import numpy as np

    from caiman_asr_tpu_torch.keywords.device_table import build_keyword_tables
    from caiman_asr_tpu_torch.keywords.trie import Keywords
    from caiman_asr_tpu_torch.lm.device_table import build_device_tables
    from caiman_asr_tpu_torch.lm.ngram import LN10, NGramLM

    rng = np.random.default_rng(SEED + 12)
    words = [pieces[i] for i in rng.choice(blank, size=BEAM_LM_WORDS, replace=False)]
    probs = {("<unk>",): -5.0 * LN10, ("<s>",): -99.0}
    backoffs = {("<s>",): -0.3 * LN10}
    for w in words:
        probs[(w,)] = float(-rng.uniform(1.0, 4.0) * LN10)
        backoffs[(w,)] = float(-rng.uniform(0.05, 0.5) * LN10)
    for a in words + ["<s>"]:
        for b in rng.choice(words, size=BEAM_LM_NEXT, replace=False):
            probs[(a, str(b))] = float(-rng.uniform(0.05, 1.0) * LN10)
    t0 = time.perf_counter()
    lm = build_device_tables(NGramLM(probs, backoffs, 2), pieces, skip_ids=[blank])
    initial = [p for p in pieces[:blank] if p.startswith("▁")]
    vocab = [(str(rng.choice(initial)) + str(rng.choice(pieces[:blank])), BEAM_KEYWORD_WEIGHT)
             for _ in range(BEAM_KEYWORDS)]
    kw = build_keyword_tables(Keywords(vocab), pieces, skip_ids=[blank])
    return lm, kw, vocab, time.perf_counter() - t0


def run_beam() -> dict:
    """Phase 12: the beam serving path at base-85M's full width, W=4."""
    import numpy as np
    import torch

    from caiman_asr_tpu_torch import bench_serving, offline
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.decoding.fast_beam import (
        FastBeamDecoder,
        lane_axis,
        make_streaming_beam_step,
        select,
    )
    from caiman_asr_tpu_torch.ops import lstm_kernel
    from caiman_asr_tpu_torch.serving.engine import StreamingEngine

    t_phase = time.perf_counter()
    model, audio, lens, mel_stats, pipe, raised = _serving_model()
    n_classes = model.n_classes
    blank = n_classes - 1
    tok = bench_serving.bench_tokenizer(n_classes)
    k1 = lstm_kernel.lstm_recurrence
    layers = model.cfg.enc_pre_rnn_layers + model.cfg.enc_post_rnn_layers
    out = {"blank_raised": raised, "width": BEAM_W, "expansions": BEAM_MSYM}

    def fast(dtype, **kw):
        return offline.transcribe(model, audio, lens, mel_stats, device="cuda", dtype=dtype,
                                  pipeline=pipe, tokenizer=tok, decoder="fast_beam",
                                  beam_width=BEAM_W, max_symbols_per_step=BEAM_MSYM, **kw)

    def alternatives(responses):
        return [[a.y_seq for fr in r.values() for a in fr.final.alternatives] for r in responses]

    # offline FastBeamDecoder, fp32 and bf16, K1 counted
    best = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with beam_runs() as runs:
            resp = fast(dtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        run = runs[-1]
        best[dname] = tokens(resp)
        log(f"  fast beam {dname}: {wall * 1e3:.1f} ms (graph captured in this call), "
            f"{run['frames']} frames in {run['chunks']} chunks of {run['chunk_frames']}, "
            f"{run['host_reads']} host reads; K1 {counts['lstm_recurrence']} launches "
            f"(expected {layers}); {sum(map(len, best[dname]))} best-path tokens")
        if counts["lstm_recurrence"] != layers or any(
                v for name, v in counts.items() if name != "lstm_recurrence"):
            raise AssertionError(f"the offline beam's launches: {counts}")
        if len(runs) != 1 or not run["graph"] or run["host_reads"] != run["chunks"]:
            raise AssertionError(f"the beam did not replay one graph a chunk: {runs}")
        out[f"offline_{dname}"] = dict(run, ms=1e3 * wall, k1=counts["lstm_recurrence"],
                                       tokens=sum(map(len, best[dname])))
        if dname == "float32":
            resp32 = resp
    with plain_path():
        plain = fast(torch.float32)
    same = alternatives(resp32) == alternatives(plain)
    log(f"  fp32 fast beam vs the plain path: every hypothesis' tokens identical: {same}")
    if not same or not any(best["float32"]):
        raise AssertionError("the fp32 fast beam differs from its plain path, or is empty")
    sim = difflib.SequenceMatcher(a=[t for u in best["float32"] for t in u + [-1]],
                                  b=[t for u in best["bfloat16"] for t in u + [-1]],
                                  autojunk=False).ratio()
    out["bf16_vs_fp32_best_similarity"] = sim
    log(f"  bf16 vs fp32 best paths: sequence similarity {sim:.4f}")

    # the replays against eager chunks, bit for bit
    fp = FeaturePipeline(pipe, mel_stats, device="cuda")
    feats, feat_lens = fp(torch.from_numpy(audio).cuda(), torch.from_numpy(lens).cuda())
    with torch.inference_mode():
        encs, enc_lens, _ = model.encode(feats, feat_lens)
    dec_kw = dict(beam_width=BEAM_W, max_symbols_per_step=BEAM_MSYM, **BEAM_THRESH)
    graph_dec = FastBeamDecoder(model, blank, **dec_kw)
    t0 = time.perf_counter()
    first = graph_dec.decode_encs(encs, enc_lens)
    t1 = time.perf_counter()
    cached = graph_dec.decode_encs(encs, enc_lens)
    t2 = time.perf_counter()
    eager_dec = FastBeamDecoder(model, blank, cuda_graph=False, **dec_kw)
    eager = eager_dec.decode_encs(encs, enc_lens)
    t3 = time.perf_counter()
    same = all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(first, cached, eager))
    out["offline_replays"] = {"first_ms": 1e3 * (t1 - t0), "cached_ms": 1e3 * (t2 - t1),
                              "eager_ms": 1e3 * (t3 - t2), "equal": same,
                              "run": graph_dec.last_run}
    log(f"  fast beam decode fp32: first call (capture + replays) {1e3 * (t1 - t0):.1f} ms, "
        f"cached graph {1e3 * (t2 - t1):.1f} ms, eager chunks {1e3 * (t3 - t2):.1f} ms; "
        f"replays vs eager: tokens, frames, lengths and scores bit-equal: {same}")
    if not same or eager_dec.last_run["graph"] or not graph_dec.last_run["graph"]:
        raise AssertionError("the beam's graph replays differ from its eager chunks")
    offline_beams = [_live_beams(*(a[b] for a in (first[0], first[2], first[3])))
                     for b in range(N_UTTS)]

    # the host beam at the same width: agreement with the fixed-expansion beam
    t0 = time.perf_counter()
    host = offline.transcribe(model, audio, lens, mel_stats, device="cuda", pipeline=pipe,
                              tokenizer=tok, decoder="beam", beam_width=BEAM_W,
                              max_symbols_per_step=BEAM_MSYM)
    wall = time.perf_counter() - t0
    host_best = tokens(host)
    agree = sum(a == b for a, b in zip(host_best, best["float32"]))
    out["host_beam"] = {"ms": 1e3 * wall, "agree_share": agree / N_UTTS,
                        "tokens": sum(map(len, host_best))}
    log(f"  RNNTBeamDecoder fp32: {wall * 1e3:.1f} ms; best paths equal to the fast beam's on "
        f"{agree}/{N_UTTS} utterances (two algorithms: not a gate)")

    def engine(B, dtype, **kw):
        return StreamingEngine(model, blank, tok, mel_stats, max_streams=B,
                               max_symbols_per_step=BEAM_MSYM, dtype=dtype, device="cuda",
                               decoder="beam", beam_width=BEAM_W, logmel=pipe.logmel, **kw)

    thresh = dict(beam_score_thresh=BEAM_THRESH["score_thresh"],
                  beam_topk_thresh=BEAM_THRESH["topk_thresh"])
    # streamed beams, fp32, K1 on every tick. They are held (1) bit for bit
    # against the streaming step run alone over the engine's own encoder
    # frames (recorded from an eager run, which must equal the graph run:
    # the streaming featurizer, a matmul DFT over 60 ms chunks, and the
    # offline FFT differ in their last bits, and beam scores sum over every
    # frame), and (2) against the offline FastBeamDecoder over those frames:
    # each best hypothesis equal, the live sets counted. The offline decoder
    # forms log-probs by log_softmax and the step by z - lse, as the JAX
    # package's two do, so a merge or a top-W boundary that ties to the
    # last bits can part them on a hypothesis past the best
    eng = engine(N_UTTS, torch.float32, pipeline_depth=1, **thresh)
    eng.warmup()
    reset_counts()
    streamed = _stream_beams(eng, audio, lens)
    counts = read_counts()
    ticks, per_tick = eng._tick_count, eng.k1_launches_per_tick
    eng.close()
    frames = {}
    eng = engine(N_UTTS, torch.float32, pipeline_depth=1, cuda_graph=False, **thresh)
    eager_streamed = _stream_beams(eng, audio, lens, frames)
    eng.close()
    s_lens = torch.tensor([len(frames.get(i, [])) for i in range(N_UTTS)])
    s_encs = torch.zeros((N_UTTS, int(s_lens.max()), encs.shape[2]), device="cuda")
    for i, fs in frames.items():
        s_encs[i, :len(fs)] = torch.stack(fs)

    def step_alone(**fusion):
        init, step = make_streaming_beam_step(model, blank, beam_width=BEAM_W,
                                              expansions=BEAM_MSYM, **BEAM_THRESH, **fusion)
        params = model.param_tree()
        st = init(params, N_UTTS)
        valid_to = s_lens.to(s_encs.device)
        with torch.inference_mode():
            for t in range(s_encs.shape[1]):
                new = step(params, s_encs[:, t], st)
                st = {k: select(t < valid_to, new[k], st[k], lane_axis(k)) for k in st}
        return [_live_beams(*(st[k][b].cpu().numpy() for k in ("toks", "lens", "scores")))
                for b in range(N_UTTS)]

    def offline_on_frames(**fusion):
        o = FastBeamDecoder(model, blank, **dec_kw, **fusion).decode_encs(s_encs, s_lens)
        return [_live_beams(*(a[b] for a in (o[0], o[2], o[3]))) for b in range(N_UTTS)]

    def compare(got, what, **fusion):
        alone, off = step_alone(**fusion), offline_on_frames(**fusion)
        best = sum(_beams_agree([g[:1]], [w[:1]]) for g, w in zip(got, off))
        live = sum(_beams_agree([g], [w]) for g, w in zip(got, off))
        log(f"  {what}: live hypotheses equal to the streaming step's alone over the engine's "
            f"frames, bit for bit: {got == alone}; against the offline beam on those frames, "
            f"best hypotheses equal (tokens exact, scores to {BEAM_SCORE_TOL}) on "
            f"{best}/{N_UTTS} utterances, every live hypothesis on {live}/{N_UTTS}")
        if got != alone or best != N_UTTS:
            raise AssertionError(f"{what} differ: alone {_beam_diff(got, alone)}; offline "
                                 f"{_beam_diff([g[:1] for g in got], [w[:1] for w in off])}")
        return off, {"equal_alone": True, "best_equal_offline": best,
                     "live_equal_offline": live}

    stream_ref, cmp = compare(streamed, "fp32 streamed beams")
    from_audio = sum(g[0][0] == w[0][0] for g, w in zip(streamed, offline_beams))
    log(f"  graph ticks equal to eager ticks: {streamed == eager_streamed}; best paths equal "
        f"to the offline beam's from the audio on {from_audio}/{N_UTTS}; {ticks} ticks, K1 "
        f"{counts['lstm_recurrence']} launches ({per_tick} a tick)")
    if streamed != eager_streamed:
        raise AssertionError("the fp32 beam's graph ticks differ from its eager ticks")
    if counts["lstm_recurrence"] != ticks * per_tick or per_tick != layers:
        raise AssertionError(f"the beam tick's launches: {counts} for {ticks} ticks")
    out["streaming_vs_offline"] = dict(cmp, utterances=N_UTTS, ticks=ticks,
                                       launches=counts["lstm_recurrence"],
                                       best_equal_from_audio=from_audio)

    # the graph replay against the eager tick, bit for bit, with rebases
    packed = {}
    with torch.no_grad():
        model.joint_net[2].bias[-1] -= BEAM_GRAPH_BLANK_DROP
    try:
        for graph in (True, False):
            eng = engine(BEAM_GRAPH_B, torch.bfloat16, cuda_graph=graph,
                         beam_cap=BEAM_GRAPH_CAP, beam_win=BEAM_GRAPH_WIN, **thresh)
            packed[graph] = _graph_script(eng, BEAM_GRAPH_TICKS, SEED, _BeamRecorder)
            packed[graph, "state"] = ([t.clone() for hc in eng.enc_state for t in hc]
                                      + list(eng.dec_state.values()))
            eng.close()
    finally:
        with torch.no_grad():
            model.joint_net[2].bias[-1] += BEAM_GRAPH_BLANK_DROP
    echo_col = BEAM_W * BEAM_GRAPH_WIN + BEAM_W + 1
    rebases = int(sum(((p[:, echo_col] > 0) & a).sum() for p, a in packed[True]))
    equal = len(packed[True]) == len(packed[False]) >= BEAM_GRAPH_TICKS - 2 and all(
        np.array_equal(a, b) and np.array_equal(aa, ba)
        for (a, aa), (b, ba) in zip(packed[True], packed[False])) and all(
        torch.equal(a, b) for a, b in zip(packed[True, "state"], packed[False, "state"]))
    log(f"  beam graph replay vs eager tick, B={BEAM_GRAPH_B} bf16, cap {BEAM_GRAPH_CAP}, "
        f"{len(packed[True])} ticks with lanes opening and closing, {rebases} lane rebases: "
        f"packed outputs and state bit-equal: {equal}")
    if not equal or rebases == 0:
        raise AssertionError(f"the beam's graph ticks differ from its eager ticks, or no "
                             f"rebase fired ({rebases})")
    out["graph_vs_eager"] = {"ticks": len(packed[True]), "rebases": rebases}

    # fusion at full width: offline and streamed, fp32
    lm, kw, vocab, build_s = _synthetic_fusion([tok.id_to_piece(i) for i in range(n_classes)],
                                               blank)
    log(f"  fusion tables built in {build_s:.1f} s: n-gram S={lm.n_states} states x "
        f"{n_classes} ({lm.nbytes()} bytes), keywords {vocab} S={kw.n_states} "
        f"({kw.nbytes()} bytes)")
    fused = dict(ngram_lm=lm, ngram_alpha=BEAM_ALPHA, keywords=kw)
    eng = engine(N_UTTS, torch.float32, pipeline_depth=1, **thresh, **fused)
    eng.warmup()
    fused_streamed = _stream_beams(eng, audio, lens)
    eng.close()
    fused_offline, fcmp = compare(fused_streamed, f"fused (alpha {BEAM_ALPHA}, {len(vocab)} "
                                  "keywords) fp32 streamed beams", **fused)
    changed = sum(f[0][0] != o[0][0] for f, o in zip(fused_offline, stream_ref))
    log(f"  fusion changed {changed}/{N_UTTS} best transcripts")
    if changed == 0:
        raise AssertionError("fusion changed no transcript")
    out["fusion"] = dict(fcmp, lm_states=lm.n_states, lm_bytes=lm.nbytes(),
                         kw_states=kw.n_states, build_s=build_s, changed=changed)

    # the server, in process, --decoder beam
    eng = engine(SERVE_STREAMS + 1, torch.float32, pipeline_depth=1, **thresh)
    eng.warmup()
    out["server"] = _drive_server(eng, audio)
    eng.close()
    log(f"  server (beam): {out['server']}")
    log(f"  phase 12 checks took {time.perf_counter() - t_phase:.1f} s")

    # timing: the beam tick alone, then bench_serving --decoder beam's tiers
    del model
    torch.cuda.empty_cache()
    bench_model = bench_serving.build_model("cuda", SEED)
    beam_kw = bench_serving.beam_options(BEAM_W, 64, **BEAM_THRESH)
    out["compute"] = []
    for Bc in BEAM_LADDER:
        c = bench_serving.compute_ms(bench_model, Bc, engine_kw=beam_kw)
        out["compute"].append(c)
        log(f"  beam compute path B={Bc} bf16: {c['ms_per_tick']:.3f} ms a graph replay")
        torch.cuda.empty_cache()
    out["eager_ops"] = bench_serving.eager_ops(bench_model, BEAM_PROFILE_B, engine_kw=beam_kw)
    log(f"  eager beam tick at B={BEAM_PROFILE_B}, device ms by operator: "
        f"{out['eager_ops']['device_ms_per_tick']:.2f} in all; " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["eager_ops"]["ops_ms_per_tick"].items()))
    torch.cuda.empty_cache()
    with mock.patch.object(bench_serving, "TICKS", BEAM_TICKS), \
            mock.patch.object(bench_serving, "PACED_TICKS", BEAM_PACED_TICKS):
        out["ladder"] = bench_serving.run_ladder(bench_model, BEAM_LADDER, log=log,
                                                 engine_kw=beam_kw)["rungs"]
    out["headline"] = bench_serving.headline(out["ladder"])
    log(f"  beam ladder headline: {out['headline']}")
    del bench_model
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------- phase 13
# The train step as the JAX trainer runs it by default
# (`caiman_asr_tpu/train.py:246-304, :480-539`): the spec_augment block and
# the user tokens of `configs/base-8703sp.yaml` (with a star token beside
# its EOS), random state passing from a controller whose histories span 2
# or 3 microbatches (delay 0), the packed joint at pack_cap's cap, a
# delay-penalty StepSchedule toggling at step 2, the star penalty's schedule
# at its default, gradient noise, layer statistics, the mel-normalisation
# ramp; A microbatches of the smoke's utterances (other seeds), bf16.
DEFAULT_A = 2
DEFAULT_STEPS = 4
BASE_SPEC_AUGMENT = dict(freq_masks=2, min_freq=0, max_freq=20, time_masks=10, min_time=0,
                         max_time=0.03)
USER_TOKENS = {"eos": "<EOS>", "star": "<star>"}
STAR_SHARE = 0.1          # transcript positions that are the star token
RSP_FREQ = [0, 1, 1]      # histories of 2 or 3 microbatches
DELAY_SCHEDULE = dict(initial_value=0.0, final_value=0.01, toggle_step=2)
STAR_SCHEDULE = dict(initial_value=0.75, final_value=1.0, wer_threshold=0.2)
GRAD_NOISE = dict(noise_level=0.05, decay_const=0.55, start_step=1)
MEL_RAMP = (0, 8)         # the blend ratio from 0 to 1 over steps 0..8
# the masked share of the SpecAugment'd features against the expectation of
# non-overlapping bands (overlaps and the random widths make it smaller or
# larger, by much less than half)
MASK_SHARE_RANGE = (0.5, 1.5)
# the batch-norm running stats, kernels against the plain path, fp32
BN_STATS_RTOL, BN_STATS_ATOL = 1e-5, 1e-7
LSTM_LAYERS = MODELS["base-85M"][0]["enc_pre_rnn_layers"] + MODELS["base-85M"][0][
    "enc_post_rnn_layers"] + MODELS["base-85M"][0]["pred_rnn_layers"]


def smoke_tokenizer(n_pieces: int):
    """The port's Tokenizer over a synthetic table of ``n_pieces``: <unk>, the
    user tokens as user-defined pieces, then word pieces (written under
    build/smoke/, read back as a sentencepiece table)."""
    from caiman_asr_tpu_torch.data.tokenizer import (TYPE_NORMAL, TYPE_UNKNOWN,
                                                     TYPE_USER_DEFINED, Tokenizer)

    pieces = [["<unk>", 0.0, TYPE_UNKNOWN]]
    pieces += [["▁" + t, 0.0, TYPE_USER_DEFINED] for t in USER_TOKENS.values()]
    pieces += [[f"▁w{i}", -1.0, TYPE_NORMAL] for i in range(n_pieces - len(pieces))]
    path = REPO / "build" / "smoke" / "tokenizer.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"pieces": pieces}))
    return Tokenizer(list(" abcdefghijklmnopqrstuvwxyz'"), path)


def mel_stats(pipe):
    """Per-bin mean and std of the raw log-mels of every microbatch's
    utterances: the dataset statistics the normalisation ramp blends in."""
    import torch

    from caiman_asr_tpu_torch.ops.logmel import LogMelFrontend

    front = LogMelFrontend(pipe.logmel, device="cuda")
    rows = []
    for a in range(DEFAULT_A):
        audio, lens = synthetic_audio(SEED + 10 * (a + 1))
        feats, frame_lens = front(torch.from_numpy(audio).cuda(), torch.from_numpy(lens).cuda(),
                                  torch.Generator(device="cuda").manual_seed(SEED))
        valid = torch.arange(feats.shape[2], device="cuda")[None, :] < frame_lens[:, None]
        rows.append(feats.permute(0, 2, 1)[valid])
    x = torch.cat(rows)
    return x.mean(0).cpu().numpy(), x.std(0).cpu().numpy()


def default_transcripts(n_classes: int, eos: int, star: int, seed: int):
    """U_MIN..U_MAX random tokens per utterance, the last one EOS, about
    STAR_SHARE of the others the star token."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u_lens = rng.integers(U_MIN, U_MAX + 1, N_UTTS)
    u_lens[0] = U_MAX
    txt = rng.integers(0, n_classes - 1, (N_UTTS, U_MAX))
    txt[rng.random((N_UTTS, U_MAX)) < STAR_SHARE] = star
    txt[np.arange(N_UTTS), u_lens - 1] = eos
    return txt, u_lens


def default_batch(fp, n_classes: int, eos: int, star: int, gen, ratio: float) -> dict:
    """DEFAULT_A microbatches of the smoke's utterances (seeds SEED + 10,
    + 20, ...) through the pipeline ``fp`` (the train one: SpecAugment drawn
    from ``gen``), with their audio lengths."""
    import numpy as np
    import torch

    parts = {"feats": [], "feat_lens": [], "txt": [], "txt_lens": [], "audio_lens": []}
    for a in range(DEFAULT_A):
        audio, lens = synthetic_audio(SEED + 10 * (a + 1))
        feats, feat_lens = fp(torch.from_numpy(audio).cuda(), torch.from_numpy(lens).cuda(), gen,
                              dataset_to_utt_ratio=ratio)
        txt, u_lens = default_transcripts(n_classes, eos, star, SEED + 10 * (a + 1) + 2)
        for k, v in (("feats", feats), ("feat_lens", feat_lens),
                     ("txt", torch.from_numpy(txt).cuda()),
                     ("txt_lens", torch.from_numpy(u_lens).cuda()), ("audio_lens", lens)):
            parts[k].append(v)
    T = max(f.shape[0] for f in parts["feats"])
    feats = [torch.nn.functional.pad(f, (0, 0, 0, 0, 0, T - f.shape[0])) for f in parts["feats"]]
    batch = {"feats": torch.stack(feats), **{k: torch.stack(parts[k]) for k in
                                             ("feat_lens", "txt", "txt_lens")}}
    return batch, np.stack(parts["audio_lens"])


def spec_augment_check(eval_fp, train_fp, ratio: float) -> dict:
    """The train pipeline against the eval one on the same audio and the
    same generator seed (the dither's draws come first): the entries it
    masks are exactly 0 and form whole frequency rows and time columns;
    every other entry equals the eval features bit for bit. The masked
    share beside the expectation of non-overlapping bands."""
    import numpy as np
    import torch

    cfg = train_fp.pipe.specaugment
    audio, lens = synthetic_audio(SEED + 10)
    a, l = torch.from_numpy(audio).cuda(), torch.from_numpy(lens).cuda()
    seed = SEED + 13
    got, got_lens = train_fp(a, l, torch.Generator(device="cuda").manual_seed(seed), ratio)
    ref, ref_lens = eval_fp(a, l, torch.Generator(device="cuda").manual_seed(seed), ratio)
    if not torch.equal(got_lens, ref_lens):
        raise AssertionError("SpecAugment changed the lengths")
    zero = got == 0
    rows, cols = zero.all(dim=0), zero.all(dim=2)  # [B, F] frequency bins, [T, B] frames
    bands = rows[None] | cols[:, :, None]
    if not torch.equal(got, torch.where(bands, torch.zeros_like(ref), ref)):
        raise AssertionError("SpecAugment changed entries outside whole bands, or left a "
                             "masked entry nonzero")
    m = got != ref
    T, B, M = got.shape
    fl = got_lens.float().cpu().numpy()
    f_share = cfg.freq_masks * (cfg.min_freq + cfg.max_freq) / 2 / M
    w_max = np.round(fl * cfg.max_time) if 0 < cfg.max_time < 1 else np.full(B, cfg.max_time)
    n_t = np.round(fl * cfg.time_masks) if 0 < cfg.time_masks < 1 else np.full(B, cfg.time_masks)
    t_share = n_t * (cfg.min_time + w_max) / 2 / T
    expected = float(np.mean(1 - (1 - f_share) * (1 - t_share)))
    share = float(m.sum() / (ref != 0).sum())
    lo, hi = MASK_SHARE_RANGE
    frames = [int(cols[:n, b].sum()) for b, n in enumerate(got_lens.tolist())]
    log(f"  SpecAugment ({cfg}): {share:.4f} of the nonzero features masked, expected "
        f"{expected:.4f} from non-overlapping bands; frequency bins masked per utterance "
        f"{rows.sum(1).tolist()}, frames within its length {frames}")
    if not lo * expected <= share <= hi * expected:
        raise AssertionError(f"masked share {share} outside {MASK_SHARE_RANGE} x {expected}")
    return {"masked_share": share, "expected_share": expected,
            "freq_bins_masked": rows.sum(1).tolist(), "frames_masked": frames}


def microbatch(batch, a: int, n: int = N_UTTS) -> dict:
    """The first ``n`` utterances of microbatch ``a``, cut to their T and U."""
    T = int(batch["feat_lens"][a, :n].max())
    U = int(batch["txt_lens"][a, :n].max())
    return {"feats": batch["feats"][a, :T, :n], "feat_lens": batch["feat_lens"][a, :n],
            "txt": batch["txt"][a, :n, :U], "txt_lens": batch["txt_lens"][a, :n]}


def nvalid(mb, factor: int) -> int:
    return int((-(-mb["feat_lens"] // factor) * (mb["txt_lens"] + 1)).sum())


def state_leaves(state) -> list:
    from caiman_asr_tpu_torch.training.step import map_state

    out = []
    map_state(out.append, state)
    return out


def joint_launches_per_call(N: int, Hj: int, K: int) -> dict:
    """The joint kernels one forward and backward of fused_joint_lse at
    [N, Hj] x [Hj, K] in bf16 launches (the expected count a microbatch)."""
    import torch

    from caiman_asr_tpu_torch.ops import joint_kernel as jk

    h, wt, b, labels, _, _ = joint_inputs(N, Hj, K, torch.bfloat16, SEED + 17)
    h, w, b = (t.requires_grad_() for t in (h, wt.t(), b))  # w: [Hj, K]
    reset_counts()
    lp_b, lp_l = jk.fused_joint_lse(h, w, b, labels, K - 1)
    torch.autograd.grad((lp_b.sum() + lp_l.sum()), (h, w, b))
    torch.cuda.synchronize()
    return {k: v for k, v in read_counts().items() if v}


def run_default_train() -> dict:
    """Phase 13: the default training path at base-85M full width."""
    import dataclasses

    import numpy as np
    import torch

    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.log.layer_stats import layer_stat_names
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from caiman_asr_tpu_torch.ops.features import SpecAugmentConfig
    from caiman_asr_tpu_torch.ops.joint_kernel import store_plan
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
    from caiman_asr_tpu_torch.ops.lstm import BN_MOMENTUM
    from caiman_asr_tpu_torch.training import pack, schedules
    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
    from caiman_asr_tpu_torch.training.rsp import RSPController, zero_rnnt_state
    from caiman_asr_tpu_torch.training.step import init_train_state, make_train_step, map_state
    from caiman_asr_tpu_torch.training.tree import tree_items
    from caiman_asr_tpu_torch.utils.user_tokens import user_token_idx

    name = "base-85M"
    cfg, K = model_config(name), MODELS[name][1]
    Hj, factor = cfg.joint_n_hid, cfg.enc_stack_time_factor
    out = {}
    tok = smoke_tokenizer(K - 1)
    eos, star = (user_token_idx(t, USER_TOKENS, tok) for t in ("eos", "star"))
    if min(eos, star) < 0:
        raise AssertionError(f"the user tokens did not resolve: eos {eos}, star {star}")
    log(f"  user tokens {USER_TOKENS}: eos_idx {eos}, star_idx {star}")

    # 1. the train pipeline with SpecAugment
    pipe = PipelineConfig(logmel=LogMelConfig(), specaugment=SpecAugmentConfig(**BASE_SPEC_AUGMENT))
    stats = mel_stats(pipe)
    ramp = schedules.MelNormRamp(*MEL_RAMP)
    train_fp = FeaturePipeline(pipe, stats, train=True, device="cuda")
    eval_fp = FeaturePipeline(pipe, stats, device="cuda")
    out["spec_augment"] = spec_augment_check(eval_fp, train_fp, ramp.ratio(2))

    # 2. the default-path steps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    batch, audio_lens = default_batch(train_fp, K, eos, star, gen, ramp.ratio(0))
    T_pre = batch["feats"].shape[1]
    dense_n = N_UTTS * -(-T_pre // factor) * (U_MAX + 1)
    host = [pack.lattice_nvalid(audio_lens[a], batch["txt_lens"][a].cpu().numpy(), pipe, cfg)
            for a in range(DEFAULT_A)]
    device = [nvalid({k: v[a] for k, v in batch.items()}, factor) for a in range(DEFAULT_A)]
    enc_lens = pack.enc_frame_lens(audio_lens[0], pipe, cfg)
    if host != device or not np.array_equal(
            enc_lens, (-(-batch["feat_lens"][0] // factor)).cpu().numpy()):
        raise AssertionError(f"host lattice sizes {host} differ from the device's {device}")
    cap = pack.pack_cap(max(host), dense_n)
    if cap is None:
        raise AssertionError(f"pack_cap gave no cap for {host} of {dense_n}")
    dense_plan, packed_plan = store_plan(dense_n, Hj, K), store_plan(cap, Hj, K)
    log(f"  batch: A={DEFAULT_A} x B={N_UTTS}, T={T_pre} (pre-stack), U={U_MAX}; valid lattice "
        f"positions {host} (host = device); dense N={dense_n}, pack_cap {cap} "
        f"({cap / dense_n:.1%}, {cap % 128} rows past a multiple of 128); plans: dense "
        f"{dense_plan}; packed {packed_plan}")
    out.update({"valid": host, "dense_n": dense_n, "pack_to": cap, "dense_plan": dense_plan,
                "packed_plan": packed_plan})
    per_call = joint_launches_per_call(cap, Hj, K)
    expected = {"lstm_recurrence_sg": DEFAULT_A * LSTM_LAYERS,
                "lstm_recurrence_bwd": DEFAULT_A * LSTM_LAYERS,
                **{k: DEFAULT_A * v for k, v in per_call.items()}, **FINISH_STEP}

    model = build_model(name, "cuda")
    opt = Lamb(OptimizerConfig(warmup_steps=0), model.param_lr_factors())
    state = init_train_state(model, opt, device="cuda")
    step = make_train_step(model, opt, K - 1, eos_idx=eos, star_idx=star,
                           compute_dtype=torch.bfloat16, grad_noise=True, rsp=True,
                           collect_layer_stats=True, device="cuda")
    ctl = RSPController(RSP_FREQ, delay=0, seed=SEED)
    rs = zero_rnnt_state(model, N_UTTS, device="cuda")
    dp = schedules.build_schedule(**DELAY_SCHEDULE)
    sp = schedules.build_schedule(**STAR_SCHEDULE)
    noise = schedules.GradNoiseSchedule(**GRAD_NOISE)
    names = layer_stat_names(state.params)
    rows = []
    for i in range(DEFAULT_STEPS):
        if i:
            batch, _ = default_batch(train_fp, K, eos, star, gen, ramp.ratio(i))
        gates = ctl.gates(i, DEFAULT_A)
        scalars = {"delay_penalty": dp.step(i, hints={"wer": None}),
                   "star_penalty": sp.step(i, hints={"wer": None}),
                   "grad_noise_std": noise.std(i)}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, m, rs = step(state, batch, gen, scalars, rs, gates, pack_to=cap)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = {k: v for k, v in read_counts().items() if v}
        ls = m["layer_stats"]
        row = {"ms": ms, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "skipped": int(m["skipped"]), "gates": gates.tolist(), "scalars": scalars,
               "launches": counts, "carried_abs_mean": float(rs.enc_state.post_rnn[0].abs().mean()),
               "layer_stats_finite": bool(torch.isfinite(ls).all())}
        rows.append(row)
        log(f"  default step {i + 1}: gates {row['gates']}, {ms:.1f} ms, loss {row['loss']:.4f}, "
            f"grad_norm {row['grad_norm']:.4f}, skipped {row['skipped']}, scalars {scalars}, "
            f"mel ratio {ramp.ratio(i)}, carried |h| {row['carried_abs_mean']:.4f}, "
            f"launches {counts}")
        if row["skipped"] or not math.isfinite(row["loss"]):
            raise AssertionError(f"default step {i + 1} skipped or not finite: {row}")
        if ls.shape[0] != len(names) or not row["layer_stats_finite"]:
            raise AssertionError(f"layer statistics {ls.shape} for {len(names)} names")
        if counts != expected:
            raise AssertionError(f"default step {i + 1}: launches {counts}, expected {expected}")
    if not any(g for r in rows for g in r["gates"]):
        raise AssertionError("no microbatch continued from a carried state")
    if rows[0]["scalars"]["delay_penalty"] == rows[-1]["scalars"]["delay_penalty"]:
        raise AssertionError("the delay penalty's StepSchedule did not toggle")
    if not all(r["scalars"]["grad_noise_std"] > 0 for r in rows[GRAD_NOISE["start_step"]:]):
        raise AssertionError("no gradient noise from the schedule's start step on")
    out["steps"] = rows
    out["expected_launches"] = expected
    stat = dict(zip(names, ls.tolist()))
    log("  layer statistics of the last step, a few of "
        f"{len(names)}: " + "; ".join(f"{n} {stat[n]:.4g}" for n in names[:5]))

    # the same step packed and unpacked, timed in turns; a breakdown of each
    run = {"model": model, "state": state, "compute": torch.bfloat16, "gen": gen, "opt": opt}
    scalars = rows[-1]["scalars"]
    timed = {cap: [], None: []}
    for p in (cap, None, None, cap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run["state"], _, rs = step(run["state"], batch, gen, scalars, rs,
                                   np.ones(DEFAULT_A, np.float32), pack_to=p)
        torch.cuda.synchronize()
        timed[p].append(1e3 * (time.perf_counter() - t0))
    out["step_ms"] = {"packed": timed[cap], "dense": timed[None]}
    log(f"  the default step, A={DEFAULT_A} x B={N_UTTS} bf16: packed to {cap} rows "
        f"{timed[cap]} ms, dense ({dense_n} rows) {timed[None]} ms; {card()}")
    out["breakdown_ms"] = {"packed": step_breakdown(run, batch, cap),
                           "dense": step_breakdown(run, batch)}
    out["joint_profile"] = {"packed": profile_joint(run, batch, cap),
                            "dense": profile_joint(run, batch)}

    # 5. overflow: a cap one row below the larger microbatch's valid count
    before = [t.clone() for tree in (run["state"].params, run["state"].ema_params,
                                     run["state"].opt_state.mu, run["state"].opt_state.nu)
              for _, t in tree_items(tree)]
    counts0 = run["state"].opt_state.count, run["state"].step
    reset_counts()
    st, m, rs_bad = step(run["state"], batch, gen, scalars, rs, np.ones(DEFAULT_A, np.float32),
                         pack_to=max(host) - 1)
    check_finish_launches(read_counts(), "the overflow step", taken=False)
    after = [t for tree in (st.params, st.ema_params, st.opt_state.mu, st.opt_state.nu)
             for _, t in tree_items(tree)]
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    zero = all(not t.any() for t in state_leaves(rs_bad))
    log(f"  overflow, pack_to {max(host) - 1} < {max(host)} valid: loss {float(m['loss'])}, "
        f"skipped {int(m['skipped'])}; parameters, EMA and moments bit-identical: {same}; "
        f"counts kept {(st.opt_state.count, st.step) == counts0}; the returned state zero: {zero}")
    if math.isfinite(float(m["loss"])) or int(m["skipped"]) != 1 or not same or not zero or (
            st.opt_state.count, st.step) != counts0:
        raise AssertionError("the overflow did not skip the step with the state unchanged")
    out["overflow"] = {"loss": str(float(m["loss"])), "skipped": int(m["skipped"]),
                       "state_bit_identical": same}
    carried = rs
    del run, state, st, before, after, model, opt, step
    torch.cuda.empty_cache()

    # 3. packed against dense, 4. RSP against the plain path: fp32, dropout off
    ref = no_dropout(name)
    mb_eval, _ = default_batch(eval_fp, K, eos, star, None, ramp.ratio(0))
    mb = microbatch(mb_eval, 0)
    cap0 = pack.pack_cap(nvalid(mb, factor), N_UTTS * -(-mb["feats"].shape[0] // factor)
                         * (mb["txt"].shape[1] + 1)) or nvalid(mb, factor)
    reset_counts()
    loss_p, g_p, _ = step_grads(ref, mb, pack_to=cap0)
    packed_counts = {k: v for k, v in read_counts().items() if v}
    loss_d, g_d, _ = step_grads(ref, mb)
    out["packed_vs_dense"] = compare_grads(
        (loss_p, g_p), (loss_d, g_d), f"packed ({cap0} rows) vs dense, fp32, B={N_UTTS}")
    out["packed_vs_dense"]["launches"] = packed_counts
    del g_p, g_d
    small = microbatch(mb_eval, 1, CHECK_B)
    sub_state = map_state(lambda t: t[:, :CHECK_B] if t.dim() == 3 else t[:CHECK_B], carried)
    gate = torch.ones((), device="cuda")
    n_small = nvalid(small, factor)
    reset_counts()
    loss_k, g_k, st_k = step_grads(ref, small, pack_to=n_small, rnnt_state=sub_state, gate=gate)
    rsp_counts = {k: v for k, v in read_counts().items() if v}
    with plain_path():
        loss_q, g_q, st_q = step_grads(ref, small, pack_to=n_small, rnnt_state=sub_state,
                                     gate=gate)
    if read_counts() != {k: rsp_counts.get(k, 0) for k in read_counts()}:
        raise AssertionError("the plain path launched a kernel")
    out["rsp_vs_plain"] = compare_grads((loss_k, g_k), (loss_q, g_q),
                                        f"RSP from a carried state, packed to {n_small} rows, "
                                        f"kernels vs plain path, fp32, B={CHECK_B}")
    state_err = max_err(state_leaves(st_k)[:-1], state_leaves(st_q)[:-1])
    same_tok = torch.equal(state_leaves(st_k)[-1], state_leaves(st_q)[-1])
    log(f"  RSP returned state: max |kernels - plain| {state_err:.3g} (tol {TOL['float32']}), "
        f"last tokens equal {same_tok}; launches {rsp_counts}")
    if not state_err <= TOL["float32"] or not same_tok:
        raise AssertionError(f"the RSP state differs from the plain path's: {state_err}")
    for k in LSTM_TRAIN_KERNELS:
        if not rsp_counts.get(k):
            raise AssertionError(f"{k} was not launched from the carried state: {rsp_counts}")
    out["rsp_vs_plain"].update({"state_max_abs_err": state_err, "launches": rsp_counts})
    del ref, g_k, g_q
    torch.cuda.empty_cache()

    # 6. batch-norm: two bf16 steps, then the folded stats against the plain path
    bn_cfg = dataclasses.replace(cfg, enc_batch_norm=True, pred_batch_norm=True)
    bn_model = RNNT(bn_cfg, K, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(SEED))
    bn_opt = Lamb(OptimizerConfig(warmup_steps=0), bn_model.param_lr_factors())
    bn_state = init_train_state(bn_model, bn_opt, device="cuda")
    bn_step = make_train_step(bn_model, bn_opt, K - 1, eos_idx=eos, star_idx=star,
                              compute_dtype=torch.bfloat16, device="cuda")
    stats0 = [t.clone() for pair in bn_model.bn_stats(bn_state.params) for t in pair]
    bn_rows = []
    for i in range(2):
        reset_counts()
        bn_state, m = bn_step(bn_state, batch, gen, scalars, pack_to=cap)
        bn_rows.append({"loss": float(m["loss"]), "skipped": int(m["skipped"]),
                        "launches": {k: v for k, v in read_counts().items() if v}})
    stats1 = [t for pair in bn_model.bn_stats(bn_state.params) for t in pair]
    moved = all(not torch.equal(a, b) for a, b in zip(stats0, stats1))
    log(f"  batch-norm base-85M, bf16, two steps packed to {cap}: {bn_rows}; every running "
        f"stat moved: {moved}")
    if any(r["skipped"] or not math.isfinite(r["loss"]) for r in bn_rows) or not moved:
        raise AssertionError(f"batch-norm steps: {bn_rows}, moved {moved}")
    for i, r in enumerate(bn_rows):  # the running stats overwritten through pass 2
        check_finish_launches(r["launches"], f"batch-norm step {i + 1}")
    bn_ref = RNNT(dataclasses.replace(bn_cfg, enc_dropout=0.0, pred_dropout=0.0,
                                      joint_dropout=0.0), K, device="cuda")
    bn_ref.load_state_dict(bn_model.state_dict())
    folded = {}
    for path in ("kernels", "plain"):
        with (plain_path() if path == "plain" else contextlib.nullcontext()):
            reset_counts()
            fold = list(bn_ref.bn_stats(bn_ref.param_tree()))
            for a in range(DEFAULT_A):
                sub = microbatch(mb_eval, a, CHECK_B)
                updates = []
                bn_ref.enc_pred(sub["feats"], sub["feat_lens"], sub["txt"], sub["txt_lens"],
                                train=True, bn_updates=updates)
                fold = [((1 - BN_MOMENTUM) * m_ + BN_MOMENTUM * bm,
                         (1 - BN_MOMENTUM) * v_ + BN_MOMENTUM * bv)
                        for (m_, v_), (bm, bv) in zip(fold, updates)]
            folded[path] = ([t for pair in fold for t in pair],
                            {k: v for k, v in read_counts().items() if v})
    (got, counts), (want, _) = folded["kernels"], folded["plain"]
    errs = [((a - b).abs() - BN_STATS_RTOL * b.abs()).max().item() for a, b in zip(got, want)]
    worst_rel = max(((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
                    for a, b in zip(got, want))
    log(f"  batch-norm folded running stats, fp32, B={CHECK_B} x {DEFAULT_A} microbatches, "
        f"kernels vs plain path: worst |d| - rtol |plain| = {max(errs):.3g} (atol "
        f"{BN_STATS_ATOL}, rtol {BN_STATS_RTOL}); worst relative {worst_rel:.3g}; "
        f"launches {counts}")
    if not max(errs) <= BN_STATS_ATOL or not counts.get("lstm_recurrence_sg"):
        raise AssertionError(f"batch-norm stats differ from the plain path's: {errs}")
    out["batch_norm"] = {"steps": bn_rows, "stats_excess": max(errs),
                         "stats_worst_rel": worst_rel, "launches": counts}
    return out


# ---------------------------------------------------------------- phase 14
# Validation as val.py runs it: base-85M from configs/base-8703sp.yaml, the
# smoke's utterances as WAV files with a manifest, the smoke tokenizer, mel
# statistics and a checkpoint, through val.validate on parsed argv.
VAL_CONFIG = "configs/base-8703sp.yaml"
VAL_BATCH = 8
VAL_MIN_NONEMPTY = 12     # of the N_UTTS hypotheses
VAL_WORDS = (3, 8)        # words a transcript, each one of the tokenizer's pieces
EMA_PERTURB = 1e-4        # the checkpoint's EMA: its params times (1 + this x a normal)
VAL_BEAM_MSYM = 8         # the fast beam's expansion trips (the beams' own default)
VAL_START_EMIT = 0.2      # calibrate_blank's start-state floor: most utterances emit


def write_val_workspace(root: Path) -> dict:
    """The smoke's utterances as 16-bit WAV files under ``root`` with a
    manifest of random transcripts, the smoke tokenizer, and the mel
    statistics of that audio as val.py reads them (``--mel_stats_path``)."""
    import wave

    import numpy as np
    import torch

    from caiman_asr_tpu_torch.data.audio import read_audio
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.ops.logmel import LogMelFrontend

    root.mkdir(parents=True, exist_ok=True)
    K = MODELS["base-85M"][1]
    smoke_tokenizer(K - 1)
    audio, lens = synthetic_audio(SEED)
    rng = np.random.default_rng(SEED + 14)
    entries, waves = [], []
    for i, n in enumerate(lens):
        with wave.open(str(root / f"u{i:02d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((np.clip(audio[i, :n], -1, 1) * 32767).astype(np.int16).tobytes())
        words = rng.integers(len(USER_TOKENS) + 1, K - 1, size=rng.integers(*VAL_WORDS))
        entries.append({"transcript": " ".join(f"w{j - len(USER_TOKENS) - 1}" for j in words),
                        "files": [{"fname": f"u{i:02d}.wav", "duration": int(n) / SR}],
                        "original_duration": int(n) / SR})
        waves.append(read_audio(root / f"u{i:02d}.wav", SR))
    (root / "manifest.json").write_text(json.dumps(entries))
    front = LogMelFrontend(load_config(REPO / VAL_CONFIG).input_val.logmel, device="cuda")
    rows = []
    for x in waves:
        feats, frame_lens = front(torch.from_numpy(x)[None].cuda(),
                                  torch.tensor([len(x)], device="cuda"))
        rows.append(feats[0, :, : int(frame_lens[0])].T)
    x = torch.cat(rows)
    np.savez(root / "mel_stats.npz", melmeans=x.mean(0).cpu().numpy(),
             melvars=x.var(0).cpu().numpy())
    return {"audio_s": float(lens.sum()) / SR, "utterances": len(lens)}


def calibrate_val_blank(model, batches) -> float:
    """``calibrate_blank`` at the start-state floor VAL_START_EMIT on the
    longest of ``batches`` ((features, lengths) as validation computes
    them), then the blank bias lowered, where needed, until the start
    state has a non-blank argmax on some frame of at least
    VAL_MIN_NONEMPTY + 2 utterances (each then decodes to some text).
    Returns the net raise."""
    import torch

    raised = calibrate_blank(model, *batches[-1], VAL_START_EMIT)
    maxima = []
    with torch.inference_mode():
        for feats, feat_lens in batches:
            f, f_lens, _ = model.encode(feats, feat_lens)
            g, _, _ = model.predict(torch.zeros((f.shape[0], 0), dtype=torch.int64,
                                                device=f.device))
            logits = model.joint(f, g)[:, :, 0]  # the start state, [B, T, K]
            margin = logits[..., :-1].amax(-1) - logits[..., -1]
            valid = torch.arange(f.shape[1], device=f.device)[None, :] < f_lens[:, None]
            maxima.append(margin.masked_fill(~valid, float("-inf")).amax(1))
        kth = float(torch.cat(maxima).sort(descending=True).values[VAL_MIN_NONEMPTY + 1])
        if kth <= 0:
            drop = 1.1 * -kth + 1e-3
            model.joint_net[2].bias[-1] -= drop
            raised -= drop
    return raised


def write_val_checkpoint(root: Path, argv: list) -> dict:
    """A checkpoint in the JAX package's format written by the port: params
    of the base model built as val.py builds it (weights from SEED), its
    blank calibrated on the features validation computes
    (``calibrate_val_blank``), and an EMA a perturbed copy. Returns the EMA
    leaves by name."""
    import numpy as np
    import torch

    from caiman_asr_tpu_torch import val
    from caiman_asr_tpu_torch.export.checkpointer import (flatten_named, save_checkpoint,
                                                          unflatten_named)
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.setup import builders

    args = val.val_arg_parser().parse_args(argv)
    cfg = builders.apply_input_overrides(load_config(args.model_config), args)
    tok = builders.build_tokenizer(cfg, args.tokenizer_model, sampling=0.0)
    model, _ = builders.build_model(cfg, tok, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    # the features validation computes: its loader's batches, its pipeline
    _, fp = builders.build_feature_pipelines(cfg, builders.load_mel_stats(args.mel_stats_path),
                                             device="cuda")
    loader = builders.build_data_source_loader(args, cfg, tok, args.val_batch_size, train=False)
    with torch.inference_mode():
        batches = [fp(torch.from_numpy(b.audio).cuda(), torch.from_numpy(b.audio_lens).cuda(),
                      dataset_to_utt_ratio=1.0) for b in loader.epoch(0)]
    raised = calibrate_val_blank(model, batches)
    params = flatten_named(model.param_tree())
    rng = np.random.default_rng(SEED + 15)
    ema = {k: (v * (1 + EMA_PERTURB * rng.standard_normal(v.shape))).astype(v.dtype)
           for k, v in params.items()}
    save_checkpoint(args.ckpt, unflatten_named(params), unflatten_named(ema),
                    meta={"step": 0, "blank_raise": raised})
    log(f"  checkpoint {args.ckpt}: {len(params)} leaves, blank raised by {raised:.4f}, EMA "
        f"the params times (1 + {EMA_PERTURB} x a normal)")
    del model
    torch.cuda.empty_cache()
    return ema


def val_emission(responses, feat_lens, stack: int) -> dict:
    """What a decode emitted: its symbols, the encoder frames it read
    (``ceil(len / stack)`` of each utterance), and the most symbols at one
    frame."""
    at = collections.Counter()
    for b, resp in enumerate(responses):
        for fr in resp.values():
            if fr.final is not None and fr.final.alternatives:
                at.update((b, t) for t in fr.final.alternatives[0].timesteps)
    frames = sum(-(-int(n) // stack) for n in feat_lens.tolist())
    return {"symbols": sum(at.values()), "frames": frames,
            "most_at_a_frame": max(at.values(), default=0)}


@contextlib.contextmanager
def val_probes(stack: int):
    """Within: what a val.validate call did, in ``probe``: the tree the
    checkpoint was applied to, the evaluation's wall ms, and per batch the
    ms of waiting for the loader, of the feature pipeline, of the decoder
    (with its K1 launches and its emission, ``val_emission``, the encoder
    stacking ``stack`` frames) and of the loss, each timed between two
    synchronises the evaluation itself does not make."""
    import torch

    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.data.loader import AudioDataLoader
    from caiman_asr_tpu_torch.decoding.fast_beam import FastBeamDecoder
    from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder
    from caiman_asr_tpu_torch.evaluate import core
    from caiman_asr_tpu_torch.export import checkpointer
    from caiman_asr_tpu_torch.ops import lstm_kernel
    from caiman_asr_tpu_torch.training import step

    probe = {"load": [], "featurize": [], "decode": [], "loss": []}
    launches = lambda: getattr(lstm_kernel.lstm_recurrence, "launches", 0)  # 0: plain path
    real_apply, real_eval, real_loss = (checkpointer.apply_params, core.evaluate,
                                        step.make_val_loss_step)

    def timed(kind, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            k1, t0 = launches(), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            probe[kind].append({"ms": 1e3 * (time.perf_counter() - t0), "k1": launches() - k1})
            return out
        return call

    def apply_params(template, loaded, **kw):
        probe["tree"] = real_apply(template, loaded, **kw)
        return probe["tree"]

    def evaluate(*a, **kw):
        t0 = time.perf_counter()
        out = real_eval(*a, **kw)
        probe["eval_ms"] = 1e3 * (time.perf_counter() - t0)
        return out

    def method(kind, real):
        return lambda self, *a, **kw: timed(kind, lambda: real(self, *a, **kw))()

    def decode(real):
        def call(self, feats, feat_lens):
            out = timed("decode", lambda: real(self, feats, feat_lens))()
            probe["decode"][-1].update(val_emission(out, feat_lens, stack))
            return out
        return call

    real_epoch = AudioDataLoader.epoch

    def epoch(self, *a, **kw):
        batches = real_epoch(self, *a, **kw)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            probe["load"].append({"ms": 1e3 * (time.perf_counter() - t0)})
            yield batch

    with contextlib.ExitStack() as patches:
        patches.enter_context(mock.patch.object(checkpointer, "apply_params", apply_params))
        patches.enter_context(mock.patch.object(core, "evaluate", evaluate))
        patches.enter_context(mock.patch.object(
            step, "make_val_loss_step", lambda *a, **kw: timed("loss", real_loss(*a, **kw))))
        for cls in (GreedyDecoder, FastBeamDecoder):
            patches.enter_context(mock.patch.object(cls, "decode", decode(cls.decode)))
        patches.enter_context(mock.patch.object(FeaturePipeline, "__call__",
                                                method("featurize", FeaturePipeline.__call__)))
        patches.enter_context(mock.patch.object(AudioDataLoader, "epoch", epoch))
        yield probe


def run_validation() -> dict:
    """Phase 14: python -m caiman_asr_tpu_torch.val at base-85M on the card,
    with the kernels and under plain_path(), greedy with --calc_loss, then
    the fast beam."""
    import numpy as np
    import torch

    from caiman_asr_tpu_torch import val
    from caiman_asr_tpu_torch.export.checkpointer import flatten_named
    from caiman_asr_tpu_torch.models.config import load_config

    root = REPO / "build" / "smoke" / "val"
    work = write_val_workspace(root)
    cfg = load_config(REPO / VAL_CONFIG)
    enc_layers = cfg.rnnt.enc_pre_rnn_layers + cfg.rnnt.enc_post_rnn_layers
    loss_layers = enc_layers + cfg.rnnt.pred_rnn_layers  # enc_pred runs the predictor's too
    base = ["--model_config", str(REPO / VAL_CONFIG),
            "--tokenizer_model", str(REPO / "build" / "smoke" / "tokenizer.json"),
            "--ckpt", str(root / "ckpt.npz"), "--dataset_dir", str(root),
            "--val_manifests", "manifest.json", "--mel_stats_path", str(root / "mel_stats.npz"),
            "--val_batch_size", str(VAL_BATCH), "--skip_ngram", "--dump_preds"]
    ema = write_val_checkpoint(root, base)
    batches = -(-work["utterances"] // VAL_BATCH)
    out = {"utterances": work["utterances"], "audio_s": work["audio_s"], "batches": batches,
           "card": card()}

    runs = {}
    for decoder, extra in (("greedy", ["--calc_loss", "--dump_ctm"]),
                           ("fast_beam", ["--decoder", "fast_beam", "--max_symbols_per_step",
                                          str(VAL_BEAM_MSYM)])):
        for path in ("kernels", "plain"):
            args = val.val_arg_parser().parse_args(
                base + extra + ["--output_dir", str(root / f"out_{decoder}_{path}")])
            torch.cuda.synchronize()
            reset_counts()
            with val_probes(cfg.rnnt.enc_stack_time_factor) as probe, (
                    plain_path() if path == "plain" else contextlib.nullcontext()):
                t0 = time.perf_counter()
                res = val.validate(args)
                wall = time.perf_counter() - t0
            runs[decoder, path] = {"res": res, "probe": probe, "counts": read_counts(),
                                   "wall_s": wall}
            torch.cuda.empty_cache()

    # the EMA leaves, bit for bit, in the model validated
    got = flatten_named(runs["greedy", "kernels"]["probe"]["tree"])
    if set(got) != set(ema) or not all(np.array_equal(got[k], ema[k]) for k in ema):
        raise AssertionError("the validated model's parameters are not the checkpoint's EMA")
    log(f"  the validated model holds the checkpoint's EMA leaves bit for bit ({len(ema)} "
        "leaves)")

    k, p = runs["greedy", "kernels"], runs["greedy", "plain"]
    rk, rp = k["res"], p["res"]
    nonempty = sum(bool(h) for h in rk.hyps)
    loss_err = abs(rk.loss - rp.loss) / abs(rp.loss)
    counts = k["counts"]
    dec = k["probe"]["decode"]
    dec_k1 = [d["k1"] for d in dec]
    expect = {"lstm_recurrence": batches * (enc_layers + loss_layers), "joint_fwd": batches}
    log(f"  greedy --calc_loss, fp32: WER {rk.wer:.6f} (plain path {rp.wer:.6f}), loss "
        f"{rk.loss:.6f} (plain {rp.loss:.6f}, relative {loss_err:.3g}, tol {VAL_RTOL}); "
        f"hypotheses identical: {rk.hyps == rp.hyps}, {nonempty}/{len(rk.hyps)} non-empty; "
        f"K1 a decoded batch {dec_k1} (expected {enc_layers}), launches {counts} (expected "
        f"{expect}: {enc_layers} K1 a decode and {loss_layers} a loss, one K2 a loss, per "
        "batch)")
    if rk.hyps != rp.hyps or rk.wer != rp.wer or rk.refs != rp.refs:
        raise AssertionError("validation with the kernels differs from the plain path's")
    if not (np.isfinite(rk.loss) and loss_err <= VAL_RTOL):
        raise AssertionError(f"validation loss {rk.loss} against the plain path's {rp.loss}")
    if nonempty < VAL_MIN_NONEMPTY or len(rk.hyps) != work["utterances"]:
        raise AssertionError(f"{nonempty} non-empty hypotheses of {len(rk.hyps)}")
    if dec_k1 != [enc_layers] * batches or any(
            counts[name] != n for name, n in expect.items()) or any(
            v for name, v in counts.items() if name not in expect):
        raise AssertionError(f"validation launches {counts}, decode K1 {dec_k1}")
    preds = json.loads((root / "out_greedy_kernels" / "preds" / "preds_step0.json").read_text())
    ctm = (root / "out_greedy_kernels" / "model.ctm").read_text()
    if [x["hyp"] for x in preds["predictions"]] != rk.hyps or not ctm.strip():
        raise AssertionError("the predictions JSON or the CTM do not hold the hypotheses")

    bk, bp = runs["fast_beam", "kernels"]["res"], runs["fast_beam", "plain"]["res"]
    beam_k1 = [d["k1"] for d in runs["fast_beam", "kernels"]["probe"]["decode"]]
    log(f"  fast_beam (W=4, E={VAL_BEAM_MSYM}), fp32: WER {bk.wer:.6f}, hypotheses identical "
        f"to the plain path's: {bk.hyps == bp.hyps}, {sum(map(bool, bk.hyps))} non-empty; K1 "
        f"a decoded batch {beam_k1}")
    if bk.hyps != bp.hyps or not any(bk.hyps) or beam_k1 != [enc_layers] * batches:
        raise AssertionError("the fast beam's validation differs from the plain path's")

    for (decoder, path), r in runs.items():
        probe = r["probe"]
        ev = probe["eval_ms"]
        parts = {kind: [round(d["ms"], 1) for d in probe[kind]]
                 for kind in ("load", "featurize", "decode", "loss")}
        rest = ev - sum(sum(v) for v in parts.values())
        emit = {k: [d[k] for d in probe["decode"]]
                for k in ("symbols", "frames", "most_at_a_frame")}
        out[f"{decoder}_{path}"] = {
            "wer": r["res"].wer, "loss": r["res"].loss, "wall_s": r["wall_s"], "eval_ms": ev,
            "ms_a_batch": ev / batches, "audio_s_per_s": work["audio_s"] / ev * 1e3,
            **{f"{kind}_ms": v for kind, v in parts.items()},
            **{f"{kind}_share": sum(v) / ev for kind, v in parts.items()},
            "host_rest_ms": rest, "launches": r["counts"], "emission": emit,
            "symbols_a_frame": sum(emit["symbols"]) / sum(emit["frames"])}
        log(f"  {decoder} {path}: evaluation {ev:.1f} ms ({ev / batches:.1f} ms a batch, "
            f"{work['audio_s'] / ev * 1e3:.1f} audio-s/s); ms a batch: "
            + ", ".join(f"{kind} {v} ({sum(v) / ev:.1%})" for kind, v in parts.items())
            + f", the rest on the host (trimming, detokenising, timestamps, WER, files) "
            f"{rest:.1f} ({rest / ev:.1%}); the decode emitted {emit['symbols']} symbols "
            f"over {emit['frames']} encoder frames a batch "
            f"({sum(emit['symbols']) / sum(emit['frames']):.2f} a frame, at most "
            f"{emit['most_at_a_frame']} at one); the first batch carries the capture of the "
            f"decoder's CUDA graphs; validate() {r['wall_s']:.2f} s on {card()}")
    out.update(ema_bit_equal=True, hyps_identical=True, nonempty=nonempty,
               loss_rel_err=loss_err, decode_k1=dec_k1, launches=counts,
               expected_launches=expect, beam_hyps_identical=True)
    return out


# ---------------------------------------------------------------- phase 15
# The training CLI: python -m caiman_asr_tpu_torch.train at base-85M from
# configs/base-8703sp.yaml on the phase-14 workspace (the smoke's utterances
# as WAV, the smoke tokenizer), mel statistics from generate_mel_stats.main,
# a directory of seeded noise clips; the JAX trainer's defaults otherwise
# (bf16, RSP [99, 0, 1], packing, SpecAugment, the noise probability 0.25).
CLI_STEPS = 4
CLI_NOISE_CLIPS, CLI_NOISE_S = 4, 3.0
CLI_RESUME_RTOL = 1e-6    # only where a CUDA op proves non-deterministic (printed)
# the short synthetic_e2e run (phase 15, and phase 19 (d) on the pruned
# loss): the mean loss of its last 20 logged steps must be below E2E_BAR
# times that of its first 20. 200 steps, not 500 or 300: with phase 19 the
# script took 979.7-1,109.9 s of its 1,200 on an H100, with phase 20
# 934.4-1,179.1 s at 300; the loss of the last 20 was 0.20-0.22 of the first
# 20's at 300 steps, and the later phases read its step-100 checkpoint (its
# best dev WER in each run so far)
E2E_STEPS, E2E_BAR = 200, 0.5


def train_cli_argv(root: Path, out: Path, steps: int) -> list:
    return ["--model_config", str(REPO / VAL_CONFIG),
            "--tokenizer_model", str(REPO / "build" / "smoke" / "tokenizer.json"),
            # the manifest twice: an epoch of two microbatches of 16
            "--dataset_dir", str(root), "--train_manifests", "manifest.json", "manifest.json",
            "--val_manifests", "manifest.json", "--output_dir", str(out),
            "--mel_stats_path", str(root / "mel_stats.npz"), "--norm_use_global_stats",
            "--global_batch_size", str(2 * N_UTTS), "--grad_accumulation_batches", "2",
            "--rsp_delay", "0", "--noise_dataset", str(root / "noise"),
            "--prob_background_noise", "0.25", "--noise_delay_steps", "0",
            "--training_steps", str(steps), "--val_frequency", "2", "--save_frequency", "2",
            "--log_frequency", "1", "--prediction_frequency", str(CLI_STEPS),
            "--val_batch_size", str(VAL_BATCH), "--skip_ngram"]


def write_noise(root: Path) -> None:
    """CLI_NOISE_CLIPS seeded clips of low-passed noise as WAV files."""
    import wave

    import numpy as np

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 16)
    for i in range(CLI_NOISE_CLIPS):
        x = np.convolve(rng.normal(size=int(CLI_NOISE_S * SR)), np.ones(8) / 8, mode="same")
        with wave.open(str(root / f"noise{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((np.clip(0.3 * x, -1, 1) * 32767).astype(np.int16).tobytes())


def train_log(out: Path) -> dict:
    """{step: (loss, grad_norm)} of a run's train records."""
    recs = {}
    for f in sorted(out.glob("log_*.jsonl")):
        for line in f.read_text().splitlines():
            r = json.loads(line)
            if r.get("subset") == "train" and "loss" in r:
                recs[r["step"][1]] = (r["loss"], r["grad_norm"])
    return recs


@contextlib.contextmanager
def cli_probes():
    """Within: what a train.main call did, in ``probe``: per train step its
    ms (between two synchronises) and kernel launches, per evaluation and
    per checkpoint save their ms (and the file's MB)."""
    import torch

    from caiman_asr_tpu_torch.evaluate import core
    from caiman_asr_tpu_torch.export.checkpointer import Checkpointer
    from caiman_asr_tpu_torch.training import step as step_mod

    probe = {"steps": [], "evals": [], "saves": []}
    real_make, real_eval, real_save = (step_mod.make_train_step, core.evaluate,
                                       Checkpointer.save)

    def make_train_step(*a, **kw):
        inner = real_make(*a, **kw)

        def timed(*sa, **skw):
            torch.cuda.synchronize()
            before, t0 = read_counts(), time.perf_counter()
            out = inner(*sa, **skw)
            torch.cuda.synchronize()
            after = read_counts()
            probe["steps"].append({"ms": 1e3 * (time.perf_counter() - t0),
                                   "launches": {k: after[k] - before[k] for k in after
                                                if after[k] != before[k]},
                                   "pack_to": skw.get("pack_to")})
            return out
        return timed

    def evaluate(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_eval(*a, **kw)
        torch.cuda.synchronize()
        probe["evals"].append({"ms": 1e3 * (time.perf_counter() - t0), "wer": out.wer,
                               "loss": out.loss})
        return out

    def save(self, *a, **kw):
        t0 = time.perf_counter()
        path = real_save(self, *a, **kw)
        probe["saves"].append({"ms": 1e3 * (time.perf_counter() - t0), "name": path.name,
                               "mb": path.stat().st_size / 2 ** 20})
        return path

    with contextlib.ExitStack() as patches:
        patches.enter_context(mock.patch.object(step_mod, "make_train_step", make_train_step))
        patches.enter_context(mock.patch.object(core, "evaluate", evaluate))
        patches.enter_context(mock.patch.object(Checkpointer, "save", save))
        yield probe


def run_cli(root: Path, out: Path, steps: int, resume: bool = False) -> dict:
    """train.main on parsed argv, probed; returns the probe, its counts and
    the PhaseTimers summary it wrote."""
    from caiman_asr_tpu_torch import train

    args = train.train_arg_parser().parse_args(
        train_cli_argv(root, out, steps) + (["--resume"] if resume else []))
    reset_counts()
    with cli_probes() as probe:
        t0 = time.perf_counter()
        state, best = train.main(args)
        wall = time.perf_counter() - t0
    timings = json.loads((out / "benchmark" / f"timings_step{steps}.json").read_text())
    return {"probe": probe, "counts": read_counts(), "wall_s": wall, "timings": timings,
            "best_wer": best, "step": state.step}


def _serving_transcripts(args) -> tuple:
    """(the engine's weights by name, its streamed transcripts of the
    workspace's utterances) for a server built from ``args``."""
    import numpy as np

    from caiman_asr_tpu_torch.data.audio import read_audio
    from caiman_asr_tpu_torch.serving import server
    from caiman_asr_tpu_torch.training.tree import tree_items

    engine = server.build_engine(args)
    engine.warmup()
    root = Path(args.dataset_dir)
    pcm = []
    for u in json.loads((root / "manifest.json").read_text()):
        x = read_audio(root / u["files"][0]["fname"], SR)
        x = (np.clip(x, -1, 1) * 32767).astype(np.int16)
        pcm.append(x[: len(x) // 960 * 960])
    _, texts = _stream_texts(engine, pcm)
    weights = {"/".join(p): t.detach().cpu().numpy() for p, t in
               tree_items(engine.model.param_tree())}
    stats = [getattr(engine, k).detach().cpu().numpy() for k in ("_mean", "_std")]
    return weights, texts, stats


def serving_check(root: Path, ckpt: Path) -> dict:
    """The step-4 checkpoint through create_serving_bundle and the server
    built from that bundle and from --ckpt + --mel_stats_path: the same
    weights and mel statistics, identical streamed transcripts."""
    from argparse import Namespace

    import numpy as np

    from caiman_asr_tpu_torch.export.serving_bundle import create_serving_bundle

    spm = REPO / "build" / "smoke" / "tokenizer.model"
    t0 = time.perf_counter()
    bundle = create_serving_bundle(ckpt, REPO / VAL_CONFIG, root / "bundle.npz",
                                   mel_stats_path=root / "mel_stats.npz",
                                   sentencepiece_path=spm, ngram_path=None)
    bundle_ms = 1e3 * (time.perf_counter() - t0)
    common = dict(model_config=str(REPO / VAL_CONFIG), dataset_dir=str(root), max_streams=N_UTTS,
                  pipeline_depth=0, wire_responses=False, decoder="greedy", num_chips=1,
                  device="cuda")
    from_bundle = _serving_transcripts(Namespace(**common, serving_bundle=str(bundle), ckpt=None,
                                                 tokenizer_model=None, mel_stats_path=None))
    from_ckpt = _serving_transcripts(Namespace(**common, serving_bundle=None, ckpt=str(ckpt),
                                               tokenizer_model=str(spm),
                                               mel_stats_path=str(root / "mel_stats.npz")))
    (wb, tb, sb), (wc, tc, sc) = from_bundle, from_ckpt
    same_weights = wb.keys() == wc.keys() and all(np.array_equal(wb[k], wc[k]) for k in wb)
    same_stats = len(sb) == len(sc) and all(np.array_equal(a, b) for a, b in zip(sb, sc))
    log(f"  serving: bundle {bundle.stat().st_size / 2 ** 20:.1f} MB written in {bundle_ms:.1f} "
        f"ms; servers from the bundle and from --ckpt: weights equal {same_weights} "
        f"({len(wb)} leaves), mel statistics equal {same_stats}, transcripts identical "
        f"{tb == tc} ({sum(map(bool, tb))} of {len(tb)} non-empty, {sum(map(len, tb))} "
        "characters)")
    if not (same_weights and same_stats and tb == tc):
        raise AssertionError("the bundle server and the --ckpt server differ")
    return {"bundle_mb": bundle.stat().st_size / 2 ** 20, "bundle_ms": bundle_ms,
            "weights_equal": same_weights, "stats_equal": same_stats,
            "transcripts_identical": True, "nonempty": sum(map(bool, tb)),
            "characters": sum(map(len, tb))}


def run_train_cli() -> dict:
    """Phase 15: python -m caiman_asr_tpu_torch.train at base-85M on the
    card: 4 steps; 2 steps then --resume to 4, equal to the bit; the bundle
    server against the --ckpt server; a short synthetic_e2e."""
    import shutil

    import numpy as np
    import torch

    from caiman_asr_tpu_torch import synthetic_e2e
    from caiman_asr_tpu_torch.data import generate_mel_stats
    from caiman_asr_tpu_torch.data.tokenizer import save_sentencepiece_model
    from caiman_asr_tpu_torch.export.checkpointer import flatten_named, load_checkpoint

    root = REPO / "build" / "smoke" / "train_cli"
    work = write_val_workspace(root)
    pieces = json.loads((REPO / "build" / "smoke" / "tokenizer.json").read_text())["pieces"]
    save_sentencepiece_model(REPO / "build" / "smoke" / "tokenizer.model", pieces)
    write_noise(root / "noise")
    t0 = time.perf_counter()
    generate_mel_stats.main(["--model_config", str(REPO / VAL_CONFIG), "--dataset_dir",
                             str(root), "--manifests", "manifest.json", "--output_path",
                             str(root / "mel_stats.npz")])
    stats_ms = 1e3 * (time.perf_counter() - t0)
    out_a, out_b = root / "run_a", root / "run_b"
    for d in (out_a, out_b):
        shutil.rmtree(d, ignore_errors=True)
    a = run_cli(root, out_a, CLI_STEPS)
    torch.cuda.empty_cache()
    b1 = run_cli(root, out_b, CLI_STEPS // 2)
    torch.cuda.empty_cache()
    b2 = run_cli(root, out_b, CLI_STEPS, resume=True)
    torch.cuda.empty_cache()

    # the resumed run against the uninterrupted one
    log_a, log_b = train_log(out_a), train_log(out_b)
    tail = range(CLI_STEPS // 2 + 1, CLI_STEPS + 1)
    logs_equal = all(log_a[s] == log_b[s] for s in tail)
    ca, cb = (load_checkpoint(o / "ckpts" / f"step{CLI_STEPS}.npz") for o in (out_a, out_b))
    leaves = {}
    for name, x, y in (("params", ca[0], cb[0]), ("ema", ca[1], cb[1])):
        fx, fy = flatten_named(x), flatten_named(y)
        leaves.update({f"{name}/{k}": (fx[k], fy[k]) for k in fx})
    leaves.update({f"opt/{i}": (x, y) for i, (x, y) in enumerate(zip(ca[2], cb[2]))})
    unequal = sorted(k for k, (x, y) in leaves.items() if not np.array_equal(x, y))
    rel = max([abs(y - x) / max(abs(x), 1e-30) for s in tail
               for x, y in zip(log_a[s], log_b[s])]
              + [float(np.max(np.abs(x.astype(np.float64) - y)) / max(np.max(np.abs(x)), 1e-30))
                 for x, y in leaves.values()])
    bit_equal = logs_equal and not unequal
    log(f"  resume: steps {list(tail)} of the run resumed at step {CLI_STEPS // 2} against the "
        f"uninterrupted run: losses and gradient norms equal to the bit {logs_equal} "
        f"({[log_a[s] for s in tail]} / {[log_b[s] for s in tail]}); the step-{CLI_STEPS} "
        f"checkpoint's {len(leaves)} params, EMA and opt leaves equal to the bit "
        f"{not unequal} (unequal: {unequal[:6]}{'...' if len(unequal) > 6 else ''}); the "
        f"largest relative difference {rel:.3g}")
    if not bit_equal:
        log(f"  NOTE: the resumed run is not bit-equal; held within {CLI_RESUME_RTOL} relative")
    if rel > CLI_RESUME_RTOL or sorted(log_a) != list(range(1, CLI_STEPS + 1)):
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {rel}")
    if any(r["probe"]["steps"][i]["launches"].get(k, 0) == 0 for r in (a, b1, b2)
           for i in range(len(r["probe"]["steps"])) for k in LSTM_TRAIN_KERNELS):
        raise AssertionError("a train step of the CLI did not launch K3a and K3b")
    for run_name, r in (("4 steps", a), ("2 steps", b1), ("resumed", b2)):
        for i, st in enumerate(r["probe"]["steps"]):
            check_finish_launches(st["launches"], f"the CLI's {run_name} run, step {i + 1}")

    serving = serving_check(root, out_a / "ckpts" / f"step{CLI_STEPS}.npz")
    torch.cuda.empty_cache()

    # the short synthetic_e2e: the loss falls
    e2e_root = REPO / "build" / "smoke" / "e2e"
    reset_counts()
    t0 = time.perf_counter()
    e2e = synthetic_e2e.run(e2e_root, steps=E2E_STEPS, log_frequency=1)
    e2e_s = time.perf_counter() - t0
    e2e_counts = {k: v for k, v in read_counts().items() if v}
    losses = [e2e["losses"][k] for k in sorted(e2e["losses"])]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    log(f"  synthetic_e2e, {E2E_STEPS} steps: mean loss of the first 20 steps {first:.4f}, of "
        f"the last 20 {last:.4f} ({last / first:.3f} of it; bar {E2E_BAR}); greedy best dev "
        f"WER {e2e['greedy_best_wer']:.4f}, fast beam {e2e['beam_wer']:.4f}; training "
        f"{e2e['train_s']:.1f} s ({1e3 * e2e['train_s'] / E2E_STEPS:.1f} ms a step with "
        f"validation), {e2e_s:.1f} s in all; launches {e2e_counts}")
    if not last < E2E_BAR * first:
        raise AssertionError(f"the synthetic task's loss did not fall: {first} -> {last}")
    for k in ("lstm_recurrence", "lstm_recurrence_sg", "lstm_recurrence_bwd"):
        if not e2e_counts.get(k):
            raise AssertionError(f"synthetic_e2e never launched {k}")

    steps_ms = [r["ms"] for r in a["probe"]["steps"]]
    per_step = a["probe"]["steps"][-1]["launches"]
    shares = {k: v["total_s"] for k, v in a["timings"].items()}
    total = sum(shares.values())
    evals = [e["ms"] for r in (a, b1, b2) for e in r["probe"]["evals"]]
    saves = [s for r in (a, b1, b2) for s in r["probe"]["saves"]]
    log(f"  train CLI, base-85M bf16, A=2 x B={N_UTTS}: step 1 {steps_ms[0]:.1f} ms, steps "
        f"2-{CLI_STEPS} median {float(np.median(steps_ms[1:])):.1f} ms ({steps_ms[1:]}); "
        "PhaseTimers' shares of run A: " + ", ".join(
            f"{k} {v / total:.1%} ({1e3 * v / a['timings'][k]['count']:.1f} ms each)"
            for k, v in shares.items())
        + f"; pack_to {[r['pack_to'] for r in a['probe']['steps']]}; launches a step "
        f"{per_step} (phase 13's default step: K3a 20, K3b 20, K5 2 each); validation "
        f"{[round(e, 1) for e in evals]} ms; checkpoint saves "
        f"{[(s['name'], round(s['ms'], 1), round(s['mb'], 1)) for s in saves]} (ms, MB); run "
        f"A {a['wall_s']:.1f} s, B {b1['wall_s']:.1f} + {b2['wall_s']:.1f} s; mel statistics "
        f"{stats_ms:.1f} ms; on {card()}")
    return {"steps_ms": steps_ms, "step1_ms": steps_ms[0],
            "median_ms": float(np.median(steps_ms[1:])), "phase_s": shares,
            "launches_a_step": per_step, "launches": a["counts"],
            "pack_to": [r["pack_to"] for r in a["probe"]["steps"]],
            "eval_ms": evals, "saves": saves, "wall_s": [a["wall_s"], b1["wall_s"],
                                                         b2["wall_s"]],
            "resume_bit_equal": bit_equal, "resume_max_rel": rel, "serving": serving,
            "e2e": {"steps": E2E_STEPS, "first20": first, "last20": last, "bar": E2E_BAR,
                    "greedy_best_wer": e2e["greedy_best_wer"], "beam_wer": e2e["beam_wer"],
                    "train_s": e2e["train_s"], "wall_s": e2e_s, "launches": e2e_counts},
            "mel_stats_ms": stats_ms, "utterances": work["utterances"], "card": card()}


# ------------------------------------------------- training over processes
# Phase 16: python -m torch.distributed.run --standalone --nproc_per_node 2
# with --multihost, base-85M on the card, A=2 x MH_B utterances a rank (the
# two ranks together phase 15's A=2 x 16). Each rank is this script run by
# the launcher as a rank worker (--rank-worker SPEC): it calls train.main on
# the parsed argv, as python -m caiman_asr_tpu_torch.train does, with
# cli_probes around it and the gradient all-reduce timed, and writes what it
# saw (per step ms and launches, the all-reduce's ms, the SHA-256 of its
# final params, EMA and moments) for this process to read.
MH_B = N_UTTS // 2
MH_RANKS = 2
MH_STEPS = 4
MH_LOSS_RTOL, MH_GRAD_RTOL, MH_DEV_RTOL = 1e-5, 1e-4, 1e-5
MH_TIMEOUT = 420          # seconds for one launch of the ranks
# configs/base-8703sp.yaml with nothing random (run a): no subword sampling,
# dither, speed perturbation, SpecAugment or dropout
MH_PLAIN_EDITS = [("  sampling: 0.05", "  sampling: 0.0"),
                  ("    dither: 0.00001", "    dither: 0.0"),
                  ("  enc_dropout: 0.1", "  enc_dropout: 0.0"),
                  ("  pred_dropout: 0.3", "  pred_dropout: 0.0"),
                  ("  joint_dropout: 0.3", "  joint_dropout: 0.0")]


def mh_plain_config(path: Path) -> Path:
    """VAL_CONFIG with MH_PLAIN_EDITS made and its speed perturbation and
    SpecAugment blocks taken out."""
    text = (REPO / VAL_CONFIG).read_text()
    for old, new in MH_PLAIN_EDITS:
        if text.count(old) != 1:
            raise AssertionError(f"{VAL_CONFIG}: {old!r} not found once")
        text = text.replace(old, new)
    lines, out, skip = text.splitlines(), [], None
    for line in lines:
        indent = len(line) - len(line.lstrip())
        if skip is not None and line.strip() and indent <= skip:
            skip = None
        if skip is None and line.strip() in ("speed_perturbation:", "spec_augment:"):
            skip = indent
            continue
        if skip is None:
            out.append(line)
    path.write_text("\n".join(out) + "\n")
    return path


def mh_argv(root: Path, out: Path, *, config: Path, steps: int, rank_batch: int,
            tar: dict = None, bf16: bool = True, val_frequency: int = MH_STEPS,
            save_frequency: int = MH_STEPS) -> list:
    """train.main's argv: phase 15's workspace, ``rank_batch`` utterances a
    microbatch (A=2), validation and checkpoints at MH_STEPS; with ``tar``
    the shards in place of the manifests."""
    argv = ["--model_config", str(config),
            "--tokenizer_model", str(REPO / "build" / "smoke" / "tokenizer.json"),
            "--dataset_dir", str(root), "--output_dir", str(out),
            "--mel_stats_path", str(root / "mel_stats.npz"), "--norm_use_global_stats",
            "--global_batch_size", str(2 * rank_batch), "--grad_accumulation_batches", "2",
            "--rsp_delay", "0", "--training_steps", str(steps),
            "--val_frequency", str(val_frequency), "--save_frequency", str(save_frequency),
            "--log_frequency", "1", "--prediction_frequency", str(10 * MH_STEPS),
            "--val_batch_size", str(rank_batch), "--skip_ngram", "--dump_preds",
            "--dont_save_at_the_end"]
    if tar:
        argv += ["--read_from_tar", "--train_tar_files", *tar["train"],
                 "--val_tar_files", *tar["val"]]
    else:
        argv += ["--train_manifests", "manifest.json", "manifest.json",
                 "--val_manifests", "manifest.json"]
    return argv + ([] if bf16 else ["--no_amp"])


def state_sha256(state) -> str:
    """SHA-256 of a TrainState's params, EMA and moments, leaf by leaf."""
    import hashlib

    from caiman_asr_tpu_torch.training.tree import tree_items

    h = hashlib.sha256()
    for tree in (state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu):
        for path, t in tree_items(tree):
            h.update("/".join(path).encode())
            h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_worker(spec_path: str) -> int:
    """One rank of a phase-16 or phase-19 launch: phase 19 (b) where the
    spec has ``vp``, then train.main on each of the spec's runs (argv and
    record) in turn, probed, in one process group; writes the rank's record
    of each."""
    import os

    import torch

    sys.path.insert(0, str(REPO))
    from caiman_asr_tpu_torch import train
    from caiman_asr_tpu_torch.parallel import mesh

    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    mesh.init_multihost(device="cuda")
    if "vp" in spec:
        vp = vp_check(spec["vp"])
        Path(spec["vp"]["record"] + f".rank{rank}.json").write_text(json.dumps(vp))
        torch.cuda.empty_cache()
    for run in spec["runs"]:
        args = train.train_arg_parser().parse_args(run["argv"])
        ar_ms = []
        real_reduce = mesh.all_reduce_flat

        def timed_reduce(tensors, group=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_reduce(tensors, group)
            torch.cuda.synchronize()
            ar_ms.append(1e3 * (time.perf_counter() - t0))
            return out

        reset_counts()
        with cli_probes() as probe, mock.patch.object(mesh, "all_reduce_flat", timed_reduce):
            t0 = time.perf_counter()
            state, best = train.main(args)
            wall = time.perf_counter() - t0
        record = {"rank": rank, "world": int(os.environ["WORLD_SIZE"]), "step": state.step,
                  "sha256": state_sha256(state), "steps": probe["steps"],
                  "evals": probe["evals"], "saves": probe["saves"], "all_reduce_ms": ar_ms,
                  "counts": read_counts(), "wall_s": wall, "best_wer": best,
                  "shard": list(state.params["joint_fc"]["w"].shape),
                  "device": str(torch.cuda.current_device()),
                  "card": torch.cuda.get_device_name(torch.cuda.current_device())}
        Path(run["record"] + f".rank{rank}.json").write_text(json.dumps(record))
        del state
        torch.cuda.empty_cache()
    mesh.shutdown()
    return 0


def launch_ranks(name: str, argv: list, work: Path, cards: str) -> dict:
    """python -m torch.distributed.run --standalone --nproc_per_node 2 with
    this script's rank worker on ``argv``, the cards ``cards``
    (CUDA_VISIBLE_DEVICES); returns the ranks' records and the launcher's
    output (its log under ``work``)."""
    return launch_runs(name, {name: argv}, work, cards)[name]


def launch_runs(name: str, runs: dict, work: Path, cards: str, vp: dict = None) -> dict:
    """One launch of the ranks (as ``launch_ranks``) running train.main on
    each argv of ``runs`` in turn, after phase 19 (b) on the shapes ``vp``
    where it is given; returns each run's ranks' records, the launcher's
    backend lines and the launch's wall seconds, and under ``vp`` the ranks'
    records of (b)."""
    import os

    spec = work / f"{name}.spec.json"
    records = {run: work / f"{run}.record" for run in runs}
    spec_d = {"runs": [{"argv": argv + ["--multihost"], "record": str(records[run])}
                       for run, argv in runs.items()]}
    if vp is not None:
        spec_d["vp"] = dict(vp, record=str(work / f"{name}.vp.record"))
    spec.write_text(json.dumps(spec_d))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards, OMP_NUM_THREADS="4",
               PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(MH_RANKS), str(Path(__file__).resolve()), "--rank-worker",
           str(spec)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          cwd=REPO, env=env, timeout=MH_TIMEOUT)
    wall = time.perf_counter() - t0
    (work / f"{name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise AssertionError(f"the {name} launch failed (rc {proc.returncode}):\n"
                             + proc.stdout[-6000:])
    backend = [ln for ln in proc.stdout.splitlines() if "torch.distributed: rank" in ln]
    out = {run: {"ranks": [json.loads(Path(f"{records[run]}.rank{r}.json").read_text())
                           for r in range(MH_RANKS)],
                 "backend_lines": backend, "wall_s": wall} for run in runs}
    if vp is not None:
        out["vp"] = [json.loads(Path(f"{spec_d['vp']['record']}.rank{r}.json").read_text())
                     for r in range(MH_RANKS)]
    return out


def one_process_validation(argv: list, ckpt: Path):
    """The EMA of ``ckpt`` validated in this process as train.main validates
    (the same builders and evaluate call, fp32)."""
    from caiman_asr_tpu_torch import train
    from caiman_asr_tpu_torch.evaluate.core import evaluate
    from caiman_asr_tpu_torch.export.checkpointer import apply_params, load_checkpoint
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.setup.builders import (
        apply_input_overrides, build_data_source_loader, build_decoder,
        build_feature_pipelines, build_model, build_tokenizer, load_mel_stats,
        normalize_config_from)
    from caiman_asr_tpu_torch.training.step import make_val_loss_step
    from caiman_asr_tpu_torch.utils.user_tokens import user_token_idx

    args = train.train_arg_parser().parse_args(argv)
    cfg = apply_input_overrides(load_config(args.model_config, args.max_duration), args)
    tok = build_tokenizer(cfg, args.tokenizer_model, sampling=0.0)
    model, blank = build_model(cfg, tok, args, device="cuda")
    model.eval()
    _, ema, _, _ = load_checkpoint(ckpt)
    apply_params(model.param_tree(), ema)
    _, val_fp = build_feature_pipelines(cfg, load_mel_stats(args.mel_stats_path), device="cuda")
    loader = build_data_source_loader(args, cfg, tok, args.val_batch_size, train=False)
    decoder = build_decoder(model, blank, tok, args, cfg,
                            eos_idx=user_token_idx("eos", cfg.user_tokens, tok))
    return evaluate(model, decoder, loader, val_fp, tok,
                    val_loss_fn=make_val_loss_step(model, blank, device="cuda"),
                    standardize_wer=cfg.input_val.dataset.standardize_wer,
                    normalize_config=normalize_config_from(cfg.input_val),
                    charset=list(cfg.tokenizer.labels))


def mh_preds(out: Path, step: int) -> tuple:
    p = json.loads((out / "preds" / f"preds_step{step}.json").read_text())
    return p["wer"], {x["fname"]: x["hyp"] for x in p["predictions"]}


def check_ranks(name: str, run: dict, out: Path, argv: list) -> dict:
    """The ranks of a launch: bit-equal final states, K3a, K3b and the
    joint's kernels (in bf16 K5-store, K5-A, K5-B) on every step of every
    rank, and the dev WER and hypotheses equal to a one-process validation
    of the run's step-MH_STEPS checkpoint."""
    import numpy as np
    import torch

    recs = run["ranks"]
    shas = [r["sha256"] for r in recs]
    if len(set(shas)) != 1 or any(r["step"] != MH_STEPS for r in recs):
        raise AssertionError(f"{name}: the ranks' final states differ: {shas}, steps "
                             f"{[r['step'] for r in recs]}")
    per_step = [[s["launches"] for s in r["steps"]] for r in recs]
    for r, steps in enumerate(per_step):
        for i, launches in enumerate(steps):
            missing = [k for k in MH_KERNELS + (() if "--no_amp" in argv else MH_K5)
                       if not launches.get(k)]
            if missing or not any(v for k, v in launches.items() if k.startswith("joint_")):
                raise AssertionError(f"{name}: rank {r} step {i + 1} launched none of {missing}")
            check_finish_launches(launches, f"{name}: rank {r} step {i + 1}")
    wer, hyps = mh_preds(out, MH_STEPS)
    torch.cuda.empty_cache()
    ref = one_process_validation(argv, out / "ckpts" / f"step{MH_STEPS}.npz")
    torch.cuda.empty_cache()
    ref_hyps = dict(zip(ref.fnames, ref.hyps))
    dev = train_dev(out)
    dev_err = abs(dev[MH_STEPS] - ref.loss) / abs(ref.loss)
    same = wer == ref.wer and hyps == ref_hyps
    steps_ms = [[s["ms"] for s in r["steps"]] for r in recs]
    ar = [r["all_reduce_ms"] for r in recs]
    log(f"  {name}: {run['backend_lines']}; ranks' final params, EMA and moments equal to the "
        f"bit: {len(set(shas)) == 1} (SHA-256 {shas[0][:16]}...); dev WER {wer:.6f} over "
        f"{len(hyps)} files, one-process validation of the step-{MH_STEPS} checkpoint "
        f"{ref.wer:.6f}, hypotheses identical {hyps == ref_hyps}; dev loss {dev[MH_STEPS]:.6f} "
        f"against {ref.loss:.6f} (relative {dev_err:.3g}, tol {MH_DEV_RTOL}); ms a step per "
        f"rank {[[round(x, 1) for x in s] for s in steps_ms]} (steps 2-{MH_STEPS} median "
        f"{float(np.median([x for s in steps_ms for x in s[1:]])):.1f}); gradient all-reduce "
        f"ms a step per rank {[[round(x, 1) for x in a] for a in ar]}; launches a step, rank 0 "
        f"{per_step[0][-1]}, rank 1 {per_step[1][-1]}; launch wall {run['wall_s']:.1f} s")
    if not same or dev_err > MH_DEV_RTOL:
        raise AssertionError(f"{name}: the ranks' validation differs from one process's")
    return {"sha256": shas[0], "steps_ms": steps_ms, "all_reduce_ms": ar,
            "median_ms": float(np.median([x for s in steps_ms for x in s[1:]])),
            "all_reduce_median_ms": float(np.median([x for a in ar for x in a[1:]])),
            "launches_a_step": per_step[0][-1], "launches_a_step_rank1": per_step[1][-1],
            "counts": [r["counts"] for r in recs], "dev_wer": wer, "dev_loss": dev[MH_STEPS],
            "one_process_wer": ref.wer, "one_process_loss": ref.loss,
            "backend": run["backend_lines"], "wall_s": run["wall_s"],
            "evals_ms": [[e["ms"] for e in r["evals"]] for r in recs]}


def train_dev(out: Path) -> dict:
    """{step: dev loss} of a run's validations."""
    recs = {}
    for f in sorted(out.glob("log_*.jsonl")):
        for line in f.read_text().splitlines():
            r = json.loads(line)
            if r.get("subset") == "dev_ema" and "loss" in r:
                recs[r["step"][1]] = r["loss"]
    return recs


# the kernels every train step of every rank launches, and in bf16 also the
# bf16 slab's joint kernels (in fp32 some joint kernel)
MH_KERNELS = LSTM_TRAIN_KERNELS
MH_K5 = ("joint_fwd_store", "joint_bwd_dh", "joint_bwd_dw")


def run_multihost() -> dict:
    """Phase 16: two ranks of python -m torch.distributed.run ... --multihost
    at base-85M on the card: (a) fp32 over manifests against one process at
    B=16 on the same global batches; (b) bf16 on tar shards; (c) (b)'s
    step-2 checkpoint resumed to 4, equal to the bit; (a) over NCCL on two
    cards where there are two."""
    import shutil

    import numpy as np
    import torch

    from caiman_asr_tpu_torch import train
    from caiman_asr_tpu_torch.data.make_webdataset import write_shards
    from caiman_asr_tpu_torch.data.manifest import load_manifests

    t_phase = time.perf_counter()
    root = REPO / "build" / "smoke" / "train_cli"  # phase 15's workspace
    work = REPO / "build" / "smoke" / "multihost"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    plain = mh_plain_config(work / "base-plain.yaml")
    train_tars = write_shards(load_manifests([root / "manifest.json"] * 2), work / "train_tar",
                              samples_per_shard=N_UTTS)
    val_tars = write_shards(load_manifests([root / "manifest.json"]), work / "val_tar",
                            samples_per_shard=N_UTTS)
    tar = {"train": [str(p) for p in train_tars], "val": [str(p) for p in val_tars]}
    log(f"  tar shards: {len(train_tars)} train ({2 * N_UTTS} samples), {len(val_tars)} dev "
        f"({N_UTTS}), written by data/make_webdataset; {torch.cuda.device_count()} card(s)")

    # (a) fp32 over manifests, against one process at B=16; (b) bf16 on tar
    # shards, RSP and packing, the base config's randomness, whose step-2
    # checkpoint is where (c) resumes: one launch runs both
    out_a, out_1, out_b, out_c = work / "a", work / "one", work / "b", work / "c"
    cfg = REPO / VAL_CONFIG
    argv_a = mh_argv(root, out_a, config=plain, steps=MH_STEPS, rank_batch=MH_B, bf16=False)
    argv_b = mh_argv(root, out_b, config=cfg, steps=MH_STEPS, rank_batch=MH_B, tar=tar,
                     save_frequency=MH_STEPS // 2)
    ab = launch_runs("ab", {"a": argv_a, "b": argv_b}, work, "0")
    a, b = ab["a"], ab["b"]
    # (the one process's steps alone: its validation would be another model's)
    argv_1 = mh_argv(root, out_1, config=plain, steps=MH_STEPS, rank_batch=MH_RANKS * MH_B,
                     bf16=False, val_frequency=10 * MH_STEPS, save_frequency=10 * MH_STEPS)
    torch.cuda.empty_cache()
    reset_counts()
    with cli_probes() as probe1:
        train.main(train.train_arg_parser().parse_args(argv_1))
    torch.cuda.empty_cache()
    got, want = train_log(out_a), train_log(out_1)
    if not sorted(got) == sorted(want) == list(range(1, MH_STEPS + 1)):
        raise AssertionError(f"(a): steps {sorted(got)} against {sorted(want)}")
    loss_err = max(abs(got[s][0] - want[s][0]) / abs(want[s][0]) for s in want)
    gn_err = max(abs(got[s][1] - want[s][1]) / abs(want[s][1]) for s in want)
    log(f"  (a) fp32 over manifests, two ranks at B={MH_B} against one process at "
        f"B={MH_RANKS * MH_B}: losses {[got[s][0] for s in sorted(got)]} / "
        f"{[want[s][0] for s in sorted(want)]} (largest relative difference {loss_err:.3g}, "
        f"tol {MH_LOSS_RTOL}); gradient norms relative {gn_err:.3g} (tol {MH_GRAD_RTOL}); "
        f"one process's ms a step {[round(s['ms'], 1) for s in probe1['steps']]}")
    if loss_err > MH_LOSS_RTOL or gn_err > MH_GRAD_RTOL:
        raise AssertionError("(a): the two ranks differ from one process")
    res = {"a": check_ranks("(a) fp32, manifests", a, out_a, argv_a)}
    res["a"].update(loss_rel=loss_err, grad_norm_rel=gn_err,
                    one_process_ms=[s["ms"] for s in probe1["steps"]])

    res["b"] = check_ranks("(b) bf16, tar shards", b, out_b, argv_b)

    # (c) (b)'s first 2 steps resumed to 4 by a new launch: equal to the bit
    argv_c = mh_argv(root, out_c, config=cfg, steps=MH_STEPS, rank_batch=MH_B, tar=tar) + [
        "--resume", "--ckpt", str(out_b / "ckpts" / f"step{MH_STEPS // 2}.npz")]
    c2 = launch_ranks("c", argv_c, work, "0")
    log_b, log_c = train_log(out_b), train_log(out_c)
    tail = range(MH_STEPS // 2 + 1, MH_STEPS + 1)
    logs_equal = all(log_b[s] == log_c[s] for s in tail)
    shas_equal = {r["sha256"] for r in b["ranks"] + c2["ranks"]}
    dev_b, dev_c = train_dev(out_b), train_dev(out_c)
    log(f"  (c) (b)'s step-{MH_STEPS // 2} checkpoint, --resume to {MH_STEPS} by a new launch: "
        f"steps {list(tail)}'s "
        f"losses and gradient norms equal to the bit {logs_equal} ({[log_b[s] for s in tail]} "
        f"/ {[log_c[s] for s in tail]}); every rank's final state equal to (b)'s "
        f"{len(shas_equal) == 1}; dev loss {dev_c.get(MH_STEPS)} against "
        f"{dev_b.get(MH_STEPS)}; launch wall {c2['wall_s']:.1f} s")
    if not logs_equal or len(shas_equal) != 1 or dev_b[MH_STEPS] != dev_c[MH_STEPS]:
        raise AssertionError("(c): the resumed two-rank run differs from the uninterrupted one")
    res["c"] = {"bit_equal": True, "wall_s": c2["wall_s"],
                "resumed_steps_ms": [[s["ms"] for s in r["steps"]] for r in c2["ranks"]]}

    # (a) over NCCL on two cards
    if torch.cuda.device_count() >= 2:
        out_n = work / "nccl"
        argv_n = mh_argv(root, out_n, config=plain, steps=MH_STEPS, rank_batch=MH_B,
                         bf16=False)
        n = launch_ranks("nccl", argv_n, work, "0,1")
        if not all("backend nccl" in ln for ln in n["backend_lines"]):
            raise AssertionError(f"two cards: {n['backend_lines']}")
        res["nccl"] = check_ranks("(a) over NCCL, two cards", n, out_n, argv_n)
        got_n = train_log(out_n)
        nccl_err = max(abs(got_n[s][0] - want[s][0]) / abs(want[s][0]) for s in want)
        if nccl_err > MH_LOSS_RTOL:
            raise AssertionError(f"NCCL: losses {nccl_err} from one process's")
        res["nccl"]["loss_rel"] = nccl_err
    else:
        log("  nccl over two cards: not run (1 card)")
        res["nccl"] = "not run (1 card)"
    res["card"] = card()
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 16 took {res['wall_s']:.1f} s on {res['card']}")
    return res


# ---------------------------------------------------------------- phase 17
# Latency measurement and the data and evaluation tools on the phase-14
# workspace (base-85M from configs/base-8703sp.yaml, its port-written
# checkpoint, the smoke tokenizer and mel statistics), phase 15's trained
# synthetic_e2e model and phase 16's tar shards: python -m
# caiman_asr_tpu_torch.latency.generate_gt_ctm (K1 in enc_pred, the dense
# joint and its lattice scores on the card, the Viterbi on the host),
# val.py --gt_ctm and measure_latency, val_multiple, the reference .pt
# export and import, and --read_from_tar in spm_train and generate_mel_stats.
LT_B = 8                  # generate_gt_ctm's default batch
LT_SCORE_TOL = 1e-4       # lattice scores and path scores, kernels against the plain path
LT_LOSS_RTOL = 1e-5       # a val_multiple row's loss against a separate val.validate
LT_SHORT = 4              # utterances of val_multiple's second manifest


@contextlib.contextmanager
def align_probes():
    """Within: per alignment batch of generate_gt_ctm, its wall ms between two
    synchronises (``viterbi_alignment``: the encoder, the predictor, the dense
    joint, the lattice scores and the Viterbi), the host Viterbi's ms, the
    lattice scores (copied to the host) and the frames."""
    import torch

    from caiman_asr_tpu_torch.latency import forced_align as fa

    probe = {"batches": []}
    real_align, real_scores, real_viterbi = (fa.viterbi_alignment, fa.lattice_scores,
                                             fa.viterbi_from_scores)

    def current():
        if not probe["batches"] or not probe["batches"][-1]["open"]:
            probe["batches"].append({"scores": [], "host_ms": 0.0, "open": True})
        return probe["batches"][-1]

    def align(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = current()
        out = real_align(*a, **kw)
        torch.cuda.synchronize()
        b.update(ms=1e3 * (time.perf_counter() - t0), open=False)
        return out

    def scores(*a, **kw):
        null, emit = real_scores(*a, **kw)
        lens = (torch.as_tensor(a[2]).cpu(), torch.as_tensor(a[5]).cpu())  # f_lens, token_lens
        current()["scores"].append((null.cpu(), emit.cpu(), *lens))
        return null, emit

    def viterbi(*a, **kw):
        t0 = time.perf_counter()
        out = real_viterbi(*a, **kw)
        b = current()
        b["host_ms"] += 1e3 * (time.perf_counter() - t0)
        b["frames"] = out
        return out

    with contextlib.ExitStack() as patches:
        for name, fn in (("viterbi_alignment", align), ("lattice_scores", scores),
                         ("viterbi_from_scores", viterbi)):
            patches.enter_context(mock.patch.object(fa, name, fn))
        yield probe


def gt_ctm_run(argv: list, plain: bool = False) -> dict:
    """python -m caiman_asr_tpu_torch.latency.generate_gt_ctm on ``argv``, with
    the kernels or under plain_path(): its probe, launches, wall s and CTM."""
    import torch

    from caiman_asr_tpu_torch.latency import generate_gt_ctm

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with align_probes() as probe, (plain_path() if plain else contextlib.nullcontext()):
        generate_gt_ctm.main(argv)
    wall = time.perf_counter() - t0
    out = Path(argv[argv.index("--output_ctm") + 1])
    torch.cuda.empty_cache()
    return {"probe": probe, "counts": read_counts(), "wall_s": wall, "ctm": out.read_text()}


def compare_alignments(got: dict, want: dict) -> dict:
    """Two generate_gt_ctm runs of the same utterances: the largest lattice
    score difference over every valid (t, u), the frames equal or, where a
    tie flips them, the two paths' scores on ``want``'s lattice within
    LT_SCORE_TOL."""
    import numpy as np

    from caiman_asr_tpu_torch.latency.forced_align import path_score

    err, flipped, tie_err = 0.0, 0, 0.0
    for bg, bw in zip(got["probe"]["batches"], want["probe"]["batches"], strict=True):
        for (gn, ge, fl, tl), (wn, we, _, _) in zip(bg["scores"], bw["scores"], strict=True):
            for b in range(gn.shape[0]):
                T, U = int(fl[b]), int(tl[b])
                err = max(err, float((gn[b, :T, : U + 1] - wn[b, :T, : U + 1]).abs().max()),
                          float((ge[b, :T, :U] - we[b, :T, :U]).abs().max()) if U else 0.0)
        for b, (fg, fw) in enumerate(zip(bg["frames"], bw["frames"], strict=True)):
            if not np.array_equal(fg, fw):
                flipped += 1
                wn, we, fl, _ = bw["scores"][-1]
                T = int(fl[b])
                nb, eb = wn[b].double().numpy(), we[b].double().numpy()
                tie_err = max(tie_err, abs(path_score(nb, eb, fg, T) - path_score(nb, eb, fw, T)))
    return {"max_score_err": err, "utterances_flipped": flipped, "tie_score_err": tie_err}


def write_long_utterance(root: Path, work: Path) -> str:
    """The phase-14 utterances joined into one (81 s), with their transcripts
    joined, as ``long.json`` beside them: past a minute, so that
    generate_gt_ctm --segment_len 1 encodes it as two segments."""
    import wave

    import numpy as np

    entries = json.loads((root / "manifest.json").read_text())
    pcm = []
    for e in entries:
        with wave.open(str(root / e["files"][0]["fname"])) as w:
            pcm.append(np.frombuffer(w.readframes(w.getnframes()), np.int16))
    audio = np.concatenate(pcm)
    with wave.open(str(work / "long.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(audio.tobytes())
    (work / "long.json").write_text(json.dumps([{
        "transcript": " ".join(e["transcript"] for e in entries),
        "files": [{"fname": str(work / "long.wav"), "duration": len(audio) / SR}],
        "original_duration": len(audio) / SR}]))
    return str(work / "long.json")


def latency_chain(name: str, cfg: Path, ckpt: Path, data: Path, manifest: str, work: Path,
                  extra: list) -> dict:
    """generate_gt_ctm -> val.py --dump_ctm --calculate_emission_latency
    --gt_ctm -> measure_latency on one model: measure_latency's mean and
    median emission latency against val.py's own."""
    from caiman_asr_tpu_torch import val
    from caiman_asr_tpu_torch.latency import generate_gt_ctm, measure_latency
    from caiman_asr_tpu_torch.models.config import load_config

    c = load_config(cfg)
    fw = (c.input_val.logmel.window_stride * c.input_val.splicing.frame_subsampling
          * c.rnnt.enc_stack_time_factor)
    gt = work / f"{name}_gt.ctm"
    t0 = time.perf_counter()
    generate_gt_ctm.main(["--model_config", str(cfg), "--ckpt", str(ckpt), "--dataset_dir",
                          str(data), "--manifests", manifest, "--output_ctm", str(gt)] + extra)
    gt_s = time.perf_counter() - t0
    out = work / f"{name}_val"
    res = val.validate(val.val_arg_parser().parse_args(
        ["--model_config", str(cfg), "--ckpt", str(ckpt), "--dataset_dir", str(data),
         "--val_manifests", manifest, "--output_dir", str(out), "--dump_ctm",
         "--calculate_emission_latency", "--gt_ctm", str(gt), "--skip_ngram"] + extra))
    metrics = measure_latency.main(measure_latency.parse_args(
        ["--gt_ctm", str(gt), "--model_ctm", str(out / "model.ctm"), "--frame_width", str(fw)]))
    lm = res.latency_metrics
    agree = (lm["n"] == 0 and "mean-emission-latency" not in metrics) or (
        abs(metrics["mean-emission-latency"] - lm["mean"]) <= 1e-9
        and abs(metrics["median-emission-latency"] - lm["median"]) <= 1e-9)
    log(f"  emission latency, {name}: ground truth {len(gt.read_text().splitlines())} words "
        f"({gt_s:.2f} s), dev WER {res.wer:.4f}; val.py's latency {json.dumps(lm)}; "
        f"measure_latency {json.dumps(metrics)}; mean and median equal: {agree}")
    if not agree or not gt.read_text().strip():
        raise AssertionError(f"{name}: measure_latency {metrics} against val.py's {lm}")
    return {"val": lm, "measure_latency": metrics, "wer": res.wer, "gt_words":
            len(gt.read_text().splitlines()), "gt_s": gt_s}


def run_latency_tools() -> dict:
    """Phase 17: the ground-truth CTM on the card (K1 counted, the lattice
    scores and alignments against the plain path, --segment_len against the
    whole utterance), emission latency end to end, val_multiple, the .pt
    export and import, and --read_from_tar in spm_train and
    generate_mel_stats."""
    import shutil

    import numpy as np
    import torch

    from caiman_asr_tpu_torch import offline, val, val_multiple
    from caiman_asr_tpu_torch.data import generate_mel_stats, spm_train
    from caiman_asr_tpu_torch.export import torch_export, torch_import
    from caiman_asr_tpu_torch.export.checkpointer import (flatten_named, load_checkpoint,
                                                          save_checkpoint)
    from caiman_asr_tpu_torch.models.config import load_config

    t_phase = time.perf_counter()
    root = REPO / "build" / "smoke" / "val"  # phase 14's workspace
    work = REPO / "build" / "smoke" / "latency"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg_path = REPO / VAL_CONFIG
    cfg = load_config(cfg_path)
    enc_layers = cfg.rnnt.enc_pre_rnn_layers + cfg.rnnt.enc_post_rnn_layers
    per_batch = enc_layers + cfg.rnnt.pred_rnn_layers
    tok = ["--tokenizer_model", str(REPO / "build" / "smoke" / "tokenizer.json")]
    mel = ["--mel_stats_path", str(root / "mel_stats.npz")]
    n_utts = len(json.loads((root / "manifest.json").read_text()))
    batches = -(-n_utts // LT_B)
    out = {"card": card()}

    # (a) generate_gt_ctm, fp32, B=8: kernels and plain path
    gt_argv = ["--model_config", str(cfg_path), "--ckpt", str(root / "ckpt.npz"),
               "--dataset_dir", str(root), "--manifests", "manifest.json",
               "--batch_size", str(LT_B)] + tok + mel
    k = gt_ctm_run(gt_argv + ["--output_ctm", str(work / "gt.ctm")])
    p = gt_ctm_run(gt_argv + ["--output_ctm", str(work / "gt_plain.ctm")], plain=True)
    cmp = compare_alignments(k, p)
    expect = {"lstm_recurrence": batches * per_batch}
    counts = {n: v for n, v in k["counts"].items() if v}
    bms = [b["ms"] for b in k["probe"]["batches"]]
    hms = [b["host_ms"] for b in k["probe"]["batches"]]
    log(f"  generate_gt_ctm, base-85M fp32, {n_utts} utterances in {batches} batches of "
        f"{LT_B}: launches {counts} (expected {expect}: {enc_layers} K1 the encoder and "
        f"{cfg.rnnt.pred_rnn_layers} the predictor a batch); lattice scores against the plain "
        f"path's largest difference {cmp['max_score_err']:.3g} (tol {LT_SCORE_TOL}); "
        f"alignments flipped {cmp['utterances_flipped']} (a tie's score difference "
        f"{cmp['tie_score_err']:.3g}); CTM equal to the plain path's: {k['ctm'] == p['ctm']}; "
        f"ms a batch {[round(x, 1) for x in bms]}, of it the host's Viterbi "
        f"{[round(x, 1) for x in hms]}, the device's rest "
        f"{[round(a - b, 1) for a, b in zip(bms, hms)]}; run {k['wall_s']:.2f} s "
        f"(plain {p['wall_s']:.2f} s) on {card()}")
    if counts != expect:
        raise AssertionError(f"generate_gt_ctm launches {counts}, expected {expect}")
    if (cmp["max_score_err"] > LT_SCORE_TOL or cmp["tie_score_err"] > LT_SCORE_TOL
            or len(k["ctm"].splitlines()) != len(p["ctm"].splitlines())):
        raise AssertionError(f"generate_gt_ctm against the plain path: {cmp}")
    out["gt_ctm"] = {**cmp, "launches": counts, "batch_ms": bms, "host_viterbi_ms": hms,
                     "device_ms": [a - b for a, b in zip(bms, hms)], "wall_s": k["wall_s"],
                     "ctm_equal_plain": k["ctm"] == p["ctm"],
                     "words": len(k["ctm"].splitlines())}

    # --segment_len 1 on one 81 s utterance: two segments, the whole utterance's CTM
    long = write_long_utterance(root, work)
    long_argv = ["--model_config", str(cfg_path), "--ckpt", str(root / "ckpt.npz"),
                 "--dataset_dir", str(work), "--manifests", long] + tok + mel
    whole = gt_ctm_run(long_argv + ["--output_ctm", str(work / "long_whole.ctm")])
    seg = gt_ctm_run(long_argv + ["--output_ctm", str(work / "long_seg.ctm"),
                                  "--segment_len", "1"])
    feat_s = cfg.input_val.logmel.window_stride * cfg.input_val.splicing.frame_subsampling
    long_s = json.loads((work / "long.json").read_text())[0]["original_duration"]
    n_seg = -(-int(long_s / feat_s) // int(round(60.0 / feat_s)))
    seg_expect = {"lstm_recurrence": n_seg * enc_layers + cfg.rnnt.pred_rnn_layers}
    seg_counts = {n: v for n, v in seg["counts"].items() if v}
    seg_cmp = compare_alignments(seg, whole)
    log(f"  --segment_len 1 on one {long_s:.2f} s utterance ({n_seg} segments carrying the "
        f"LSTM state): CTM equal to the whole utterance's: {seg['ctm'] == whole['ctm']} "
        f"({len(seg['ctm'].splitlines())} words); launches {seg_counts} (expected "
        f"{seg_expect}), whole {dict((n, v) for n, v in whole['counts'].items() if v)}; "
        f"{seg['wall_s']:.2f} s against {whole['wall_s']:.2f} s, host Viterbi "
        f"{seg['probe']['batches'][0]['host_ms']:.1f} ms")
    if seg["ctm"] != whole["ctm"] or seg_counts != seg_expect:
        raise AssertionError(f"the segmented alignment differs from the whole: {seg_cmp}")
    out["segment_len"] = {"ctm_equal": True, "segments": n_seg, "launches": seg_counts,
                          "seconds": long_s, "wall_s": seg["wall_s"],
                          "whole_wall_s": whole["wall_s"]}

    # (b) emission latency end to end: the random base model, then the trained one
    out["latency"] = {"base-85M": latency_chain(
        "base", cfg_path, root / "ckpt.npz", root, "manifest.json", work, tok + mel)}
    e2e = REPO / "build" / "smoke" / "e2e"
    e2e_ckpt = e2e / "out" / "ckpts" / "best.npz"
    if e2e_ckpt.exists():
        out["latency"]["synthetic_e2e"] = latency_chain(
            "synthetic_e2e", e2e / "cfg.yaml", e2e_ckpt, e2e, "dev.json", work,
            ["--mel_stats_path", str(e2e / "mel_stats.npz")])
    else:
        log(f"  emission latency, synthetic_e2e: not run ({e2e_ckpt} not found)")
    torch.cuda.empty_cache()

    # (c) val_multiple: two checkpoints x two manifests, --calc_loss
    entries = json.loads((root / "manifest.json").read_text())
    (root / "short.json").write_text(json.dumps(entries[:LT_SHORT]))
    ckpts = work / "ckpts"
    ckpts.mkdir()
    shutil.copy(root / "ckpt.npz", ckpts / "a.npz")
    params, _, _, meta = load_checkpoint(root / "ckpt.npz")
    save_checkpoint(ckpts / "b.npz", params, params, meta=meta)  # EMA = the raw weights
    manifests = [(root, "manifest.json"), (root, "short.json")]
    vm_argv = ["--model_config", str(cfg_path), "--ckpt_glob", str(ckpts / "*.npz"),
               "--all_dataset_dirs", *[str(d) for d, _ in manifests],
               "--all_val_manifests", *[m for _, m in manifests],
               "--val_batch_size", str(VAL_BATCH), "--calc_loss", "--dump_preds",
               "--skip_ngram", "--output_dir", str(work / "vm")] + tok + mel
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rows = val_multiple.main(vm_argv)
    vm_s = time.perf_counter() - t0
    vm_counts = {n: v for n, v in read_counts().items() if v}
    jobs = [(c, d, m) for c in sorted(ckpts.glob("*.npz")) for d, m in manifests]
    vm_batches = sum(-(-len(json.loads((Path(d) / m).read_text())) // VAL_BATCH)
                     for _, d, m in jobs)
    vm_expect = {"lstm_recurrence": vm_batches * (enc_layers + per_batch),
                 "joint_fwd": vm_batches}
    mismatched = []
    for c, d, m in jobs:
        label = f"{c}::{Path(d) / m}"
        sub = work / "vm" / Path(m).with_suffix("").name / c.with_suffix("").name
        one = val.validate(val.val_arg_parser().parse_args(
            ["--model_config", str(cfg_path), "--ckpt", str(c), "--dataset_dir", str(d),
             "--val_manifests", m, "--val_batch_size", str(VAL_BATCH), "--calc_loss",
             "--skip_ngram", "--output_dir", str(work / "one" / c.stem / Path(m).stem)]
            + tok + mel))
        hyps = [x["hyp"] for x in json.loads(
            (sub / "preds" / "preds_step0.json").read_text())["predictions"]]
        row = rows[label]
        if (row["wer"] != one.wer or hyps != one.hyps
                or abs(row["loss"] - one.loss) > LT_LOSS_RTOL * abs(one.loss)):
            mismatched.append((label, row, one.wer, one.loss))
    log(f"  val_multiple, {len(jobs) // len(manifests)} checkpoints x {len(manifests)} manifests, --calc_loss: "
        + "; ".join(f"{Path(l.split('::')[0]).name} {Path(l.split('::')[1]).name}: WER "
                    f"{r['wer']:.4f}, loss {r['loss']:.4f}" for l, r in rows.items())
        + f"; each row's WER and hypotheses equal a separate val.validate run's, its loss "
        f"within {LT_LOSS_RTOL}: {not mismatched}; launches {vm_counts} (expected "
        f"{vm_expect}); {vm_s:.2f} s, {1e3 * vm_s / len(jobs):.1f} ms a job on {card()}")
    if mismatched or vm_counts != vm_expect or len(rows) != len(jobs):
        raise AssertionError(f"val_multiple: {mismatched}, launches {vm_counts}")
    out["val_multiple"] = {"rows": rows, "launches": vm_counts, "wall_s": vm_s,
                           "ms_a_job": 1e3 * vm_s / len(jobs), "jobs": len(jobs)}
    torch.cuda.empty_cache()

    # (d) the reference .pt export and import, and the port transcribing from the .pt
    pt, back = work / "base.pt", work / "back.npz"
    t0 = time.perf_counter()
    torch_export.main([str(root / "ckpt.npz"), str(pt)])
    torch_import.main([str(pt), str(back)])
    conv_s = time.perf_counter() - t0
    a, b = load_checkpoint(root / "ckpt.npz"), load_checkpoint(back)
    unequal = [f"{w}/{n}" for w, x, y in (("params", a[0], b[0]), ("ema", a[1], b[1]))
               for n, v in flatten_named(x).items()
               if not np.array_equal(v, flatten_named(y)[n])]
    from caiman_asr_tpu_torch.export.checkpointer import apply_params
    from caiman_asr_tpu_torch.setup import builders

    tokenizer = builders.build_tokenizer(cfg, tok[1], sampling=0.0)
    m_npz, _ = builders.build_model(cfg, tokenizer, device="cuda")
    apply_params(m_npz.param_tree(), a[1])
    m_pt, _ = builders.build_model(cfg, tokenizer, device="cuda")
    info = torch_import.load_into(m_pt, str(pt))
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig

    audio, lens = synthetic_audio(SEED)  # phase 3's utterances, through its pipeline
    audio, lens = torch.from_numpy(audio).cuda(), torch.from_numpy(lens).cuda()
    pipe = PipelineConfig(logmel=LogMelConfig(dither=0.0))
    toks = [tokens(offline.transcribe(m.eval(), audio, lens, device="cuda", pipeline=pipe))
            for m in (m_npz, m_pt)]
    log(f"  torch_export then torch_import of the base-85M checkpoint: {len(unequal)} leaves "
        f"differ of the params' and EMA's (the .npz back to the bit: {not unequal}), "
        f"{conv_s:.2f} s; the .pt's {info['weights']} loaded by the port transcribes the "
        f"{N_UTTS} utterances to the same tokens as the .npz's EMA: {toks[0] == toks[1]} "
        f"({sum(map(len, toks[0]))} tokens)")
    if unequal or toks[0] != toks[1] or not any(toks[0]):
        raise AssertionError(f"the .pt round trip: {unequal[:4]}, tokens equal "
                             f"{toks[0] == toks[1]}")
    out["pt"] = {"bit_equal": True, "same_tokens": True, "tokens": sum(map(len, toks[0])),
                 "convert_s": conv_s}
    del m_npz, m_pt
    torch.cuda.empty_cache()

    # (e) --read_from_tar on phase 16's dev shards against the same manifest
    shards = sorted(str(p) for p in (REPO / "build" / "smoke" / "multihost" /
                                     "val_tar").glob("*.tar"))
    cli_root = REPO / "build" / "smoke" / "train_cli"  # the shards' utterances
    t0 = time.perf_counter()
    spm_train.main(["--read_from_tar", "--tar_files", *shards, "--vocab_size", "200",
                    "--output_prefix", str(work / "spm_tar")])
    spm_train.main(["--manifests", "manifest.json", "--dataset_dir", str(cli_root),
                    "--vocab_size", "200", "--output_prefix", str(work / "spm_manifest")])
    generate_mel_stats.main(["--model_config", str(cfg_path), "--read_from_tar",
                             "--tar_files", *shards, "--output_path",
                             str(work / "mel_tar.npz")])
    generate_mel_stats.main(["--model_config", str(cfg_path), "--dataset_dir", str(cli_root),
                             "--manifests", "manifest.json", "--output_path",
                             str(work / "mel_manifest.npz")])
    tar_s = time.perf_counter() - t0
    spm_equal = all((work / f"spm_tar.{e}").read_bytes()
                    == (work / f"spm_manifest.{e}").read_bytes() for e in ("json", "model"))
    with np.load(work / "mel_tar.npz") as x, np.load(work / "mel_manifest.npz") as y:
        mel_err = max(float(np.max(np.abs(x[n] - y[n]) / np.abs(y[n])))
                      for n in ("melmeans", "melvars"))
    log(f"  --read_from_tar on {len(shards)} dev shard(s) of phase 16 against the manifest of "
        f"the same utterances: spm_train's vocab byte-equal {spm_equal}; generate_mel_stats' "
        f"largest relative difference {mel_err:.3g}; {tar_s:.2f} s")
    if not shards or not spm_equal or mel_err > 1e-6:
        raise AssertionError(f"--read_from_tar: spm equal {spm_equal}, mel {mel_err}")
    out["read_from_tar"] = {"spm_equal": True, "mel_rel_err": mel_err, "shards": len(shards)}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 17 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 18
# The rest of inference: the n-gram tools, the kenlm formats, the beam over
# worker processes, the scale sweep and the FPGA arithmetic (quantize: true),
# on phase 14's workspace and checkpoint and phase 15's synthetic_e2e model.
LM_ORDER = 3
LM_BEAM_MSYM = 8          # the fast beam's expansion trips (the beams' own default)
LM_SCALE = "0.5"          # the fusion scale of (a)
LM_SCORE_TOL = 1e-6       # a binary stores log10 in fp32: its scores against the ARPA's
PAR_PROCS = 2             # --beam_parallel_procs
PAR_UTTS = 2              # the shortest utterances: the host beam on a random base-85M is slow,
                          # and so is the quantized encoder and greedy loop on the CPU
SWEEP_SCALES = ("0.0", "0.3", "0.6")
# The quantized encoder on the card against the CPU, on the QUANT_UTTS
# shortest utterances. Its LSTM output lies on the brain-float grid: another
# order of the fp32 sums breaks a tie the other way now and then, one
# brain-float ulp, carried into later frames (on an H100: 99.9933% of the
# entries bit-equal, the rest 1 ulp apart). f = joint_enc(LSTM output) in
# fp32 adds its own order of sums (that run: max 3.825e-06, mean 1.34e-07;
# the limits are about 5x and 7x).
QUANT_LSTM_EQUAL_SHARE = 0.999       # of the LSTM output's entries, bit-equal
QUANT_LSTM_MAX_ULPS = 1              # brain-float ulps, the rest
QUANT_F_MAX_TOL, QUANT_F_MEAN_TOL = 2e-5, 1e-6
# The unquantized model on the same weights: its f apart by a mean of
# 1.161e-04 in that run (the random model's small activations), so an
# encoder that skipped the quantizers would read ~1e-7 here
QUANT_VS_PLAIN_MIN_MEAN = 2e-5
QUANT_GRAPH_B = 64         # the quantized serving engine's lanes
# (d) on the shortest utterance of (b)'s two: its greedy loop costs 3.0-4.5
# ms an iteration in its graphs and the CPU's reference minutes more, and
# phase 19 brought the script past 1,100 s of its 1,200 with two
QUANT_UTTS = 1


def quantized_lstm_output(model, feats, feat_lens):
    """The quantized encoder's LSTM output [B, T', H] before ``joint_enc``:
    the calls of ``RNNT._encode`` (pre_rnn, stack-time, post_rnn) up to it."""
    from caiman_asr_tpu_torch.ops.features import stack_time
    from caiman_asr_tpu_torch.ops.lstm import run_lstm

    p, cfg = model.param_tree(), model.cfg
    kw = dict(hard=cfg.hard_activations, quantize=True)
    out, _, _ = run_lstm(p["encoder"]["pre_rnn"], feats, **kw)
    out, _ = stack_time(out, feat_lens, cfg.enc_stack_time_factor)
    out, _, _ = run_lstm(p["encoder"]["post_rnn"], out, **kw)
    return out.transpose(0, 1)


def lm_formats(root: Path, work: Path) -> dict:
    """(a)'s LM: a 3-gram over phase 14's transcripts tokenised by the smoke
    tokenizer (train_ngram's estimate and writer; the transcripts' digits
    are the pieces, so main's normalisation to the letters would drop them),
    then written as a PROBING and a TRIE binary. Returns the three paths and
    the checks of their scores."""
    from caiman_asr_tpu_torch.data.tokenizer import Tokenizer
    from caiman_asr_tpu_torch.lm import kenlm_binary, kenlm_trie, train_ngram
    from caiman_asr_tpu_torch.lm.ngram import NGramLM

    tok = Tokenizer(list(" abcdefghijklmnopqrstuvwxyz'"),
                    REPO / "build" / "smoke" / "tokenizer.json")
    texts = [e["transcript"] for e in json.loads((root / "manifest.json").read_text())]
    sentences = [[tok.id_to_piece(i) for i in tok.tokenize(t)] for t in texts]
    t0 = time.perf_counter()
    arpa = train_ngram.train_ngram_from_sentences(sentences, LM_ORDER, work / "ngram")
    train_s = time.perf_counter() - t0
    lm = NGramLM.load(arpa)
    paths = {"arpa": arpa, "probing": work / "probing.binary", "trie": work / "trie.binary"}
    kenlm_binary.write_kenlm_binary(lm, paths["probing"])
    kenlm_trie.write_kenlm_trie(lm, paths["trie"])
    loaded = {name: NGramLM.load(p) for name, p in paths.items()}
    dense = {name: (x if hasattr(x, "probs") else x.to_ngram_lm()) for name, x in loaded.items()}
    if type(loaded["probing"]).__name__ != "KenLMBinaryLM":
        raise AssertionError(f"the PROBING file loaded as {type(loaded['probing'])}")
    keys = set(lm.probs)
    errs = {}
    for name in ("probing", "trie"):
        d = dense[name]
        if set(d.probs) != keys:
            raise AssertionError(f"the {name} binary holds other n-grams than the ARPA")
        # a backoff of 0 is no backoff: the binaries keep none, the ARPA may list it
        errs[name] = max(max(abs(d.probs[k] - lm.probs[k]) for k in keys),
                         max((abs(d.backoffs.get(k, 0.0) - lm.backoffs.get(k, 0.0))
                              for k in set(lm.backoffs) | set(d.backoffs)), default=0.0))
    pb, tb = dense["probing"], dense["trie"]
    errs["probing_vs_trie"] = max(
        max(abs(pb.probs[k] - tb.probs[k]) for k in keys),
        max((abs(pb.backoffs.get(k, 0.0) - tb.backoffs.get(k, 0.0))
             for k in set(pb.backoffs) | set(tb.backoffs)), default=0.0))
    # the scorer the host beam uses, on every listed n-gram's context
    score_err = 0.0
    for ng in list(keys)[:2000]:
        ctx, w = ng[:-1], ng[-1]
        want = lm.score(w, ctx)[0]
        for name in ("probing", "trie"):
            score_err = max(score_err, abs(loaded[name].score(w, ctx)[0] - want))
    log(f"  3-gram over {len(sentences)} transcripts ({sum(map(len, sentences))} pieces) in "
        f"{train_s * 1e3:.1f} ms: {len(keys)} n-grams; PROBING {paths['probing'].stat().st_size} "
        f"and TRIE {paths['trie'].stat().st_size} bytes beside the ARPA's "
        f"{arpa.stat().st_size}; every n-gram in all three, scores apart by at most {errs} "
        f"(tol {LM_SCORE_TOL}: fp32 log10 on disk); conditional scores within "
        f"{score_err:.3g}")
    if max(errs.values()) > LM_SCORE_TOL or score_err > LM_SCORE_TOL:
        raise AssertionError(f"the kenlm binaries' scores: {errs}, {score_err}")
    return {"paths": paths, "dense": dense, "ngrams": len(keys), "score_err": errs,
            "conditional_err": score_err,
            "bytes": {n: p.stat().st_size for n, p in paths.items()}}


def run_lm_tools() -> dict:
    """Phase 18: (a) train_ngram, the kenlm binaries and fusion from each
    file; (b) val.py --beam_parallel_procs against the one-process host
    beam; (c) sweep_scale_factor on the synthetic_e2e model; (d) the
    quantized base-85M validated greedy, against the CPU, and its serving
    tick as a CUDA graph."""
    import shutil

    import numpy as np
    import torch

    from caiman_asr_tpu_torch import offline, val
    from caiman_asr_tpu_torch.data.tokenizer import piece_table
    from caiman_asr_tpu_torch.decoding import parallel
    from caiman_asr_tpu_torch.decoding.beam import RNNTBeamDecoder
    from caiman_asr_tpu_torch.export.checkpointer import apply_params, load_checkpoint
    from caiman_asr_tpu_torch.lm import sweep_scale_factor, train_ngram
    from caiman_asr_tpu_torch.lm.device_table import build_device_tables
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.ops import lstm as lstm_ops
    from caiman_asr_tpu_torch.serving.engine import StreamingEngine
    from caiman_asr_tpu_torch.setup import builders

    t_phase = time.perf_counter()
    root = REPO / "build" / "smoke" / "val"  # phase 14's workspace
    work = REPO / "build" / "smoke" / "lm_tools"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg_path = REPO / VAL_CONFIG
    cfg = load_config(cfg_path)
    enc_layers = cfg.rnnt.enc_pre_rnn_layers + cfg.rnnt.enc_post_rnn_layers
    tok_path = REPO / "build" / "smoke" / "tokenizer.json"
    base = ["--model_config", str(cfg_path), "--tokenizer_model", str(tok_path),
            "--ckpt", str(root / "ckpt.npz"), "--dataset_dir", str(root),
            "--mel_stats_path", str(root / "mel_stats.npz"), "--val_batch_size", str(VAL_BATCH)]
    entries = json.loads((root / "manifest.json").read_text())
    batches = -(-len(entries) // VAL_BATCH)
    out = {"card": card()}

    def validate(argv, name):
        args = val.val_arg_parser().parse_args(argv + ["--output_dir", str(work / name)])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = val.validate(args)
        torch.cuda.synchronize()
        return res, {n: v for n, v in read_counts().items() if v}, time.perf_counter() - t0

    # (a) the n-gram, its kenlm binaries, fusion from each file
    t_a = time.perf_counter()
    fmt = lm_formats(root, work)
    n_classes = MODELS["base-85M"][1]
    pieces = piece_table(builders.build_tokenizer(cfg, str(tok_path), sampling=0.0), n_classes)
    tables = {n: build_device_tables(d, pieces, skip_ids=[n_classes - 1])
              for n, d in fmt["dense"].items()}
    tab_equal = all(np.array_equal(tables["arpa"].next_state, t.next_state)
                    for t in tables.values())
    tab_err = max(float(np.abs(tables[a].score - tables[b].score).max())
                  for a, b in (("probing", "arpa"), ("trie", "arpa"), ("probing", "trie")))
    log(f"  device tables: {tables['arpa'].n_states} states x {n_classes} columns; transitions "
        f"equal: {tab_equal}, scores apart by at most {tab_err:.3g} across the three")
    if not tab_equal or tab_err > LM_SCORE_TOL:
        raise AssertionError("the device tables differ between the LM's files")
    fused = {}
    beam = ["--decoder", "fast_beam", "--beam_width", "4", "--max_symbols_per_step",
            str(LM_BEAM_MSYM), "--val_manifests", "manifest.json"]
    for name, path in list(fmt["paths"].items()) + [("none", None)]:
        lm_flags = (["--ngram_path", str(path), "--ngram_scale_factor", LM_SCALE] if path
                    else ["--skip_ngram"])
        fused[name] = validate(base + beam + lm_flags, f"fast_beam_{name}")
    hyps = {n: r[0].hyps for n, r in fused.items()}
    k1 = {n: r[1].get("lstm_recurrence", 0) for n, r in fused.items()}
    want_k1 = batches * enc_layers
    changed = sum(a != b for a, b in zip(hyps["arpa"], hyps["none"]))
    log(f"  fast beam (W=4, E={LM_BEAM_MSYM}), fp32, fusion at {LM_SCALE} from the ARPA, the "
        f"PROBING and the TRIE binary: hypotheses identical: "
        f"{hyps['arpa'] == hyps['probing'] == hyps['trie']} ({sum(map(bool, hyps['arpa']))} "
        f"non-empty, WER {fused['arpa'][0].wer:.6f}); fusion changes {changed} of "
        f"{len(entries)} hypotheses against no LM; K1 {k1} (predicted {want_k1} a run: "
        f"{enc_layers} a batch of {batches}); "
        + ", ".join(f"{n} {r[2]:.2f} s" for n, r in fused.items()))
    if not hyps["arpa"] == hyps["probing"] == hyps["trie"]:
        raise AssertionError("fusion from the kenlm binaries differs from the ARPA's")
    if any(v != want_k1 for v in k1.values()) or any(
            set(r[1]) - {"lstm_recurrence"} for r in fused.values()):
        raise AssertionError(f"the fused validations' launches: {[r[1] for r in fused.values()]}")
    out["a"] = {**{k: v for k, v in fmt.items() if k not in ("paths", "dense")},
                "states": tables["arpa"].n_states, "tables_equal": tab_equal,
                "table_err": tab_err, "hyps_identical": True, "changed_by_fusion": changed,
                "wer": {n: r[0].wer for n, r in fused.items()}, "k1": k1,
                "wall_s": {n: r[2] for n, r in fused.items()},
                "seconds": time.perf_counter() - t_a}

    # (b) the beam over worker processes against the one-process host beam
    t_b = time.perf_counter()
    shortest = sorted(range(len(entries)),
                      key=lambda i: entries[i]["files"][0]["duration"])[:PAR_UTTS]
    (work / "par.json").write_text(json.dumps([  # the audio where phase 14 wrote it
        dict(entries[i], files=[dict(f, fname=str(root / f["fname"]))
                                for f in entries[i]["files"]]) for i in sorted(shortest)]))
    captured = []
    orig = parallel.ParallelDecoder.decode_encs

    def capture(self, encs, enc_lens):
        res = orig(self, encs, enc_lens)
        captured.append((encs, enc_lens, res, self.nprocs))
        return res

    par_argv = base + ["--decoder", "beam", "--beam_width", "4",
                       "--val_manifests", str(work / "par.json"),
                       "--beam_parallel_procs", str(PAR_PROCS),
                       "--beam_min_decode_batch_size_per_proc", "1"]
    with mock.patch.object(parallel.ParallelDecoder, "decode_encs", capture):
        pres, pcounts, pwall = validate(par_argv, "parallel")
    if len(captured) != 1:
        raise AssertionError(f"the parallel decoder decoded {len(captured)} batches, not one")
    encs, enc_lens, par_resp, nprocs = captured[0]
    # the one-process host beam with the kwargs the workers got, on the
    # card's encoder outputs, on the CPU as the workers run it
    args = val.val_arg_parser().parse_args(par_argv)
    pcfg = load_config(cfg_path)
    ptok = builders.build_tokenizer(pcfg, str(tok_path))
    cpu_model, blank = builders.build_model(pcfg, ptok, device="cpu")
    cpu_model.eval()
    loaded, ema, _, _ = load_checkpoint(root / "ckpt.npz")
    apply_params(cpu_model.param_tree(), ema if ema is not None else loaded)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    try:
        t0 = time.perf_counter()
        ref = RNNTBeamDecoder(cpu_model, blank, ptok, **val.parallel_decoder_kwargs(args)
                              ).decode_encs(encs, enc_lens)
        ref_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    got_toks, ref_toks = tokens(par_resp), tokens(ref)
    frames = [int(x) for x in enc_lens]
    syms = sum(map(len, ref_toks))
    log(f"  val.py --decoder beam --beam_parallel_procs {PAR_PROCS} on the {PAR_UTTS} shortest "
        f"utterances ({frames} encoder frames): {pwall:.2f} s, WER {pres.wer:.6f}, K1 "
        f"{pcounts.get('lstm_recurrence', 0)} (predicted {enc_layers}: the parent's encoder; "
        f"the workers run on the CPU); the one-process host beam on the CPU with the workers' "
        f"kwargs {val.parallel_decoder_kwargs(args)} in {ref_s:.2f} s: tokens identical "
        f"{got_toks == ref_toks} ({syms} symbols, {syms / max(1, sum(frames)):.2f} a frame)")
    if got_toks != ref_toks:
        raise AssertionError("the worker beam differs from the one-process host beam")
    if pcounts != {"lstm_recurrence": enc_layers}:
        raise AssertionError(f"the parallel validation's launches: {pcounts}")
    out["b"] = {"utterances": PAR_UTTS, "frames": frames, "wall_s": pwall, "ref_s": ref_s,
                "wer": pres.wer, "launches": pcounts, "tokens_identical": True,
                "symbols": syms, "seconds": time.perf_counter() - t_b}
    del cpu_model

    # (c) the scale sweep on phase 15's synthetic_e2e model
    t_c = time.perf_counter()
    e2e = REPO / "build" / "smoke" / "e2e"
    train_ngram.main(["--manifests", "train.json", "--dataset_dir", str(e2e),
                      "--tokenizer_model", str(e2e / "tok.json"), "--order", str(LM_ORDER),
                      "--output_dir", str(work / "e2e_ngram")])
    e2e_argv = ["--model_config", str(e2e / "cfg.yaml"), "--dataset_dir", str(e2e),
                "--val_manifests", "dev.json", "--ckpt", str(e2e / "out" / "ckpts" / "best.npz"),
                "--mel_stats_path", str(e2e / "mel_stats.npz"), "--beam_width", "4"]
    torch.cuda.synchronize()
    reset_counts()
    sweep = sweep_scale_factor.main(e2e_argv + [
        "--output_dir", str(work / "sweep"), "--ngram_path",
        str(work / "e2e_ngram" / "ngram.arpa"), "--scales", *SWEEP_SCALES])
    torch.cuda.synchronize()
    scounts = {n: v for n, v in read_counts().items() if v}
    no_lm, _, _ = validate(e2e_argv + ["--decoder", "beam", "--skip_ngram"], "sweep_no_lm")
    log(f"  sweep_scale_factor on the {E2E_STEPS}-step synthetic_e2e model, host beam W=4: "
        + ", ".join(f"scale {r['scale']}: WER {r['wer']:.6f}" for r in sweep)
        + f"; without the LM {no_lm.wer:.6f}; launches {scounts} "
        f"({time.perf_counter() - t_c:.2f} s)")
    if [r["scale"] for r in sweep] != [float(s) for s in SWEEP_SCALES] or not all(
            np.isfinite(r["wer"]) for r in sweep) or sweep[0]["wer"] != no_lm.wer:
        raise AssertionError(f"the sweep: {sweep}, without the LM {no_lm.wer}")
    out["c"] = {"results": sweep, "no_lm_wer": no_lm.wer, "launches": scounts,
                "seconds": time.perf_counter() - t_c}

    # (d) the quantized base-85M: greedy validation, the CPU, the serving tick
    t_d = time.perf_counter()
    qcfg_path = work / "base-quantized.yaml"
    text = cfg_path.read_text()
    if text.count("\n  quantize: false") != 1:
        raise AssertionError(f"{cfg_path} does not set rnnt.quantize once")
    qcfg_path.write_text(text.replace("\n  quantize: false", "\n  quantize: true"))
    qcfg = load_config(qcfg_path)
    if not qcfg.rnnt.quantize:
        raise AssertionError("the quantized config does not reach the model")
    qbase = [a if a != str(cfg_path) else str(qcfg_path) for a in base]
    # (b)'s shortest utterances: all 16 took 47-79 s on an H100 (the greedy
    # loop's quantizers, 3.0-4.7 ms an iteration in its graphs), which
    # brought the script near its 1,200 s
    (work / "quant.json").write_text(json.dumps(
        json.loads((work / "par.json").read_text())[:QUANT_UTTS]))
    greedy = ["--val_manifests", str(work / "quant.json"), "--skip_ngram"]
    # each layer's weights are quantized once after the load, whatever
    # runs them after: the encoder's scan, the greedy loop's graphs
    lstm_layers = enc_layers + cfg.rnnt.pred_rnn_layers
    quantized_layers = []
    real_quantize = lstm_ops._quantize_layer

    def counted(p, dtype):
        quantized_layers.append(dtype)
        return real_quantize(p, dtype)

    with val_probes(cfg.rnnt.enc_stack_time_factor) as qprobe, mock.patch.object(
            lstm_ops, "_quantize_layer", counted):
        qres, qcounts, qwall = validate(qbase + greedy, "quantized")
    fres, fcounts, fwall = validate(base + greedy, "unquantized")
    same_f = sum(a == b for a, b in zip(qres.hyps, fres.hyps))
    qdec = qprobe["decode"]
    log(f"  quantize: true, greedy, {QUANT_UTTS} utterance(s): {qwall:.2f} s (unquantized "
        f"{fwall:.2f} s), the decoder (encoder and greedy loop) "
        f"{sum(d['ms'] for d in qdec) / 1e3:.2f} s over {len(qdec)} batches, "
        f"{sum(d['symbols'] for d in qdec)} symbols; WER {qres.wer:.6f} (unquantized "
        f"{fres.wer:.6f}), {sum(map(bool, qres.hyps))} non-empty; launches {qcounts} "
        f"(predicted none: the quantized scan bypasses K1), unquantized {fcounts}; layers "
        f"quantized {len(quantized_layers)} (the model's {lstm_layers}, once each); "
        f"hypotheses equal to the unquantized run's {same_f}/{QUANT_UTTS}")
    if qcounts or not any(qres.hyps) or len(qres.hyps) != QUANT_UTTS:
        raise AssertionError(f"the quantized validation launched {qcounts}")
    if quantized_layers != [torch.float32] * lstm_layers:
        raise AssertionError(f"the validation quantized {quantized_layers}, not each of "
                             f"{lstm_layers} layers once")
    # the encoder and greedy on the card against the CPU, (b)'s shortest
    # utterances; and the unquantized model on the card, on the same weights
    qtok = builders.build_tokenizer(qcfg, str(tok_path), sampling=0.0)
    models = {}
    for name, c in (("card", qcfg), ("cpu", qcfg), ("plain", cfg)):
        m, blank = builders.build_model(c, qtok, device="cpu" if name == "cpu" else "cuda")
        m.eval()
        apply_params(m.param_tree(), ema if ema is not None else loaded)
        models[name] = m
    _, fp = builders.build_feature_pipelines(qcfg, builders.load_mel_stats(
        str(root / "mel_stats.npz")), device="cuda")
    sel = json.loads((work / "quant.json").read_text())
    from caiman_asr_tpu_torch.data.audio import read_audio

    waves = [read_audio(root / e["files"][0]["fname"], SR) for e in sel]
    lens = np.array([len(w) for w in waves])
    audio = np.zeros((len(waves), int(lens.max())), np.float32)
    for i, w in enumerate(waves):
        audio[i, :len(w)] = w
    with torch.inference_mode():
        feats, feat_lens = fp(torch.from_numpy(audio).cuda(), torch.from_numpy(lens).cuda(),
                              dataset_to_utt_ratio=1.0)
        enc, lstm_out, toks, decs = {}, {}, {}, {}
        for name, m in models.items():
            dev = "cpu" if name == "cpu" else "cuda"
            f, fl, _ = m.encode(feats.to(dev), feat_lens.to(dev))
            enc[name] = (f.float().cpu(), fl.cpu())
            dec = decs[name] = (offline.build_decoder(m, "greedy", tokenizer=qtok), f, fl)
            if name == "plain":
                continue
            lstm_out[name] = quantized_lstm_output(m, feats.to(dev), feat_lens.to(dev)).cpu()
            toks[name] = [list(t[:int(n)]) for t, n in zip(*[np.asarray(x) for x in
                                                            dec[0].decode_encs(f, fl)[0::3]])]
        # the card's greedy loop, quantized and not, its graphs captured by
        # a first call: ms an iteration
        decs["plain"][0].decode_encs(*decs["plain"][1:])
        loop_ms = {}
        for name in ("card", "plain"):
            dec, f, fl = decs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.decode_encs(f, fl)
            torch.cuda.synchronize()
            loop_ms[name] = (1e3 * (time.perf_counter() - t0), dec.last_run["iters"],
                             dec.last_run["graph"])
    valid = torch.arange(enc["cpu"][0].shape[1])[None, :] < enc["cpu"][1][:, None]
    d = (enc["card"][0] - enc["cpu"][0]).abs()[valid]
    d_plain = (enc["plain"][0] - enc["card"][0]).abs()[valid]
    hq, hc = lstm_out["card"][valid].view(torch.int32), lstm_out["cpu"][valid].view(torch.int32)
    h_equal = float((hq == hc).float().mean())
    # on the brain-float grid, the top 16 bits are the brain-float's: their
    # distance counts ulps where the signs agree (else 2^15 or more)
    h_ulps = int(((hq >> 16) - (hc >> 16)).abs().max())
    same_cpu = sum(a == b for a, b in zip(toks["card"], toks["cpu"]))
    log(f"  the quantized encoder on the card against the CPU ({QUANT_UTTS} utterance(s), "
        f"{int(valid.sum())} frames): LSTM output {h_equal:.6f} of entries bit-equal (limit "
        f"{QUANT_LSTM_EQUAL_SHARE}), the rest within {h_ulps} brain-float ulps (limit "
        f"{QUANT_LSTM_MAX_ULPS}); "
        f"f max |diff| {float(d.max()):.4g}, mean {float(d.mean()):.4g} (limits "
        f"{QUANT_F_MAX_TOL} / {QUANT_F_MEAN_TOL}), entries equal "
        f"{float((d == 0).float().mean()):.4f}; the unquantized model's f on the same weights "
        f"apart by mean {float(d_plain.mean()):.4g}, max {float(d_plain.max()):.4g} (at least "
        f"{QUANT_VS_PLAIN_MIN_MEAN}); greedy tokens equal to the CPU's {same_cpu}/{len(sel)} "
        f"({sum(map(len, toks['cpu']))} tokens on the CPU); the card's greedy loop, its "
        f"graphs captured: quantized {loop_ms['card'][0]:.1f} ms for {loop_ms['card'][1]} "
        f"iterations ({loop_ms['card'][0] / max(1, loop_ms['card'][1]):.3f} ms each, graph "
        f"{loop_ms['card'][2]}), unquantized {loop_ms['plain'][0]:.1f} ms for "
        f"{loop_ms['plain'][1]} ({loop_ms['plain'][0] / max(1, loop_ms['plain'][1]):.3f} ms)")
    if not (h_equal >= QUANT_LSTM_EQUAL_SHARE and h_ulps <= QUANT_LSTM_MAX_ULPS
            and float(d.max()) <= QUANT_F_MAX_TOL and float(d.mean()) <= QUANT_F_MEAN_TOL
            and torch.equal(enc["card"][1], enc["cpu"][1])):
        raise AssertionError("the quantized encoder on the card differs from the CPU's")
    if not float(d_plain.mean()) >= QUANT_VS_PLAIN_MIN_MEAN:
        raise AssertionError("the quantized encoder on the card equals the unquantized one")
    if same_cpu != len(sel):
        raise AssertionError(f"quantized greedy on the card: {same_cpu}/{len(sel)} "
                             "hypotheses equal to the CPU's")
    # a bf16 serving engine with the quantized model, streaming the same
    # utterances (cut to whole 60 ms chunks): the graph against eager
    from caiman_asr_tpu_torch import bench_serving

    mel_stats = builders.load_mel_stats(str(root / "mel_stats.npz"))
    slens = lens // 960 * 960
    streamed = {}
    for graph in (True, False):
        eng = StreamingEngine(models["card"], blank, bench_serving.bench_tokenizer(n_classes),
                              mel_stats, max_streams=QUANT_GRAPH_B, max_symbols_per_step=4,
                              dtype=torch.bfloat16, device="cuda", cuda_graph=graph)
        reset_counts()
        streamed[graph] = _stream_tokens(eng, audio, slens)
        streamed[graph, "packed"] = eng._native_ser.packed
        streamed[graph, "k1"] = read_counts()["lstm_recurrence"]
        streamed[graph, "state"] = [t.clone() for hc in eng.enc_state for t in hc] + list(
            eng.dec_state)
        streamed[graph, "captured"] = eng._graph is not None
        eng.close()
    equal = streamed[True] == streamed[False] and len(streamed[True, "packed"]) == len(
        streamed[False, "packed"]) and all(
        np.array_equal(a, b) and np.array_equal(aa, ba)
        for (a, aa), (b, ba) in zip(streamed[True, "packed"], streamed[False, "packed"])) and all(
        torch.equal(a, b) for a, b in zip(streamed[True, "state"], streamed[False, "state"]))
    emitted = sum(map(len, streamed[True]))
    log(f"  quantized bf16 engine, B={QUANT_GRAPH_B}: tick captured as a CUDA graph "
        f"{streamed[True, 'captured']}; {len(streamed[True, 'packed'])} graph replays "
        f"streaming the {len(sel)} utterances against eager ticks, tokens, packed outputs and "
        f"state bit-equal: {equal} ({emitted} symbols); K1 counted {streamed[True, 'k1']} / "
        f"{streamed[False, 'k1']}")
    if not (equal and streamed[True, "captured"]) or streamed[True, "k1"] or streamed[
            False, "k1"]:
        raise AssertionError("the quantized engine's graph replays differ from its eager ticks")
    del models
    torch.cuda.empty_cache()
    out["d"] = {"wer": qres.wer, "unquantized_wer": fres.wer, "launches": qcounts,
                "hyps_equal_unquantized": same_f, "utterances": QUANT_UTTS,
                "wall_s": qwall, "unquantized_wall_s": fwall,
                "lstm_equal_share": h_equal, "lstm_max_bf_ulps": h_ulps,
                "layers_quantized": len(quantized_layers),
                "decoder_s": sum(d["ms"] for d in qdec) / 1e3,
                "symbols": sum(d["symbols"] for d in qdec),
                "loop_ms": {n: {"ms": v[0], "iters": v[1], "graph": v[2]}
                            for n, v in loop_ms.items()},
                "enc_max_abs_err": float(d.max()), "enc_mean_abs_err": float(d.mean()),
                "enc_equal_share": float((d == 0).float().mean()),
                "plain_mean_abs_diff": float(d_plain.mean()),
                "plain_max_abs_diff": float(d_plain.max()),
                "cpu_utterances": len(sel), "hyps_equal_cpu": same_cpu,
                "graph_equal_eager": equal, "streamed_symbols": emitted,
                "seconds": time.perf_counter() - t_d}
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = {"lstm_recurrence": sum(out["a"]["k1"].values())
                       + out["b"]["launches"].get("lstm_recurrence", 0)
                       + out["c"]["launches"].get("lstm_recurrence", 0)}
    log(f"  phase 18 took {out['seconds']:.1f} s: (a) {out['a']['seconds']:.1f}, (b) "
        f"{out['b']['seconds']:.1f}, (c) {out['c']['seconds']:.1f}, (d) "
        f"{out['d']['seconds']:.1f} on {card()}")
    return out


# ---------------------------------------------------------------- phase 19
# The pruned two-stage loss and the vocab-parallel (model-parallel) train
# step, at base-85M's widths (Hj 768, K 8,704). (a) the pruned loss at phase
# 4's batch (B=16, T'=134, U=64), band PR_S, bf16; (b) and (c) in one launch
# of python -m torch.distributed.run --nproc_per_node 2 on one card (gloo),
# this script's --rank-worker: (b) the vocab-parallel joint on two shards of
# 4,352 classes, its slab forced to hold VP_KS columns of each so that K2
# and K4 run beside K5; (c) train.main --model_parallel 2 three times in
# the same ranks; (d) synthetic_e2e --pruned 4.
PR_S = 5                  # the band of (a) and (c)
VP_RANKS = MH_RANKS       # the launch's ranks, one model group
VP_N = 16384              # (b)'s rows: the CLI's packed cap
VP_KS = 2048              # the columns (b)'s slab holds of each 4,352-wide shard
VP_REPS = 5
TP_B = N_UTTS // 2        # (c): A=2 x 8 a data rank
TP_STEPS = 2
TP_FLAGS = ["--model_parallel", str(VP_RANKS), "--rsp_seq_len_freq", "1"]  # TP refuses RSP
E2E_PRUNED = 4
# (b) the vocab-parallel joint against one process's fused_joint_lse and
# against its plain version: the log-probabilities 1e-5 relative; db (fp32)
# 1e-3 of its largest magnitude (the bf16 slab and, on the recomputed
# columns, the bf16 rounding of p and dz); dh and dW come back in the
# inputs' bf16, so a rounding that falls the other way moves an entry by one
# bf16 ulp: 2^-7 of the largest magnitude
VP_LP_RTOL = 1e-5
BF16_ULP = 2 ** -7  # one bf16 step of the largest magnitude
VP_GRAD_RTOL = {"dh": BF16_ULP, "dw": BF16_ULP, "db": GRAD_RTOL}
# (a) likewise: the loss 1e-5; a gradient GRAD_RTOL where it is fp32, one
# bf16 step where it comes back in the bf16 of f, g and the weights. That a
# bf16 gradient's difference is rounding and not the kernel is held apart:
# in (a) and (b) the kernels' gradients and the plain path's (in (b) one
# process's) are each compared with the same inputs run in fp32 end to end,
# and the kernels' may be no farther from it than GRAD_RTOL past the other's


def _timed(fn):
    """(fn(), its ms between two synchronises)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _max_rel(got, want) -> float:
    return float(((got.float() - want.float()).abs().max() / want.float().abs().max()).item())


def run_pruned_loss() -> dict:
    """Phase 19 (a): the pruned loss at base-85M bf16, B=16, band PR_S."""
    import torch

    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.ops import joint_kernel as jk
    from caiman_asr_tpu_torch.ops import pruned_loss as pl
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
    from caiman_asr_tpu_torch.ops.transducer_loss import (
        LossModifiers, _lab_padded, rnnt_lattice, transducer_loss_from_fg,
        _fused_joint_scores, _penalised_scores)
    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
    from caiman_asr_tpu_torch.training.step import (
        _cast_compute, init_train_state, make_train_step)

    name = "base-85M"
    K = MODELS[name][1]
    out = {}
    model = build_model(name, "cuda")
    fp = FeaturePipeline(PipelineConfig(logmel=LogMelConfig(dither=0.0)), device="cuda")
    batch = train_batch(fp, K, SEED)
    mb = {k: v[0] for k, v in batch.items()}
    p, feats = _cast_compute(model.param_tree(), mb["feats"], torch.bfloat16)
    with torch.no_grad():
        (f, f_lens), (g, _), _ = model.enc_pred(feats, mb["feat_lens"], mb["txt"],
                                                mb["txt_lens"], params=p)
    heads = pl.init_simple_params(torch.Generator(device="cuda").manual_seed(SEED + 19),
                                  f.shape[2], K)
    base = [f, g, p["joint_fc"]["w"], p["joint_fc"]["b"]] + [
        heads[k][n].detach().to(torch.bfloat16 if n == "w" else torch.float32)
        for k in ("simple_am", "simple_lm") for n in ("w", "b")]
    txt, u_lens = mb["txt"], mb["txt_lens"]
    B, T, Hj = f.shape
    U1 = g.shape[1]

    def loss_and_grads(S, scale, dense=False, dtype=None):
        leaves = [t.detach().clone().to(dtype or t.dtype).requires_grad_() for t in base]
        fl, gl, w, b, aw, ab, lw, lb = leaves
        if dense:
            loss = transducer_loss_from_fg(fl, gl, w, b, txt, f_lens, u_lens, K - 1)
            leaves = leaves[:4]
        else:
            loss = pl.pruned_transducer_loss_from_fg(
                fl, gl, w, b, {"simple_am": {"w": aw, "b": ab}, "simple_lm": {"w": lw, "b": lb}},
                txt, f_lens, u_lens, K - 1, prune_range=S, simple_scale=scale)
        return loss.detach(), torch.autograd.grad(loss.sum(), leaves)

    # the kernels against the plain path, and the full band against the dense loss
    reset_counts()
    got, got_g = loss_and_grads(PR_S, 0.5)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts().items() if v}
    with plain_path():
        want, want_g = loss_and_grads(PR_S, 0.5)
        # the same inputs in fp32 end to end: what both bf16 paths round
        _, ref_g = loss_and_grads(PR_S, 0.5, dtype=torch.float32)
    names = ["f", "g", "joint_fc.w", "joint_fc.b", "simple_am.w", "simple_am.b",
             "simple_lm.w", "simple_lm.b"]
    grad_tol = {n: BF16_ULP if t.dtype == torch.bfloat16 else GRAD_RTOL
                for n, t in zip(names, base)}
    grad_errs = {n: rel_err(a, e) for n, a, e in zip(names, got_g, want_g)}
    to_fp32 = {path: {n: rel_err(a, e) for n, a, e in zip(names, gs, ref_g)}
               for path, gs in (("kernels", got_g), ("plain", want_g))}
    loss_err = _max_rel(got, want)
    n_band, n_dense = B * T * PR_S, B * T * U1
    log(f"  (a) pruned loss, base-85M bf16, B={B}, T'={T}, U={U1 - 1}, S={PR_S}: the banded "
        f"joint on {n_band} rows against the dense {n_dense} ({n_band / n_dense:.1%}), its plan "
        f"{jk.store_plan(n_band, Hj, K)['backward']}; kernels against the plain path: loss "
        f"{loss_err:.3g} (tol {LOSS_RTOL}), gradients {grad_errs} (tol {grad_tol}); against "
        f"the fp32 reference, the kernels' gradients {to_fp32['kernels']}, the plain path's "
        f"{to_fp32['plain']} (tol: the plain path's + {GRAD_RTOL}); launches {counts}")
    if loss_err > LOSS_RTOL or any(e > grad_tol[n] for n, e in grad_errs.items()):
        raise AssertionError("(a): the pruned loss's kernels differ from the plain path")
    if any(to_fp32["kernels"][n] > to_fp32["plain"][n] + GRAD_RTOL for n in names):
        raise AssertionError("(a): the kernels' gradients are farther from the fp32 reference "
                             "than the plain path's")
    for k in ("joint_fwd_store", "joint_bwd_dh", "joint_bwd_dw"):
        if not counts.get(k):
            raise AssertionError(f"(a): the banded joint did not launch {k}: {counts}")
    full, full_g = loss_and_grads(U1, 0.0)
    dense, dense_g = loss_and_grads(0, 0.0, dense=True)
    full_err = _max_rel(full, dense)
    full_gerr = {n: rel_err(a, e) for n, a, e in zip(names, full_g, dense_g)}
    log(f"  (a) the full band (S={U1}, simple scale 0) against the dense loss: loss {full_err:.3g}"
        f" (tol {LOSS_RTOL}), gradients {full_gerr} (tol {grad_tol})")
    if full_err > LOSS_RTOL or any(e > grad_tol[n] for n, e in full_gerr.items()):
        raise AssertionError("(a): the full band differs from the dense loss")
    del full_g, dense_g, got_g, want_g, ref_g
    torch.cuda.empty_cache()
    out.update(rows=n_band, dense_rows=n_dense, loss_rel=loss_err, grad_rel=grad_errs,
               grad_rel_to_fp32=to_fp32, full_band_loss_rel=full_err, full_band_grad_rel=full_gerr, launches_loss=counts)

    # one pruned step against one dense step, in turns, warm
    opt = Lamb(OptimizerConfig(warmup_steps=0), model.param_lr_factors())
    states = {"pruned": init_train_state(model, opt, device="cuda", pruned_loss=True, seed=SEED),
              "dense": init_train_state(model, opt, device="cuda")}
    steps = {kind: make_train_step(model, opt, K - 1, compute_dtype=torch.bfloat16,
                                   pruned_range=PR_S if kind == "pruned" else 0,
                                   device="cuda") for kind in states}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    ms, first_ms = {"pruned": [], "dense": []}, {}
    launches = {}
    for i, kind in enumerate(("pruned", "dense", "pruned", "dense", "dense", "pruned")):
        reset_counts()
        (states[kind], m), t = _timed(lambda: steps[kind](states[kind], batch, gen, SCALARS))
        if m["skipped"] or not math.isfinite(float(m["loss"])):
            raise AssertionError(f"(a): the {kind} step skipped or not finite: {m}")
        if i >= 2:
            ms[kind].append(t)
        else:
            first_ms[kind] = t
        launches[kind] = {k: v for k, v in read_counts().items() if v}
    for k in LSTM_TRAIN_KERNELS + ("joint_fwd_store", "joint_bwd_dh", "joint_bwd_dw"):
        if not launches["pruned"].get(k):
            raise AssertionError(f"(a): the pruned step did not launch {k}")
    for kind, counts_k in launches.items():
        check_finish_launches(counts_k, f"(a): the {kind} step")

    # the pruned loss's stages, forward and backward each, against the dense loss's
    fl, gl, w, b, aw, ab, lw, lb = [t.detach().clone().requires_grad_() for t in base]
    mods = LossModifiers()
    (simple, null_s, emit_s), t_sf = _timed(lambda: pl._simple_stage(
        fl, gl, aw, ab, lw, lb, txt, f_lens, u_lens, K - 1, mods))
    ranges, t_r = _timed(lambda: pl.simple_ranges(simple, null_s, emit_s, f_lens, u_lens, PR_S))
    _, t_sb = _timed(lambda: torch.autograd.grad(simple.sum(), [fl, gl, aw, ab, lw, lb]))

    def band_joint():
        lab = _lab_padded(txt)
        u_band = torch.clamp(ranges[:, :, None] + torch.arange(PR_S, device="cuda"), 0, U1 - 1)
        lab_band = lab[:, None, :].expand(B, T, U1).gather(2, u_band)
        rows = (torch.arange(B, device="cuda")[:, None] * U1 + u_band.reshape(B, -1)).reshape(-1)
        h = torch.relu(fl[:, :, None, :].float() + gl.float().reshape(B * U1, Hj)[rows].reshape(
            B, T, PR_S, Hj)).to(fl.dtype)
        return jk.fused_joint_lse(h.reshape(-1, Hj), w.t(), b, lab_band.reshape(-1), K - 1)

    (lp_b, lp_l), t_jf = _timed(band_joint)
    _, t_jb = _timed(lambda: torch.autograd.grad(lp_b.sum() + lp_l.sum(), [fl, gl, w, b]))
    nb, eb = (x.detach().reshape(B, T, PR_S).requires_grad_() for x in (lp_b, lp_l))
    lat, t_lf = _timed(lambda: pl.banded_rnnt_lattice(nb, eb, ranges, f_lens, u_lens))
    _, t_lb = _timed(lambda: torch.autograd.grad(lat.sum(), [nb, eb]))
    (d_b, d_l), t_djf = _timed(lambda: _fused_joint_scores(fl, gl, w, b, txt, K - 1))
    _, t_djb = _timed(lambda: torch.autograd.grad(d_b.sum() + d_l.sum(), [fl, gl, w, b]))
    dn, de = (x.detach().requires_grad_() for x in _penalised_scores(d_b, d_l, txt, f_lens,
                                                                      mods))
    dlat, t_dlf = _timed(lambda: rnnt_lattice(dn, de, f_lens, u_lens))
    _, t_dlb = _timed(lambda: torch.autograd.grad(dlat.sum(), [dn, de]))
    breakdown = {"simple_fwd": t_sf, "simple_bwd": t_sb, "posteriors_and_ranges": t_r,
                 "banded_joint_fwd": t_jf, "banded_joint_bwd": t_jb,
                 "banded_lattice_fwd": t_lf, "banded_lattice_bwd": t_lb}
    dense_bd = {"joint_fwd": t_djf, "joint_bwd": t_djb, "lattice_fwd": t_dlf,
                "lattice_bwd": t_dlb}
    log(f"  (a) one step, bf16, A=1 x B={B}: pruned {[round(x, 1) for x in ms['pruned']]} ms, "
        f"dense {[round(x, 1) for x in ms['dense']]} ms (warm, in turns; the first of each "
        f"{first_ms['pruned']:.1f} / {first_ms['dense']:.1f} ms); the pruned loss's "
        f"stages (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in breakdown.items())
        + "; the dense loss's: " + ", ".join(f"{k} {v:.1f}" for k, v in dense_bd.items())
        + f"; launches a pruned step {launches['pruned']}, a dense step {launches['dense']}; "
        f"on {card()}")
    out.update(step_ms=ms, first_step_ms=first_ms, breakdown_ms=breakdown,
               dense_breakdown_ms=dense_bd,
               launches=launches["pruned"], launches_dense=launches["dense"])
    return out


def vp_check(spec: dict) -> dict:
    """Phase 19 (b), in a rank of the phase-19 launch: the vocab-parallel
    joint on this rank's shard against one process's fused_joint_lse on the
    whole vocabulary and against vp_joint_lse_plain, counted and timed."""
    import torch

    from caiman_asr_tpu_torch.ops import joint_kernel as jk
    from caiman_asr_tpu_torch.parallel import mesh
    from caiman_asr_tpu_torch.parallel import vocab_parallel as vp

    N, Hj, K = spec["N"], spec["Hj"], spec["K"]
    mesh.init_model_parallel(VP_RANKS)
    group, r = mesh.model_group(), mesh.model_rank()
    Kl = K // VP_RANKS
    h, wt, b, labels, cb, cl = joint_inputs(N, Hj, K, torch.bfloat16, SEED + 19)
    w = wt.t().contiguous()
    cols = slice(r * Kl, (r + 1) * Kl)
    tp, kt = jk._tiles(Hj)[:2]
    limit = VP_KS * jk._pad(N, tp) * 2

    def run(fn, w_, b_, dtype=None):
        leaves = [t.detach().clone().to(dtype or t.dtype).requires_grad_() for t in (h, w_, b_)]
        lp_b, lp_l = fn(leaves[0], leaves[1], leaves[2], labels, K - 1)
        grads = torch.autograd.grad((lp_b * cb).sum() + (lp_l * cl).sum(), leaves)
        return (lp_b.detach(), lp_l.detach()), grads

    vp_fn = lambda *a: vp.vp_joint_lse(*a, group)
    with policy(Z_STORE_LIMIT_BYTES=limit, Z_STORE_PARTIAL=True):
        ks = vp.store_cols(N, Hj, Kl)
        reset_counts()
        got, got_g = run(vp_fn, w[:, cols], b[cols])
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        vp_ms = cuda_ms(lambda: run(vp_fn, w[:, cols], b[cols]), reps=VP_REPS)
    plain, plain_g = run(lambda *a: vp.vp_joint_lse_plain(*a, group), w[:, cols], b[cols])
    one, one_g = run(jk.fused_joint_lse, w, b)
    one_ms = cuda_ms(lambda: run(jk.fused_joint_lse, w, b), reps=VP_REPS)
    one_sh = (one_g[0], one_g[1][:, cols], one_g[2][cols])
    with plain_path():  # the same inputs in fp32 end to end: what the bf16 gradients round
        ref_g = run(jk.fused_joint_lse, w, b, torch.float32)[1]
    ref_sh = (ref_g[0], ref_g[1][:, cols], ref_g[2][cols])
    del ref_g
    to_fp32 = {f"{n}_{path}": rel_err(x, y)
               for path, gs in (("vp", got_g), ("one_process", one_sh))
               for n, x, y in zip(("dh", "dw", "db"), gs, ref_sh)}
    errs = {
        "lp_vs_plain": max(_max_rel(x, y) for x, y in zip(got, plain)),
        "lp_vs_one_process": max(_max_rel(x, y) for x, y in zip(got, one)),
        **{f"{n}_vs_plain": rel_err(x, y) for n, x, y in zip(("dh", "dw", "db"), got_g, plain_g)},
        **{f"{n}_vs_one_process": rel_err(x, y)
           for n, x, y in zip(("dh", "dw", "db"), got_g, one_sh)}}
    return {"ks": ks, "Kl": Kl, "K": K, "Hj": Hj, "counts": counts, "errs": errs,
            "to_fp32": to_fp32, "vp_ms": vp_ms, "one_process_ms": one_ms}


def run_pruned_and_tp() -> dict:
    """Phase 19: (a) the pruned loss; (b) the vocab-parallel joint and (c)
    train.main --model_parallel 2 in one two-rank launch; (d) synthetic_e2e
    --pruned."""
    import shutil

    import numpy as np
    import torch

    from caiman_asr_tpu_torch import synthetic_e2e, train

    t_phase = time.perf_counter()
    res = {"a": run_pruned_loss()}
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase

    root = REPO / "build" / "smoke" / "train_cli"  # phase 15's workspace
    work = REPO / "build" / "smoke" / "tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    plain = mh_plain_config(work / "base-plain.yaml")
    cfg = REPO / VAL_CONFIG
    outs = {n: work / n for n in ("fp32", "bf16", "pruned")}
    # (c): fp32 with nothing random, validated at the end; bf16 with the
    # base config's randomness and packing; the pruned loss, checkpointed
    runs = {
        "fp32": mh_argv(root, outs["fp32"], config=plain, steps=TP_STEPS, rank_batch=TP_B,
                        bf16=False, val_frequency=TP_STEPS, save_frequency=TP_STEPS),
        "bf16": mh_argv(root, outs["bf16"], config=cfg, steps=TP_STEPS, rank_batch=TP_B,
                        val_frequency=10 * TP_STEPS, save_frequency=10 * TP_STEPS),
        "pruned": mh_argv(root, outs["pruned"], config=cfg, steps=TP_STEPS, rank_batch=TP_B,
                          val_frequency=10 * TP_STEPS, save_frequency=TP_STEPS)
        + ["--pruned_loss_range", str(PR_S)],
    }
    vp_shapes = {"N": VP_N, "Hj": MODELS["base-85M"][0]["joint_n_hid"],
                 "K": MODELS["base-85M"][1]}
    launched = launch_runs("tp", {n: argv + TP_FLAGS for n, argv in runs.items()}, work, "0",
                           vp=vp_shapes)
    backend = launched["fp32"]["backend_lines"]
    launch_s = launched["fp32"]["wall_s"]

    # (b)
    vp_kernels = ("joint_fwd", "joint_fwd_store", "joint_bwd_dh", "joint_bwd_dw",
                  "joint_bwd_dh_recompute", "joint_bwd_dw_recompute")
    for rank, v in enumerate(launched["vp"]):
        log(f"  (b) rank {rank}: vocab-parallel joint, N={VP_N}, Hj={v['Hj']}, Kl="
            f"{v['Kl']} of {v['K']}, bf16, the slab over [0, {v['ks']}) and the rest recomputed: "
            f"errors {v['errs']} (tol lp {VP_LP_RTOL}, gradients {VP_GRAD_RTOL}); against the "
            f"fp32 reference {v['to_fp32']} (tol: one process's + {GRAD_RTOL}); launches "
            f"{v['counts']}; fwd+bwd {v['vp_ms']:.2f} ms against one process's fused_joint_lse "
            f"on the whole vocabulary {v['one_process_ms']:.2f} ms (both ranks on the one card "
            f"at once)")
        if v["ks"] != VP_KS:
            raise AssertionError(f"(b): the slab holds {v['ks']} columns, not {VP_KS}")
        if any(e > (VP_LP_RTOL if n.startswith("lp") else VP_GRAD_RTOL[n.split("_")[0]])
               for n, e in v["errs"].items()):
            raise AssertionError(f"(b): rank {rank} differs: {v['errs']}")
        if any(v["to_fp32"][f"{n}_vp"] > v["to_fp32"][f"{n}_one_process"] + GRAD_RTOL
               for n in ("dh", "dw", "db")):
            raise AssertionError(f"(b): rank {rank}'s gradients are farther from the fp32 "
                                 f"reference than one process's: {v['to_fp32']}")
        missing = [k for k in vp_kernels if not v["counts"].get(k)]
        if missing:
            raise AssertionError(f"(b): rank {rank} launched none of {missing}")
    res["b"] = {"ranks": launched["vp"], "backend": backend}

    # (c) fp32 against one process at the same global batch, and its
    # validation (the EMA's vocab shards gathered) against one process's of
    # the step-2 checkpoint
    torch.cuda.empty_cache()
    one_out = work / "one"
    argv_one = mh_argv(root, one_out, config=plain, steps=TP_STEPS, rank_batch=TP_B, bf16=False,
                       val_frequency=10 * TP_STEPS, save_frequency=10 * TP_STEPS) + [
        "--rsp_seq_len_freq", "1"]
    reset_counts()
    with cli_probes() as probe1:
        train.main(train.train_arg_parser().parse_args(argv_one))
    got, want = train_log(outs["fp32"]), train_log(one_out)
    if not sorted(got) == sorted(want) == list(range(1, TP_STEPS + 1)):
        raise AssertionError(f"(c): steps {sorted(got)} against {sorted(want)}")
    loss_err = max(abs(got[s][0] - want[s][0]) / abs(want[s][0]) for s in want)
    gn_err = max(abs(got[s][1] - want[s][1]) / abs(want[s][1]) for s in want)
    wer, hyps = mh_preds(outs["fp32"], TP_STEPS)
    torch.cuda.empty_cache()
    ref = one_process_validation(runs["fp32"], outs["fp32"] / "ckpts" / f"step{TP_STEPS}.npz")
    same = wer == ref.wer and hyps == dict(zip(ref.fnames, ref.hyps))
    torch.cuda.empty_cache()
    # the pruned run's checkpoint (whole arrays) resumed by one process
    resumed = work / "resumed"
    argv_r = mh_argv(root, resumed, config=cfg, steps=TP_STEPS + 1, rank_batch=TP_B,
                     val_frequency=10 * TP_STEPS, save_frequency=10 * TP_STEPS) + [
        "--rsp_seq_len_freq", "1", "--pruned_loss_range", str(PR_S), "--resume", "--ckpt",
        str(outs["pruned"] / "ckpts" / f"step{TP_STEPS}.npz")]
    reset_counts()
    with cli_probes() as probe_r:
        state, _ = train.main(train.train_arg_parser().parse_args(argv_r))
    resumed_log = train_log(resumed)
    resumed_ok = state.step == TP_STEPS + 1 and sorted(resumed_log) == [TP_STEPS + 1] and all(
        math.isfinite(x) for x in resumed_log[TP_STEPS + 1])
    del state
    torch.cuda.empty_cache()
    runs_c = {}
    for name in runs:
        per = launched[name]["ranks"]
        steps_ms = [[round(s["ms"], 1) for s in r["steps"]] for r in per]
        per_step = [r["steps"][-1]["launches"] for r in per]
        runs_c[name] = {"steps_ms": steps_ms, "launches_a_step": per_step,
                        "counts": [r["counts"] for r in per], "pack_to": [
                            s["pack_to"] for s in per[0]["steps"]],
                        "shard": per[0]["shard"], "wall_s": [r["wall_s"] for r in per],
                        "loss": train_log(outs[name])}
        log(f"  (c) {name}: train.main --model_parallel 2 on two ranks of one card "
            f"({backend}): shard {per[0]['shard']}, ms a step per rank {steps_ms}, pack_to "
            f"{runs_c[name]['pack_to']}, (loss, grad norm) {train_log(outs[name])}, launches a "
            f"step per rank {per_step}, wall {[round(r['wall_s'], 1) for r in per]} s")
        for r, steps in enumerate(per):
            for i, s in enumerate(steps["steps"]):
                need = LSTM_TRAIN_KERNELS + MH_K5
                missing = [k for k in need if not s["launches"].get(k)]
                if missing:
                    raise AssertionError(f"(c) {name}: rank {r} step {i + 1} launched none "
                                         f"of {missing}")
                check_finish_launches(s["launches"], f"(c) {name}: rank {r} step {i + 1}")
        if any(not math.isfinite(x) for v in train_log(outs[name]).values() for x in v):
            raise AssertionError(f"(c) {name}: a step is not finite")
    if runs_c["bf16"]["pack_to"][0] is None or runs_c["pruned"]["pack_to"][0] is not None:
        raise AssertionError(f"(c): packing {runs_c['bf16']['pack_to']} / "
                             f"{runs_c['pruned']['pack_to']}")
    log(f"  (c) fp32: two ranks (one model group) against one process at B={TP_B} a "
        f"microbatch: losses {[got[s][0] for s in sorted(got)]} / "
        f"{[want[s][0] for s in sorted(want)]} (largest relative difference {loss_err:.3g}, "
        f"tol {MH_LOSS_RTOL}), gradient norms {gn_err:.3g} (tol {MH_GRAD_RTOL}); one "
        f"process's ms a step {[round(s['ms'], 1) for s in probe1['steps']]}; the ranks' dev "
        f"WER {wer:.6f} (the EMA's vocab shards gathered), one process's validation of their "
        f"step-{TP_STEPS} checkpoint {ref.wer:.6f}, hypotheses identical {same}; the pruned "
        f"run's step-{TP_STEPS} checkpoint resumed by one process: step {TP_STEPS + 1} "
        f"{resumed_log} ({'finite' if resumed_ok else 'FAILED'}), "
        f"{[round(s['ms'], 1) for s in probe_r['steps']]} ms; launch wall {launch_s:.1f} s")
    if loss_err > MH_LOSS_RTOL or gn_err > MH_GRAD_RTOL or not same or not resumed_ok:
        raise AssertionError("(c): the model-parallel runs differ from one process")
    res["c"] = {"runs": runs_c, "loss_rel": loss_err, "grad_norm_rel": gn_err,
                "one_process_ms": [s["ms"] for s in probe1["steps"]], "dev_wer": wer,
                "one_process_wer": ref.wer, "hyps_identical": same,
                "resumed": resumed_log, "launch_s": launch_s}
    t_bc = time.perf_counter() - t_phase - t_a

    # (d) synthetic_e2e --pruned
    e2e_root = REPO / "build" / "smoke" / "e2e_pruned"
    shutil.rmtree(e2e_root, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    e2e = synthetic_e2e.run(e2e_root, steps=E2E_STEPS, log_frequency=1, pruned=E2E_PRUNED)
    e2e_s = time.perf_counter() - t0
    e2e_counts = {k: v for k, v in read_counts().items() if v}
    losses = [e2e["losses"][k] for k in sorted(e2e["losses"])]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    log(f"  (d) synthetic_e2e --pruned {E2E_PRUNED}, {E2E_STEPS} steps: mean loss of the first "
        f"20 steps {first:.4f}, of the last 20 {last:.4f} ({last / first:.3f}; bar "
        f"{E2E_BAR}); greedy best dev WER {e2e['greedy_best_wer']:.4f}, fast beam "
        f"{e2e['beam_wer']:.4f}; training {e2e['train_s']:.1f} s "
        f"({1e3 * e2e['train_s'] / E2E_STEPS:.1f} ms a step with validation), {e2e_s:.1f} s in "
        f"all; launches {e2e_counts}")
    if not last < E2E_BAR * first:
        raise AssertionError(f"(d): the pruned synthetic task's loss did not fall: {first} -> "
                             f"{last}")
    for k in LSTM_TRAIN_KERNELS:
        if not e2e_counts.get(k):
            raise AssertionError(f"(d): synthetic_e2e --pruned never launched {k}")
    res["d"] = {"steps": E2E_STEPS, "first20": first, "last20": last,
                "greedy_best_wer": e2e["greedy_best_wer"], "beam_wer": e2e["beam_wer"],
                "train_s": e2e["train_s"], "wall_s": e2e_s, "launches": e2e_counts}
    res["card"] = card()
    res["wall_s"] = {"a": t_a, "b_c": t_bc, "d": e2e_s, "all": time.perf_counter() - t_phase}
    log(f"  phase 19 took {res['wall_s']['all']:.1f} s ((a) {t_a:.1f}, (b)+(c) {t_bc:.1f}, "
        f"(d) {e2e_s:.1f}) on {res['card']}")
    return res


# ---------------------------------------------------------------- phase 20
def _rel_each(got, want) -> float:
    """The largest |got - want| / |want| over the entries (equal entries,
    infinities too, count 0)."""
    import torch

    got, want = got.double(), want.double()
    diff = torch.where(got == want, torch.zeros_like(got), (got - want).abs())
    return float((diff / want.abs().clamp_min(1e-300)).max()) if diff.numel() else 0.0


def finish_inputs(shapes, factor, seed: int):
    """The finish's leaves on the card from a seeded generator: parameters
    N(0, 0.05^2), the EMA a perturbed copy, the moments of a few steps'
    scale; and a function drawing one finish's gradients, N(0, 1e-4)."""
    import torch

    from caiman_asr_tpu_torch.ops import finish_kernel as fk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda shape, scale: torch.randn(shape, generator=gen, device="cuda") * scale
    p = [rnd(sh, 0.05) for sh in shapes]
    leaves = fk.Leaves(p=tuple(p), e=tuple(x + rnd(x.shape, 1e-3) for x in p),
                       m=tuple(rnd(sh, 1e-3) for sh in shapes),
                       v=tuple(rnd(sh, 1e-3) ** 2 for sh in shapes), factor=tuple(factor),
                       sharded=(False,) * len(shapes))
    return leaves, lambda: [rnd(sh, 1e-2) for sh in shapes], gen


def clone_leaves(leaves):
    from caiman_asr_tpu_torch.ops import finish_kernel as fk

    return fk.Leaves(*(tuple(t.clone() for t in ts) for ts in (leaves.p, leaves.e, leaves.m,
                                                             leaves.v)),
                     leaves.factor, leaves.sharded)


def finish_consts(count: int, clip_norm=1.0):
    import numpy as np

    from caiman_asr_tpu_torch.ops import finish_kernel as fk

    f32 = np.float32
    return fk.Consts(clip_norm=clip_norm, beta1=0.9, beta2=0.999,
                     bc1=float(f32(1) - f32(0.9) ** f32(count)),
                     bc2=float(f32(1) - f32(0.999) ** f32(count)), eps=1e-9, weight_decay=1e-2)


def check_finish(shapes, factor, tag: str, seed: int, none=(), overwrite=(),
                 nonfinite: bool = False, clip_norm=1.0) -> dict:
    """FINISH_STEPS finishes in a row of the three kernels and, beside them,
    of their plain versions, each pass given the same inputs (passes 1 and
    2 take the plain route's gradient norm and squared norms, after those
    are held against the kernels'): the norms within FINISH_RTOL, the
    moments equal to the bit, the parameters and EMA within FINISH_RTOL of
    each leaf's largest magnitude. ``none``: leaves without a gradient;
    ``overwrite``: leaves overwritten in pass 2; ``nonfinite``: NaN, inf and
    -inf entries in the last two leaves' gradients."""
    import torch

    from caiman_asr_tpu_torch.ops import finish_kernel as fk

    init, grads, gen = finish_inputs(shapes, factor, seed)
    kern, plain = clone_leaves(init), clone_leaves(init)
    del init
    worst = {"norm_rel": 0.0, "p_norm_rel": 0.0, "u_norm_rel": 0.0, "p_rel": 0.0, "ema_rel": 0.0,
             "moments_unequal": 0, "max_abs_err": 0.0}
    for step in range(FINISH_STEPS):
        g = [None if i in none else t for i, t in enumerate(grads())]
        if nonfinite:
            g[-2].view(-1)[5], g[-2].view(-1)[-1] = float("nan"), float("inf")
            g[-1].view(-1)[-1] = -float("inf")
        src = [torch.randn(sh, generator=gen, device="cuda") if i in overwrite else None
               for i, sh in enumerate(shapes)]
        c = finish_consts(step + 1, clip_norm)
        sq_k, gsq_k = fk.lamb_finish_norms(kern, g)
        sq_q, gsq_q = fk.lamb_finish_norms_plain(plain, g)
        norm_rel = max(_rel_each(torch.sqrt(sq_k), torch.sqrt(sq_q)),
                       _rel_each(torch.sqrt(gsq_k), torch.sqrt(gsq_q)))
        norm = torch.sqrt(gsq_q)
        pu_k = fk.lamb_finish_moments(kern, g, norm, c)
        pu_q = fk.lamb_finish_moments_plain(plain, g, norm, c)
        unequal = sum(int((a != b).sum()) for a, b in zip(kern.m + kern.v, plain.m + plain.v))
        p_norm_rel = _rel_each(torch.sqrt(pu_k[:, 0]), torch.sqrt(pu_q[:, 0]))
        u_norm_rel = _rel_each(torch.sqrt(pu_k[:, 1]), torch.sqrt(pu_q[:, 1]))
        fk.lamb_finish_apply(kern, pu_q, c, 4e-3, 0.999, src)
        fk.lamb_finish_apply_plain(plain, pu_q, c, 4e-3, 0.999, src)
        torch.cuda.synchronize()
        p_rel = max(rel_err(a, b) for a, b in zip(kern.p, plain.p))
        e_rel = max(rel_err(a, b) for a, b in zip(kern.e, plain.e))
        finite = all(bool(torch.isfinite(t).all()) for t in kern.p + kern.e)
        abs_err = max(float((a - b).abs().max()) for a, b in zip(kern.p, plain.p))
        for key, val in (("norm_rel", norm_rel), ("p_norm_rel", p_norm_rel),
                         ("u_norm_rel", u_norm_rel), ("p_rel", p_rel), ("ema_rel", e_rel),
                         ("max_abs_err", abs_err)):
            worst[key] = max(worst[key], val)
        worst["moments_unequal"] += unequal
        if (max(norm_rel, p_norm_rel, u_norm_rel, p_rel, e_rel) > FINISH_RTOL or unequal
                or not finite):
            raise AssertionError(f"{tag}, finish {step + 1}: the kernels differ from the plain "
                                 f"versions: norms {norm_rel}, ||p|| {p_norm_rel}, ||u|| "
                                 f"{u_norm_rel}, p {p_rel}, EMA {e_rel}, {unequal} moment "
                                 f"entries unequal, finite {finite}")
        for i in overwrite:
            if not torch.equal(kern.p[i], src[i]):
                raise AssertionError(f"{tag}: leaf {i} did not take its overwrite source")
    log(f"  finish {tag}: {FINISH_STEPS} finishes, kernels against plain versions: norms "
        f"{worst['norm_rel']:.3g}, ||p|| {worst['p_norm_rel']:.3g}, ||u|| "
        f"{worst['u_norm_rel']:.3g}, p {worst['p_rel']:.3g}, EMA {worst['ema_rel']:.3g} "
        f"(tol {FINISH_RTOL}); moments unequal in {worst['moments_unequal']} entries")
    return worst


def median_ms(fn, reps: int = FINISH_REPS, warmup: int = 3, hide_host: bool = False) -> float:
    """The median time of one fn() call over reps between two CUDA events
    on an idle card: the host's work in the call included; or, with
    ``hide_host``, each call queued behind a device sleep twice as long as
    a call takes, so that the events time the device's work alone."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # torch.cuda._sleep spins for a number of cycles: at most ~2 GHz
    cycles = int(2 * 2e6 * 1e3 * (time.perf_counter() - t0)) + 1
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run_finish() -> dict:
    """Phase 20: the fused LAMB finish at base-85M's and large-196M's 47
    leaves: check_finish, then each pass and the whole finish (Lamb.update)
    timed warm as the median of FINISH_REPS calls, kernels and plain
    versions, beside the bound and torch.optim.Adam(fused=True)'s step over
    the same leaves (Adam, one pass, not LAMB: a yardstick, not the same
    function)."""
    import torch

    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from caiman_asr_tpu_torch.ops import finish_kernel as fk
    from caiman_asr_tpu_torch.training.optimizer import Lamb, LambState, OptimizerConfig
    from caiman_asr_tpu_torch.training.step import _nested
    from caiman_asr_tpu_torch.training.tree import tree_items

    t_phase = time.perf_counter()
    out = {}
    for k, name in enumerate(MODELS):
        model = RNNT(model_config(name), MODELS[name][1], device="cuda")
        items = [(path, tuple(leaf.shape)) for path, leaf in tree_items(model.param_tree())]
        lr_factors = model.param_lr_factors()
        del model
        paths, shapes = zip(*items)
        factor = [float(lr_factors.get(path[0], 1.0)) for path in paths]
        n = sum(math.prod(sh) for sh in shapes)
        errs = check_finish(shapes, factor, f"{name} ({len(shapes)} leaves, {n} parameters)",
                            SEED + 50 + k)
        torch.cuda.empty_cache()

        leaves, grads, _ = finish_inputs(shapes, factor, SEED + 60 + k)
        g = grads()
        c = finish_consts(1)
        norm = torch.sqrt(fk.lamb_finish_norms(leaves, g)[1])
        pu = fk.lamb_finish_moments(leaves, g, norm, c)
        src = [None] * len(shapes)
        calls = {"lamb_finish_norms": lambda f: f(leaves, g),
                 "lamb_finish_moments": lambda f: f(leaves, g, norm, c),
                 "lamb_finish_apply": lambda f: f(leaves, pu, c, 4e-3, 0.999, src)}
        passes = {}
        for wrapper, call in calls.items():
            run_k = lambda: call(getattr(fk, wrapper))
            run_q = lambda: call(getattr(fk, wrapper + "_plain"))
            bound, by = bound_ms(FINISH_BYTES[wrapper] * n, 0.0, "float32")
            passes[wrapper] = {
                "ms": median_ms(run_k, hide_host=True),
                "plain_ms": median_ms(run_q, hide_host=True), "bound_ms": bound, "bound_by": by,
                "library_ms": None, "max_abs_err": errs["max_abs_err"],
                "ms_from_idle": median_ms(run_k), "plain_ms_from_idle": median_ms(run_q)}
        opt = Lamb(OptimizerConfig(warmup_steps=0), lr_factors)
        nest = lambda ts: _nested(dict(zip(paths, ts)))
        params, ema = nest(leaves.p), nest(leaves.e)
        state = LambState(nest(leaves.m), nest(leaves.v), 0, 0)
        gmap = dict(zip(paths, g))
        finish = lambda: opt.update(params, ema, state, gmap, True, 0.999)
        reset_counts()
        finish()
        torch.cuda.synchronize()
        launches = {w: v for w, v in read_counts().items() if v}
        check_finish_launches(launches, f"{name}: one finish")
        finish_ms, finish_device_ms = median_ms(finish), median_ms(finish, hide_host=True)
        with plain_path():
            finish_plain_ms = median_ms(finish)
            finish_plain_device_ms = median_ms(finish, hide_host=True)
        del params, ema, state, gmap, leaves, pu
        torch.cuda.empty_cache()
        adam_params = [torch.nn.Parameter(torch.zeros_like(t)) for t in g]
        for p_, g_ in zip(adam_params, g):
            p_.grad = g_
        adam = torch.optim.Adam(adam_params, lr=4e-3, fused=True)
        adam_ms = median_ms(adam.step, hide_host=True)
        del adam, adam_params, g
        torch.cuda.empty_cache()
        bound, _ = bound_ms(52 * n, 0.0, "float32")
        out[name] = {"leaves": len(shapes), "params": n, "bytes": 52 * n, "bound_ms": bound,
                     "finish_ms": finish_ms, "finish_plain_ms": finish_plain_ms,
                     "finish_device_ms": finish_device_ms,
                     "finish_plain_device_ms": finish_plain_device_ms,
                     "launches_a_finish": launches, "passes": passes,
                     "adam_fused_ms (Adam, one pass, not LAMB)": adam_ms, "checks": errs}
        log(f"  finish {name}: {len(shapes)} leaves, {n} parameters, {52 * n} bytes (bound "
            f"{bound:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s); a finish (Lamb.update) from an "
            f"idle card {finish_ms:.3f} ms with the kernels, {finish_plain_ms:.3f} ms plain "
            f"(the device's work {finish_device_ms:.3f} / {finish_plain_device_ms:.3f}); "
            f"launches a finish {launches}; passes, the device's work (from an idle card) ms, "
            "kernels / plain / bound: "
            + "; ".join(f"{w} {r['ms']:.3f} ({r['ms_from_idle']:.3f}) / {r['plain_ms']:.3f} "
                        f"({r['plain_ms_from_idle']:.3f}) / {r['bound_ms']:.3f}"
                        for w, r in passes.items())
            + f"; torch.optim.Adam(fused=True).step (Adam, one pass, not LAMB) {adam_ms:.3f} "
            f"ms; {card()}")
    out["card"] = card()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 20 took {out['wall_s']:.1f} s")
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
    log(f"== setup: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}; {card()}")
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
    log("== the LAMB finish's kernels vs plain versions (F0, F1, F2)")
    for clip_norm in (1.0, None):
        for nonfinite in (False, True):
            check_finish([(n,) for n in FINISH_SIZES], (1.0, 2.0, 0.5, 0.243),
                         f"leaves of {FINISH_SIZES} (leaf 1 no gradient, leaf 0 overwritten), "
                         f"clip {clip_norm}, NaN and inf {nonfinite}", SEED + 40, none=(1,),
                         overwrite=(0,), nonfinite=nonfinite, clip_norm=clip_norm)
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

    # 10. the streaming engine and server
    log("== serving: StreamingEngine (one CUDA graph a tick) and ASRServer, base-85M")
    serving = run_serving()

    # 11. the router over several engines and the clients
    log("== router and clients: MultiChipEngine, build_engine --num_chips, transcriber, "
        "measures, base-85M")
    router = run_router_clients()

    # 12. the beam serving path
    log("== beam: FastBeamDecoder, RNNTBeamDecoder, StreamingEngine(decoder='beam') with "
        "fusion, ASRServer --decoder beam, bench_serving --decoder beam, base-85M, W=4")
    beam = run_beam()

    # 13. the train step as the JAX trainer runs it by default
    log("== default training path: SpecAugment, random state passing, the packed joint, "
        "schedules, gradient noise, layer statistics, batch-norm; base-85M, A=2 x B=16, bf16")
    default = run_default_train()

    # 14. validation as val.py runs it
    log("== validation: val.validate on a manifest, a tokenizer, mel statistics and a "
        f"checkpoint, base-85M from {VAL_CONFIG}, fp32, kernels and plain path")
    validation = run_validation()

    # 15. the training CLI
    log("== training CLI: python -m caiman_asr_tpu_torch.train, base-85M from "
        f"{VAL_CONFIG}, bf16, A=2 x B={N_UTTS}, RSP, packing, SpecAugment, noise; resume, "
        "serving from the checkpoint, a short synthetic_e2e")
    cli = run_train_cli()
    torch.cuda.empty_cache()

    # 16. training over several processes
    log("== training over processes: python -m torch.distributed.run --standalone "
        f"--nproc_per_node {MH_RANKS} ... caiman_asr_tpu_torch.train --multihost, base-85M, "
        f"A=2 x B={MH_B} a rank; two ranks on one card over gloo: a smoke reading, not a "
        "scaling figure")
    multihost = run_multihost()
    torch.cuda.empty_cache()

    # 17. latency measurement and the data and evaluation tools
    log("== latency and tools: generate_gt_ctm (base-85M fp32, B=8; --segment_len), val.py "
        "--gt_ctm and measure_latency (base-85M, synthetic_e2e), val_multiple (2 checkpoints "
        "x 2 manifests), the .pt export and import, --read_from_tar in spm_train and "
        "generate_mel_stats")
    latency = run_latency_tools()
    torch.cuda.empty_cache()

    # 18. the rest of inference
    log("== the rest of inference: train_ngram and the kenlm binaries (fusion from each), "
        f"val.py --beam_parallel_procs {PAR_PROCS}, sweep_scale_factor, quantize: true "
        "(greedy validation, the CPU, the serving tick's CUDA graph)")
    lm_tools = run_lm_tools()
    torch.cuda.empty_cache()

    # 19. the pruned loss and the model-parallel train step
    log(f"== pruned and model-parallel: the pruned loss (base-85M bf16, B=16, S={PR_S}); the "
        f"vocab-parallel joint and train.main --model_parallel {VP_RANKS} in one "
        "torch.distributed.run launch of two ranks on one card over gloo (a smoke reading, not "
        f"a scaling one); synthetic_e2e --pruned {E2E_PRUNED}")
    pruned_tp = run_pruned_and_tp()
    torch.cuda.empty_cache()

    # 20. the fused LAMB finish at the models' leaves
    log("== the fused LAMB finish: its three passes at base-85M's and large-196M's leaves, "
        "kernels against plain versions, timed")
    finish = run_finish()

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
        **{w: (finish["base-85M"]["passes"][w], train_counts[w],
               f"{finish['base-85M']['leaves']} leaves, {finish['base-85M']['params']} "
               "parameters (base-85M), fp32", base_step) for w in FINISH_KERNELS},
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
        if wrapper == "lstm_recurrence":  # the serving path's own count
            sv = serving["streaming_vs_offline"]
            kernels[-1].update({
                "launches_serving": sv["launches"],
                "launches_serving_per": f"fp32 streaming of {sv['utterances']} utterances, "
                                        f"{sv['ticks']} ticks (phase 10)",
                "max_abs_err_serving": {d: max(c["max_abs_err"] for c in serving["k1_checks"]
                                               if c["dtype"] == d) for d in TOL}})
            rt = router["routers"][f"two engines on {ROUTER_DEVICES[0]}"]
            kernels[-1].update({
                "launches_router": rt["k1_launches"],
                "launches_router_per": "fp32 streaming of the smoke's utterances over two "
                                       "engines on one card (phase 11)",
                "launches_beam_offline": beam["offline_float32"]["k1"],
                "launches_beam_serving": beam["streaming_vs_offline"]["launches"],
                "launches_beam_per": "phase 12: the fp32 offline fast beam's encoder, and fp32 "
                                     f"beam streaming of the smoke's utterances "
                                     f"({beam['streaming_vs_offline']['ticks']} ticks)"})
        if wrapper in default["steps"][-1]["launches"]:  # phase 13's default step
            kernels[-1].update({
                "launches_default_train": default["steps"][-1]["launches"][wrapper],
                "launches_default_train_per": (
                    f"phase 13: one default train step of base-85M, A={DEFAULT_A} x "
                    f"B={N_UTTS}, bf16, RSP, packed to {default['pack_to']} rows")})
        if wrapper in validation["expected_launches"]:  # phase 14's validation
            kernels[-1].update({
                "launches_validation": validation["launches"][wrapper],
                "launches_validation_per": (
                    f"phase 14: val.validate --calc_loss, base-85M fp32, {N_UTTS} utterances "
                    f"in {validation['batches']} batches of {VAL_BATCH} (K1: 8 a decoded "
                    "batch, 10 a loss batch)")})
        if cli["launches"].get(wrapper):  # phase 15's 4-step CLI run
            kernels[-1].update({
                "launches_train_cli": cli["launches"][wrapper],
                "launches_train_cli_per": (
                    f"phase 15: train.main, base-85M bf16, {CLI_STEPS} steps of A=2 x "
                    f"B={N_UTTS} with validation every 2 ({N_UTTS} utterances, batches of "
                    f"{VAL_BATCH}) and a train-sample decode at step {CLI_STEPS}")})
        mh_counts = multihost["b"]["counts"]
        if mh_counts[0].get(wrapper):  # phase 16's two-rank run (b)
            kernels[-1].update({
                "launches_multihost": [c[wrapper] for c in mh_counts],
                "launches_multihost_per": (
                    f"phase 16 (b): train.main --multihost on {MH_RANKS} ranks of one card, "
                    f"each rank's count over {MH_STEPS} bf16 steps of A=2 x B={MH_B} on tar "
                    f"shards and one validation of its {MH_B} dev utterances")})
        if wrapper in ("lstm_recurrence", "joint_fwd"):  # phase 17's tools
            kernels[-1].update({
                "launches_latency_tools": {
                    tool: latency[key]["launches"].get(wrapper, 0)
                    for tool, key in (("generate_gt_ctm", "gt_ctm"),
                                      ("val_multiple", "val_multiple"))},
                "launches_latency_tools_per": (
                    f"phase 17: generate_gt_ctm, base-85M fp32, {N_UTTS} utterances in "
                    f"batches of {LT_B} (K1: 10 a batch); val_multiple --calc_loss over "
                    f"{latency['val_multiple']['jobs']} jobs (2 checkpoints x 2 manifests, "
                    f"batches of {VAL_BATCH})")})
        if wrapper == "lstm_recurrence":  # phase 18's tools
            kernels[-1].update({
                "launches_lm_tools": {"fused_fast_beam": lm_tools["a"]["k1"],
                                      "parallel_beam": lm_tools["b"]["launches"].get(
                                          "lstm_recurrence", 0),
                                      "sweep": lm_tools["c"]["launches"].get(
                                          "lstm_recurrence", 0),
                                      "quantized": lm_tools["d"]["launches"].get(
                                          "lstm_recurrence", 0)},
                "launches_lm_tools_per": (
                    f"phase 18: the fp32 fast beam (W=4) over {N_UTTS} utterances in batches "
                    f"of {VAL_BATCH} with no LM and with fusion from the ARPA, the PROBING and "
                    f"the TRIE file (K1 8 a batch); val.py --beam_parallel_procs {PAR_PROCS} on "
                    f"{PAR_UTTS} utterances (the parent's encoder, 8); sweep_scale_factor over "
                    f"{len(SWEEP_SCALES)} scales on the synthetic_e2e model; quantize: true "
                    "greedy validation (none: the quantized scan bypasses K1)")})
        pruned_launches = pruned_tp["a"]["launches"]
        if pruned_launches.get(wrapper):  # phase 19 (a)'s pruned step
            kernels[-1].update({
                "launches_pruned": pruned_launches[wrapper],
                "launches_pruned_per": (
                    f"phase 19 (a): one bf16 train step of base-85M on the pruned loss, A=1 x "
                    f"B={N_UTTS}, band {PR_S}: the banded joint on {pruned_tp['a']['rows']} rows "
                    f"(the dense {pruned_tp['a']['dense_rows']})")})
        vp_ranks = [r["counts"].get(wrapper, 0) for r in pruned_tp["b"]["ranks"]]
        tp_runs = pruned_tp["c"]["runs"]
        if any(vp_ranks) or any(c.get(wrapper) for run in tp_runs.values()
                                for c in run["counts"]):
            kernels[-1].update({
                "launches_tp": {"vp_joint": vp_ranks,
                                **{name: [c.get(wrapper, 0) for c in run["counts"]]
                                   for name, run in tp_runs.items()}},
                "launches_tp_per": (
                    f"phase 19: each of {VP_RANKS} ranks on one card; vp_joint: one forward and "
                    f"backward of the vocab-parallel joint at N={VP_N}, 4,352 classes a shard, "
                    f"the slab over {VP_KS} columns; fp32 / bf16 / pruned: train.main "
                    f"--model_parallel {VP_RANKS}, {TP_STEPS} steps of A=2 x B={TP_B} each (fp32 "
                    "with a validation, bf16 packed, the pruned loss unpacked)")})
        if wrapper in FINISH_KERNELS:  # phase 20 at large-196M's leaves
            lg = finish["large-196M"]
            kernels[-1].update({
                "ms_large": lg["passes"][wrapper]["ms"],
                "plain_ms_large": lg["passes"][wrapper]["plain_ms"],
                "bound_ms_large": lg["passes"][wrapper]["bound_ms"],
                "shape_large": f"{lg['leaves']} leaves, {lg['params']} parameters (large-196M), "
                               "fp32"})
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
    log("serving summary: " + json.dumps(serving))
    log("router and clients summary: " + json.dumps(router))
    log("beam summary: " + json.dumps(beam))
    log("default training summary: " + json.dumps(default))
    log("validation summary: " + json.dumps(validation))
    log("training CLI summary: " + json.dumps(cli))
    log("multihost summary: " + json.dumps(multihost))
    log("latency tools summary: " + json.dumps(latency))
    log("lm tools summary: " + json.dumps(lm_tools, default=str))
    log("pruned and model-parallel summary: " + json.dumps(pruned_tp, default=str))
    log("finish summary: " + json.dumps(finish))
    log("transcription summary: " + json.dumps({
        "base-85M": {d: sl[d] for d in ("float32", "bfloat16")},
        "large-196M": {d: large["slice"][d] for d in ("float32", "bfloat16")},
        "card": card()}))
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(card(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":  # a rank of phase 16 or 19
        sys.exit(rank_worker(sys.argv[2]))
    sys.exit(main())
