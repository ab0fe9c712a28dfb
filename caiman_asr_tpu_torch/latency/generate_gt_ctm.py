"""Generate ground-truth word-level CTMs via RNN-T Viterbi forced alignment
(the port of ``caiman_asr_tpu/latency/generate_gt_ctm.py``; any trained
RNN-T checkpoint aligns its own data through the lattice,
``latency/forced_align.py``).

The resulting CTM is the ground truth that ``val.py --gt_ctm`` consumes for
emission-latency measurement, and that ``latency/measure_latency.py`` holds a
model's CTM against.

Run: python -m caiman_asr_tpu_torch.latency.generate_gt_ctm \\
       --model_config cfg.yaml --ckpt best.npz --dataset_dir DATA \\
       --manifests dev.json --output_ctm gt.ctm [--cpu]

It runs on the card, or on the CPU under ``--cpu``; without a GPU and
without ``--cpu`` it raises. The checkpoint is a ``.npz`` in the JAX
package's format; its EMA weights are aligned with where it has them. The
transcripts are tokenised without subword sampling.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def _segmented_alignment(model, feats, feat_lens, batch, blank_idx, seg_frames):
    """Encode one long utterance (B=1) in segments carrying the LSTM
    streaming state, which equals encoding it whole, then align on the
    concatenated encoder output."""
    from caiman_asr_tpu_torch.latency.forced_align import viterbi_alignment_from_enc

    dev = feats.device
    T = int(np.asarray(torch.as_tensor(feat_lens).cpu())[0])
    state = None
    fs = []
    for s in range(0, T, seg_frames):
        seg = feats[s: min(s + seg_frames, T)]
        f, fl, state = model.encode(seg, torch.tensor([seg.shape[0]], device=dev), state)
        fs.append(f[:, : int(fl[0])])
    f = torch.cat(fs, dim=1)
    f_lens = torch.tensor([f.shape[1]], device=dev)
    g, _, _ = model.predict(torch.as_tensor(np.asarray(batch.tokens), device=dev))
    return viterbi_alignment_from_enc(model, f, f_lens, g, batch.tokens, batch.token_lens,
                                      blank_idx)


def gt_ctm_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="forced-alignment ground-truth CTM")
    p.add_argument("--model_config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--dataset_dir", default=".")
    p.add_argument("--manifests", nargs="+", required=True)
    p.add_argument("--output_ctm", required=True)
    p.add_argument("--mel_stats_path", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_utts", type=int, default=None)
    p.add_argument(
        "--segment_len", type=int, default=0,
        help="Minutes per encoder segment for long audio (reference "
             "forced_align.py:288-321). 0 = encode whole utterances. Unlike "
             "the reference's stateless CTC chunks, segments here carry the "
             "LSTM streaming state, so segmented encoding is exact; "
             "utterances are processed one at a time in this mode.")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def main(argv=None):
    args = gt_ctm_arg_parser().parse_args(argv)

    from caiman_asr_tpu_torch.device import resolve_device
    from caiman_asr_tpu_torch.export.checkpointer import apply_params, load_checkpoint
    from caiman_asr_tpu_torch.latency.ctm import to_ctm
    from caiman_asr_tpu_torch.latency.forced_align import (
        alignment_to_ctm_entries,
        viterbi_alignment,
    )
    from caiman_asr_tpu_torch.latency.timestamp import (
        Never,
        PerWordTimestamp,
        SequenceTimestamp,
    )
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.setup.builders import (
        build_feature_pipelines,
        build_model,
        build_tokenizer,
        build_val_loader,
        load_mel_stats,
        load_utterances,
    )

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_config(args.model_config)
    # no subword sampling: the ground truth is the transcript's one
    # segmentation (ROADMAP.md Queue 3)
    tokenizer = build_tokenizer(cfg, args.tokenizer_model, sampling=0.0)
    model, blank_idx = build_model(cfg, tokenizer, device=device)
    model.eval()
    loaded, ema, _, _ = load_checkpoint(args.ckpt)
    apply_params(model.param_tree(), ema if ema is not None else loaded)

    mel_stats = load_mel_stats(args.mel_stats_path)
    _, val_fp = build_feature_pipelines(cfg, mel_stats, device=device)
    utts = load_utterances(args.manifests, args.dataset_dir, cfg.input_val)
    if args.max_utts:
        utts = utts[: args.max_utts]
    seg_frames = 0
    if args.segment_len:
        feat_secs = (cfg.input_val.logmel.window_stride
                     * cfg.input_val.splicing.frame_subsampling)
        seg_frames = int(round(args.segment_len * 60.0 / feat_secs))
        stf = cfg.rnnt.enc_stack_time_factor
        seg_frames -= seg_frames % stf  # keep StackTime groups intact
        args.batch_size = 1  # exact per-utterance state carry
    loader = build_val_loader(utts, tokenizer, cfg.input_val, args.batch_size)

    frame_width = (cfg.input_val.logmel.window_stride
                   * cfg.input_val.splicing.frame_subsampling
                   * cfg.rnnt.enc_stack_time_factor)
    out = Path(args.output_ctm)
    out.write_text("")
    n = 0
    for batch in loader.epoch(0):
        with torch.no_grad():
            feats, feat_lens = val_fp(torch.from_numpy(batch.audio).to(device),
                                      torch.from_numpy(batch.audio_lens).to(device),
                                      dataset_to_utt_ratio=1.0)
        if seg_frames and feats.shape[0] > seg_frames:
            frames = _segmented_alignment(model, feats, feat_lens, batch, blank_idx,
                                          seg_frames)
        else:
            frames = viterbi_alignment(model, feats, feat_lens, batch.tokens,
                                       batch.token_lens, blank_idx)
        for b, fr in enumerate(frames):
            toks = [int(t) for t in batch.tokens[b, : batch.token_lens[b]]]
            rows = alignment_to_ctm_entries(fr, toks, tokenizer, frame_width)
            seq = SequenceTimestamp(
                [PerWordTimestamp(word, int(start / frame_width), int(end / frame_width) - 1)
                 for start, end, word in rows],
                Never(),
            )
            to_ctm(seq, str(out), batch.fnames[b], frame_width)
            n += 1
    print(f"wrote {out} ({n} utterances)")


if __name__ == "__main__":
    main()
