"""Validation and offline decoding entry point (the port of
``caiman_asr_tpu/val.py``).

Run:  python -m caiman_asr_tpu_torch.val --model_config ... --ckpt best.npz \\
        --val_manifests dev.json [--cpu]

The flags are the JAX entry point's; the checkpoint is a ``.npz`` in the JAX
package's format (its EMA weights unless ``--no_ema``). It runs on the card,
or on the CPU under ``--cpu``; without a GPU and without ``--cpu`` it raises.
The last line printed is ``{"wer": ..., "loss": ...}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
from pathlib import Path

from caiman_asr_tpu_torch.args.shared import (
    add_decoder_args,
    add_latency_args,
    add_shared_args,
    add_state_reset_args,
    add_wer_analysis_args,
)


def val_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="RNN-T validation (PyTorch / CUDA)")
    add_shared_args(parser)
    add_decoder_args(parser)
    add_state_reset_args(parser)
    add_latency_args(parser)
    add_wer_analysis_args(parser)
    parser.add_argument("--ckpt", "--checkpoint", type=str, default=None,
                        help="checkpoint to evaluate")
    parser.add_argument("--cpu", action="store_true",
                        help="force CPU execution (reference ValCPUSetup)")
    parser.add_argument("--use_ema", action="store_true", default=True)
    parser.add_argument("--no_ema", dest="use_ema", action="store_false")
    parser.add_argument("--calc_loss", "--calculate_loss", action="store_true")
    parser.add_argument("--nth_batch_only", type=int, default=None,
                        help="only evaluate the nth batch (0-based), useful "
                             "for debugging (reference args/val.py:119)")
    parser.add_argument(
        "--norm_over_utterance", action="store_true",
        help="normalize mel features with full-utterance stats instead of "
             "dataset stats — NOT streaming compatible; for evaluating "
             "legacy models (reference args/mel_feat_norm.py:43)")
    return parser


class _NthBatchLoader:
    """Evaluate only the nth batch (--nth_batch_only): a debugging aid for
    isolating a bad batch."""

    def __init__(self, loader, n: int):
        self._loader = loader
        self._n = n

    def epoch(self, i: int):
        return itertools.islice(self._loader.epoch(i), self._n, self._n + 1)

    def __getattr__(self, name):
        return getattr(self._loader, name)


def parallel_decoder_kwargs(args) -> dict:
    """The host beam's kwargs that reach the workers of
    ``--beam_parallel_procs``, the JAX package's to the letter
    (``caiman_asr_tpu/val.py:142-150``): the width, the pruning thresholds
    and the temperature, 1.4 where the flag keeps its default of 1.0. No
    n-gram, keywords, EOS strategy or symbol caps reach the workers: they
    decode with the beam's own defaults for those."""
    return dict(
        beam_width=args.beam_width,
        temperature=args.temperature if args.temperature != 1.0 else 1.4,
        beam_prune_score_thresh=args.beam_prune_score_thresh,
        beam_prune_topk_thresh=args.beam_prune_topk_thresh,
    )


def _evaluate(args, cfg, model, decoder, loader, val_fp, tokenizer, blank_idx, eos_idx,
              out_dir, logger, device):
    """``evaluate`` with the state resets, the offline endpointing and the
    latency settings that the flags and the config give."""
    from caiman_asr_tpu_torch.evaluate.core import evaluate
    from caiman_asr_tpu_torch.evaluate.state_resets import StateResetsConfig
    from caiman_asr_tpu_torch.evaluate.trim import EOSTrimConfig
    from caiman_asr_tpu_torch.setup.builders import normalize_config_from
    from caiman_asr_tpu_torch.training.step import make_val_loss_step

    state_resets = None
    if args.sr_segment and args.sr_segment > 0:
        frame_duration = (cfg.input_val.logmel.window_stride
                          * cfg.input_val.splicing.frame_subsampling)
        state_resets = StateResetsConfig.from_seconds(
            args.sr_segment, args.sr_overlap, frame_duration, cfg.rnnt.enc_stack_time_factor)

    # offline endpointing: cut hyps where a live system would have
    # terminated and record Silence/EOS/Never per utterance
    eos_trim = None
    if eos_idx is not None and eos_idx >= 0:
        eos_trim = EOSTrimConfig(eos_idx=eos_idx,
                                 eos_is_terminal=getattr(args, "eos_is_terminal", False),
                                 blank_idx=blank_idx)
    pre_enc_width = cfg.input_val.logmel.window_stride * cfg.input_val.splicing.frame_stacking
    result = evaluate(
        model,
        decoder,
        loader,
        val_fp,
        tokenizer,
        val_loss_fn=make_val_loss_step(model, blank_idx, device=device) if args.calc_loss
        else None,
        standardize_wer=cfg.input_val.dataset.standardize_wer,
        normalize_config=normalize_config_from(cfg.input_val),
        charset=list(cfg.tokenizer.labels),
        dump_preds_dir=(out_dir / "preds") if args.dump_preds else None,
        norm_ratio=0.0 if getattr(args, "norm_over_utterance", False) else 1.0,
        subset="dev",
        logger=logger,
        state_resets=state_resets,
        ctm_path=str(out_dir / "model.ctm") if args.dump_ctm else None,
        gt_ctm_path=args.gt_ctm,
        frame_width=(cfg.input_val.logmel.window_stride
                     * cfg.input_val.splicing.frame_subsampling
                     * cfg.rnnt.enc_stack_time_factor),
        eos_vad_threshold=getattr(args, "eos_vad_threshold", float("inf")),
        eos_trim=eos_trim,
        pre_enc_width=pre_enc_width,
    )
    return result


def validate(args=None):
    """Evaluate ``args.ckpt`` on the validation set; returns the
    ``EvalResult``."""
    from caiman_asr_tpu_torch.device import resolve_device
    from caiman_asr_tpu_torch.export.checkpointer import apply_params, load_checkpoint
    from caiman_asr_tpu_torch.log import init_log
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.setup.builders import (
        apply_input_overrides,
        build_data_source_loader,
        build_decoder,
        build_feature_pipelines,
        build_model,
        build_tokenizer,
        load_mel_stats,
    )
    from caiman_asr_tpu_torch.utils.user_tokens import get_user_token

    if args is None:
        args = val_arg_parser().parse_args()
    device = resolve_device("cpu" if getattr(args, "cpu", False) else "cuda")
    out_dir = Path(args.output_dir)
    logger = init_log(out_dir, enable_tensorboard=False,
                      log_file=getattr(args, "log_file", None),
                      timestamp=getattr(args, "timestamp", None))

    if getattr(args, "calculate_emission_latency", False):
        if not args.gt_ctm:
            raise SystemExit(
                "--calculate_emission_latency requires --gt_ctm reference "
                "CTMs (generate them with latency/generate_gt_ctm.py)")
        if args.decoder == "beam" and args.beam_no_partials:
            raise SystemExit(
                "Cannot calculate emission latency for beam search if "
                "--beam_no_partials is set")
    cfg = apply_input_overrides(load_config(args.model_config), args)
    # the loss targets are tokenised without subword sampling: with the
    # config's rate they would change from run to run (ROADMAP.md Queue 3)
    tokenizer = build_tokenizer(cfg, args.tokenizer_model, sampling=0.0)
    model, blank_idx = build_model(cfg, tokenizer, device=device)
    model.eval()
    if args.ckpt:
        loaded, ema, _, meta = load_checkpoint(args.ckpt)
        use_ema = args.use_ema and ema is not None
        apply_params(model.param_tree(), ema if use_ema else loaded)
        print(f"Loaded {'EMA ' if use_ema else ''}weights "
              f"from {args.ckpt} (step {meta.get('step', '?')})")

    mel_stats = load_mel_stats(args.mel_stats_path)
    _, val_fp = build_feature_pipelines(cfg, mel_stats, device=device)
    loader = build_data_source_loader(args, cfg, tokenizer, args.val_batch_size, train=False)
    if args.nth_batch_only is not None:
        loader = _NthBatchLoader(loader, args.nth_batch_only)
    try:
        eos_idx = get_user_token("eos", cfg.user_tokens, tokenizer)
    except ValueError as e:
        print(f"WARNING: eos token disabled: {e}")
        eos_idx = None
    if args.decoder == "beam" and (args.beam_parallel_procs > 1 or args.beam_parallel_procs == -1):
        from caiman_asr_tpu_torch.decoding.parallel import ParallelDecoder

        decoder = ParallelDecoder(
            model, args.model_config, args.tokenizer_model, args.ckpt,
            decoder_kwargs=parallel_decoder_kwargs(args), nprocs=args.beam_parallel_procs,
            min_batch_per_proc=args.beam_min_decode_batch_size_per_proc,
        )
    else:
        decoder = build_decoder(model, blank_idx, tokenizer, args, cfg, eos_idx=eos_idx)
    try:
        result = _evaluate(args, cfg, model, decoder, loader, val_fp, tokenizer, blank_idx,
                           eos_idx, out_dir, logger, device)
    finally:
        if hasattr(decoder, "close"):
            decoder.close()
    if args.wer_breakdown:
        from caiman_asr_tpu_torch.evaluate.wer_breakdown import print_wer_breakdown

        print_wer_breakdown(result.hyps, result.refs, args.breakdown_chars)
    if args.punctuation_error_rate:
        from caiman_asr_tpu_torch.evaluate.punctuation_error_rate import punctuation_error_rate

        counts = punctuation_error_rate(result.refs, result.hyps)
        for sym, c in counts.items():
            print(f"punct {sym!r}: rate={c.rate:.3f} "
                  f"(ok={c.correct} del={c.deletions} ins={c.insertions} "
                  f"sub={c.substitutions})")
    print(json.dumps({"wer": result.wer, "loss": result.loss}))
    return result


if __name__ == "__main__":
    validate()
