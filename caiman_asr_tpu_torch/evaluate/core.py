"""The evaluation loop: loss, decode, WER (the port of
``caiman_asr_tpu/evaluate/core.py:39-275``).

A batch at a time: the host batch goes to the device, through the eval
``FeaturePipeline`` (dataset mel statistics at ``norm_ratio``), the optional
validation loss, the optional state-reset segmentation (long utterances cut
into overlapping lanes), the decoder, the two-clock token timestamps and the
offline endpointing (``evaluate/trim.py``); then detokenisation and the
normalised reference. After the loop: corpus WER, word timestamps, the CTM
and emission latency against a ground-truth CTM, the logged metrics and the
predictions JSON. Features reach the decoder as device tensors; only the
segmentation and the trimming read the host.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import torch

from caiman_asr_tpu_torch.data.text.normalize import NormalizeConfig, normalize_transcript
from caiman_asr_tpu_torch.decoding.response import (
    frame_responses_timesteps,
    frame_responses_to_tokens,
    fuse_partials,
)
from caiman_asr_tpu_torch.evaluate.state_resets import (
    StateResetsConfig,
    group_segment_lanes,
    merge_segments,
    segment_batch,
)
from caiman_asr_tpu_torch.evaluate.trim import EOSTrimConfig, trim_predictions
from caiman_asr_tpu_torch.evaluate.wer import ErrorRateKind, WERResult, word_error_rate
from caiman_asr_tpu_torch.latency.ctm import dump_ctm, measure_emission_latency
from caiman_asr_tpu_torch.latency.timestamp import (
    EOS,
    FullStamp,
    Silence,
    group_timestamps,
    user_perceived_time,
)


@dataclass
class EvalResult:
    wer: float
    scores: int
    num_words: int
    loss: Optional[float]
    hyps: List[str] = field(default_factory=list)
    refs: List[str] = field(default_factory=list)
    fnames: List[str] = field(default_factory=list)
    timestamps: List[List[int]] = field(default_factory=list)
    word_timestamps: Optional[list] = None  # List[SequenceTimestamp]
    latency_metrics: Optional[dict] = None
    # per-utterance Silence/EOS/Never (trim.py): how a live endpointer would
    # have terminated each utterance
    terminations: Optional[list] = None


def _two_clock_ts(resp):
    """[FullStamp(model, user_perceived)] a token: the user clock rewinds
    finals to the frame their characters became continuously visible as
    partials; decoders without partials stamp both clocks alike (plain
    ints)."""
    model_t = frame_responses_timesteps(resp)
    emit_t = frame_responses_timesteps(fuse_partials(resp))
    return [FullStamp(m, u) if m != u else m for m, u in zip(model_t, emit_t)]


def evaluate(
    model,
    decoder,
    loader,
    feat_pipeline,
    tokenizer,
    *,
    val_loss_fn=None,
    standardize_wer: bool = True,
    error_rate: ErrorRateKind = ErrorRateKind.WORD,
    normalize_config: Optional[NormalizeConfig] = None,
    charset: Optional[list] = None,
    dump_preds_dir: Optional[str | Path] = None,
    epoch: int = 0,
    step: int = 0,
    subset: str = "dev",
    logger=None,
    state_resets: Optional[StateResetsConfig] = None,
    ctm_path: Optional[str] = None,
    gt_ctm_path: Optional[str] = None,
    frame_width: float = 0.06,
    norm_ratio: float = 1.0,
    eos_vad_threshold: float = float("inf"),
    eos_trim: Optional[EOSTrimConfig] = None,
    pre_enc_width: Optional[float] = None,
) -> EvalResult:
    """One full evaluation over ``loader``. ``model``: the ``RNNT`` whose
    weights are evaluated, on the pipeline's device; ``decoder``: one of the
    port's decoders over it (``decode(feats, feat_lens) -> List[Dict[int,
    FrameResponses]]``); ``val_loss_fn``: ``training.step.make_val_loss_step``
    over the model, called with ``model.param_tree()``. The keyword
    arguments are the JAX function's.

    eos_vad_threshold / eos_trim: offline endpointing; every decode is
    trimmed where a live system would have terminated, and the
    per-utterance Silence/EOS/Never termination is recorded.
    pre_enc_width: stacked input-feature frame seconds (``feat_lens``' unit);
    defaults to frame_width / 2 (stack time factor 2)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "evaluation over several processes (evaluate/distributed.py) is not ported "
            "yet (ROADMAP.md Queue 1 item 4)")
    t0 = time.time()
    norm_cfg = normalize_config or NormalizeConfig()
    charset = charset if charset is not None else list(" abcdefghijklmnopqrstuvwxyz'")
    if pre_enc_width is None:
        pre_enc_width = frame_width / 2.0
    dev = feat_pipeline.device
    params = model.param_tree() if val_loss_fn is not None else None

    hyps: List[str] = []
    refs: List[str] = []
    fnames: List[str] = []
    tss: List[List[int]] = []
    pieces_list: List[List[str]] = []
    terminations: list = []
    loss_sum, loss_count = 0.0, 0.0

    with torch.inference_mode():
        for batch in loader.epoch(0):
            # norm_ratio 1.0: dataset stats (the streaming-compatible
            # endpoint); --norm_over_utterance evaluates legacy models at 0.0
            feats, feat_lens = feat_pipeline(torch.from_numpy(batch.audio).to(dev),
                                             torch.from_numpy(batch.audio_lens).to(dev),
                                             dataset_to_utt_ratio=norm_ratio)
            if val_loss_fn is not None:
                ls, n = val_loss_fn(params, {
                    "feats": feats, "feat_lens": feat_lens,
                    "txt": torch.from_numpy(batch.tokens).to(dev),
                    "txt_lens": torch.from_numpy(batch.token_lens).to(dev)})
                loss_sum += float(ls)
                loss_count += float(n)

            if state_resets is not None:
                # segment long utterances into extra lanes, decode, then
                # merge the per-utterance token streams
                seg_feats, seg_lens, counts = segment_batch(
                    feats.cpu().numpy(), feat_lens.cpu().numpy(), state_resets)
                responses = decoder.decode(torch.from_numpy(seg_feats).to(dev),
                                           torch.from_numpy(seg_lens).to(dev))
                per_utt = []
                for lo, hi in group_segment_lanes(counts):
                    seg_toks = [frame_responses_to_tokens(responses[i]) for i in range(lo, hi)]
                    seg_ts = [_two_clock_ts(responses[i]) for i in range(lo, hi)]
                    toks, ts, _ = merge_segments(seg_toks, seg_ts, None, state_resets)
                    per_utt.append((toks, ts))
            else:
                responses = decoder.decode(feats, feat_lens)
                per_utt = [(frame_responses_to_tokens(r), _two_clock_ts(r)) for r in responses]

            # offline endpointing: trim each decode where a live system would
            # have terminated (VAD silence / EOS), before detokenisation
            batch_toks, batch_ts, _, batch_term = trim_predictions(
                [toks for toks, _ in per_utt], [ts for _, ts in per_utt], None,
                pre_enc_width, frame_width, feat_lens.cpu().tolist(),
                eos_vad_threshold=eos_vad_threshold, eos_info=eos_trim)
            for b, (toks, ts) in enumerate(zip(batch_toks, batch_ts)):
                hyps.append(tokenizer.detokenize(toks))
                refs.append(normalize_transcript(batch.transcripts[b], charset, norm_cfg))
                fnames.append(batch.fnames[b])
                tss.append(ts)
                terminations.append(batch_term[b])
                pieces_list.append([tokenizer.id_to_piece(t).replace("▁", " ") for t in toks])

    wer_res: WERResult = word_error_rate(hyps, refs, standardize=standardize_wer,
                                         kind=error_rate)
    result = EvalResult(
        wer=wer_res.wer,
        scores=wer_res.scores,
        num_words=wer_res.num_words,
        loss=loss_sum / loss_count if loss_count else None,
        hyps=hyps,
        refs=refs,
        fnames=fnames,
        timestamps=tss,
        terminations=terminations,
    )

    # word-level timestamps, the CTM and emission latency against ground truth
    result.word_timestamps = group_timestamps(
        pieces_list, [[user_perceived_time(t) for t in ts] for ts in tss], hyps, terminations)
    if ctm_path is not None:
        last_emit = dump_ctm(fnames, result.word_timestamps, ctm_path, frame_width)
        if gt_ctm_path is not None:
            # real terminations feed the SIL/EOS endpoint latencies
            result.latency_metrics = measure_emission_latency(
                gt_ctm_path, ctm_path, frame_width=frame_width, last_emit_time=last_emit)
            if logger is not None and result.latency_metrics["n"]:
                logger.log((epoch, step),
                           {f"latency_{k}": v for k, v in result.latency_metrics.items()
                            if v is not None},
                           subset=subset)
    if logger is not None:
        metrics = {"wer": result.wer * 100.0, "took": time.time() - t0}
        if result.terminations and (eos_vad_threshold != float("inf") or eos_trim is not None):
            # the mix of termination kinds
            n = len(result.terminations)
            metrics["eos_frac"] = sum(isinstance(t, EOS) for t in result.terminations) / n
            metrics["sil_frac"] = sum(isinstance(t, Silence) for t in result.terminations) / n
            metrics["rem_frac"] = 1 - metrics["eos_frac"] - metrics["sil_frac"]
        if result.loss is not None:
            metrics["loss"] = result.loss
        logger.log((epoch, step), metrics, subset=subset)
    if dump_preds_dir is not None:
        out = Path(dump_preds_dir)
        out.mkdir(parents=True, exist_ok=True)
        payload = {
            "step": step,
            "wer": result.wer,
            "predictions": [{"fname": f, "hyp": h, "ref": r}
                            for f, h, r in zip(fnames, hyps, refs)],
        }
        (out / f"preds_step{step}.json").write_text(json.dumps(payload, indent=1))
    return result
