"""Offline transcription: raw audio -> per-frame responses.

The decode half of the JAX package's validation (``val.py`` /
``evaluate/core.py``) without manifests, tokenizer training or WER:
featurise (eval pipeline) -> the decoder's ``decode`` (the encoder, then
the search) -> one ``{frame: FrameResponses}`` per utterance. Decoders, as
``caiman_asr_tpu/setup/builders.py:405-531`` builds them:

- ``greedy``: ``GreedyDecoder``, the lock-step loop on the device (on the
  card, chunks of CUDA graph replays with one host read a chunk);
- ``fast_beam``: ``FastBeamDecoder``, the fixed-expansion beam on the device
  (the same chunked replays), n-gram fusion through device tables over the
  tokenizer's pieces and keyword boosting through the keyword tables;
- ``beam``: ``RNNTBeamDecoder``, the adaptive host-scheduled beam, its
  scoring rounds on the device, the n-gram and the keyword trie on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
from caiman_asr_tpu_torch.data.tokenizer import piece_table
from caiman_asr_tpu_torch.decoding.response import FrameResponses
from caiman_asr_tpu_torch.device import resolve_device
from caiman_asr_tpu_torch.models.config import PipelineConfig

DECODERS = ("greedy", "beam", "fast_beam")


def build_decoder(
    model,
    decoder: str = "greedy",
    *,
    tokenizer=None,
    pipeline: PipelineConfig = PipelineConfig(),
    max_symbols_per_step: Optional[int] = None,
    beam_width: int = 4,
    temperature: Optional[float] = None,
    ngram_lm=None,
    ngram_scale_factor: float = 0.05,
    keywords=None,
    beam_prune_score_thresh: float = 0.4,
    beam_prune_topk_thresh: float = 1.5,
    beam_final_emission_thresh: float = float("inf"),
):
    """A decoder over ``model`` (blank: the last class). ``ngram_lm``: an
    ``lm.NGramLM``, fused at ``ngram_scale_factor`` (off at <= 0);
    ``keywords``: a ``keywords.Keywords``. The beams need a tokenizer with
    ``id_to_piece``. ``max_symbols_per_step`` defaults to 30 (greedy) and 8
    (the beams), ``temperature`` to 1.0 (greedy) and 1.4 (the beams). The
    final-emission threshold is in seconds, turned into encoder frames of
    the pipeline's window stride x frame subsampling x stack time."""
    from caiman_asr_tpu_torch.decoding.beam import RNNTBeamDecoder
    from caiman_asr_tpu_torch.decoding.fast_beam import FastBeamDecoder
    from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder

    if decoder not in DECODERS:
        raise ValueError(f"decoder={decoder!r}: one of {DECODERS}")
    blank = model.n_classes - 1
    if decoder == "greedy":
        if ngram_lm is not None or keywords is not None:
            raise ValueError("n-gram fusion and keyword boosting need a beam decoder")
        return GreedyDecoder(model, blank, max_symbols_per_step=max_symbols_per_step or 30,
                             temperature=temperature or 1.0, tokenizer=tokenizer)
    if tokenizer is None or not hasattr(tokenizer, "id_to_piece"):
        raise ValueError(f"decoder={decoder!r} needs a tokenizer with id_to_piece")
    msym = max_symbols_per_step or 8
    temp = temperature or 1.4
    if decoder == "beam":
        return RNNTBeamDecoder(
            model, blank, tokenizer, beam_width=beam_width, max_symbols_per_step=msym,
            temperature=temp, beam_prune_score_thresh=beam_prune_score_thresh,
            beam_prune_topk_thresh=beam_prune_topk_thresh,
            final_emission_thresh=beam_final_emission_thresh, ngram_lm=ngram_lm,
            ngram_alpha=ngram_scale_factor, keywords=keywords)
    from caiman_asr_tpu_torch.keywords.device_table import build_keyword_tables
    from caiman_asr_tpu_torch.lm.device_table import build_device_tables

    pieces = piece_table(tokenizer, model.n_classes)
    tables = kw_tables = None
    if ngram_lm is not None and ngram_scale_factor > 0:
        tables = build_device_tables(ngram_lm, pieces, skip_ids=[blank])
    if keywords is not None:
        kw_tables = build_keyword_tables(keywords, pieces, skip_ids=[blank])
    fe = float(beam_final_emission_thresh)
    frame = (pipeline.logmel.window_stride * pipeline.splicing.frame_subsampling
             * model.cfg.enc_stack_time_factor)
    return FastBeamDecoder(
        model, blank, beam_width=beam_width, max_symbols_per_step=msym, temperature=temp,
        tokenizer=tokenizer, ngram_lm=tables,
        ngram_alpha=ngram_scale_factor if tables is not None else 0.0, keywords=kw_tables,
        score_thresh=beam_prune_score_thresh, topk_thresh=beam_prune_topk_thresh,
        final_emission_frames=max(1, round(fe / frame)) if fe != float("inf") else None)


@torch.inference_mode()
def transcribe(
    model,
    audio,
    audio_lens,
    mel_stats=None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    pipeline: PipelineConfig = PipelineConfig(),
    generator: Optional[torch.Generator] = None,
    dataset_to_utt_ratio: float = 1.0,
    max_symbols_per_step: Optional[int] = None,
    tokenizer=None,
    decoder: str = "greedy",
    **decoder_kw,
) -> List[Dict[int, FrameResponses]]:
    """Transcribe a zero-padded batch of audio [B, S] with lengths [B].

    ``model`` is an ``RNNT`` whose parameters already live on ``device``.
    Features are computed in fp32 and the model runs in ``dtype``; the blank
    is the last class. ``mel_stats`` (dataset means and stds) are blended in
    at ``dataset_to_utt_ratio`` (1.0: dataset stats only, the evaluation
    default); ``generator`` draws the dither noise. ``decoder`` and
    ``decoder_kw`` (the beam width, the n-gram and its scale, keywords, the
    pruning thresholds) as ``build_decoder`` takes them.
    """
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev != dev and not (param_dev.type == dev.type == "cuda" and dev.index is None):
        raise ValueError(f"model parameters are on {param_dev}, transcribe asked for {dev}")
    dec = build_decoder(model, decoder, tokenizer=tokenizer, pipeline=pipeline,
                        max_symbols_per_step=max_symbols_per_step, **decoder_kw)
    audio = torch.as_tensor(audio, device=dev)
    audio_lens = torch.as_tensor(audio_lens, device=dev)
    feats, feat_lens = FeaturePipeline(pipeline, mel_stats, device=dev)(
        audio, audio_lens, generator, dataset_to_utt_ratio
    )
    return dec.decode(feats.to(dtype), feat_lens)
