"""Offline greedy transcription: raw audio -> per-frame responses.

The decode half of the JAX package's validation (``val.py`` /
``evaluate/core.py``) without manifests, tokenizer training or WER:
featurise (eval pipeline) -> ``GreedyDecoder.decode`` (encoder, then the
lock-step greedy loop on the device: on the card, chunks of CUDA graph
replays with one host read a chunk) -> one ``{frame: FrameResponses}`` per
utterance.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder
from caiman_asr_tpu_torch.decoding.response import FrameResponses
from caiman_asr_tpu_torch.device import resolve_device
from caiman_asr_tpu_torch.models.config import PipelineConfig


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
    max_symbols_per_step: int = 30,
    tokenizer=None,
) -> List[Dict[int, FrameResponses]]:
    """Transcribe a zero-padded batch of audio [B, S] with lengths [B].

    ``model`` is an ``RNNT`` whose parameters already live on ``device``.
    Features are computed in fp32 and the model runs in ``dtype``; the blank
    is the last class. ``mel_stats`` (dataset means and stds) are blended in
    at ``dataset_to_utt_ratio`` (1.0: dataset stats only, the evaluation
    default); ``generator`` draws the dither noise.
    """
    dev = resolve_device(device)
    param_dev = next(model.parameters()).device
    if param_dev != dev and not (param_dev.type == dev.type == "cuda" and dev.index is None):
        raise ValueError(f"model parameters are on {param_dev}, transcribe asked for {dev}")
    audio = torch.as_tensor(audio, device=dev)
    audio_lens = torch.as_tensor(audio_lens, device=dev)
    feats, feat_lens = FeaturePipeline(pipeline, mel_stats, device=dev)(
        audio, audio_lens, generator, dataset_to_utt_ratio
    )
    decoder = GreedyDecoder(
        model, model.n_classes - 1, max_symbols_per_step=max_symbols_per_step,
        tokenizer=tokenizer,
    )
    return decoder.decode(feats.to(dtype), feat_lens)
