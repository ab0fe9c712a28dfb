"""Featurisation on the device: log-mel -> normalise -> splice (->
SpecAugment in training) -> time-major (``FeaturePipeline`` in
``caiman_asr_tpu/data/loader.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.device import resolve_device
from caiman_asr_tpu_torch.models.config import PipelineConfig
from caiman_asr_tpu_torch.ops.features import spec_augment, stack_subsample_frames
from caiman_asr_tpu_torch.ops.logmel import LogMelFrontend, normalize_batch


class FeaturePipeline:
    """Audio [B, S] -> features [T, B, n_mels * frame_stacking] and lengths.

    ``mel_stats`` is ``(means, stds)`` over the dataset, each [n_mels];
    without them the blend ratio is forced to 0 (per-utterance stats).
    ``dataset_to_utt_ratio`` is the blend (``training/schedules.MelNormRamp``
    in training). With ``train``, SpecAugment (the pipeline's
    ``specaugment``, when it has one) masks the spliced features, its bands
    drawn from the call's generator.
    """

    def __init__(self, pipeline: PipelineConfig = PipelineConfig(), mel_stats=None,
                 *, train: bool = False, device="cuda"):
        self.pipe = pipeline
        self.train = train
        self.device = resolve_device(device)
        self.frontend = LogMelFrontend(pipeline.logmel, device=self.device)
        self.mel_means = self.mel_stds = None
        if mel_stats is not None:
            self.mel_means, self.mel_stds = (
                torch.as_tensor(np.asarray(s), dtype=torch.float32, device=self.device)
                for s in mel_stats
            )

    def __call__(
        self,
        audio: torch.Tensor,
        audio_lens: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        dataset_to_utt_ratio: float = 0.0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats, frame_lens = self.frontend(audio, audio_lens, generator)
        ratio = dataset_to_utt_ratio if self.mel_means is not None else 0.0
        feats = normalize_batch(feats, frame_lens, self.mel_means, self.mel_stds, ratio)
        sp = self.pipe.splicing
        feats, frame_lens = stack_subsample_frames(
            feats, frame_lens, sp.frame_stacking, sp.frame_subsampling
        )
        if self.train and self.pipe.specaugment is not None:
            feats = spec_augment(feats, frame_lens, self.pipe.specaugment, generator)
        return feats.permute(2, 0, 1), frame_lens
