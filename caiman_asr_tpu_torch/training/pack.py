"""Host-side lattice sizes for the packed joint
(``caiman_asr_tpu/training/pack.py``).

The packed loss (``ops/transducer_loss._packed_joint_scores``) runs the
joint over ``pack_to`` rows, which must be at least the number of valid
(t, u) lattice positions. That number follows from the batch's audio and
token lengths by the feature pipeline's length arithmetic:

  audio samples -> log-mel frames  (initial / final padding, (len - win)//hop + 1)
                -> spliced frames  (ceil(frames / subsampling))
                -> encoder frames  (ceil(frames / stack_time_factor))
  valid positions = sum_i enc_frames_i * (tokens_i + 1)

``pack_cap`` rounds it up to a quantum, or gives None where packing would
not pay. All numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from caiman_asr_tpu_torch.models.config import PipelineConfig, RNNTModelConfig

PACK_QUANTUM = 16384


def enc_frame_lens(audio_lens: np.ndarray, pipe: PipelineConfig,
                   model_cfg: RNNTModelConfig) -> np.ndarray:
    """Encoder output lengths [B] from raw audio sample lengths [B]."""
    cfg = pipe.logmel
    lens = np.asarray(audio_lens, np.int64)
    if cfg.initial_padding:
        lens = lens + cfg.n_initial_zeros
    lens = lens + int(cfg.final_padding_secs * cfg.sample_rate)
    frames = np.maximum(0, (lens - cfg.win_length) // cfg.hop_length + 1)
    sub = pipe.splicing.frame_subsampling
    if sub > 1:
        frames = -(-frames // sub)
    return -(-frames // model_cfg.enc_stack_time_factor)


def lattice_nvalid(audio_lens: np.ndarray, token_lens: np.ndarray, pipe: PipelineConfig,
                   model_cfg: RNNTModelConfig) -> int:
    """The number of valid (t, u) lattice positions of one microbatch."""
    enc = enc_frame_lens(audio_lens, pipe, model_cfg)
    return int(np.sum(enc * (np.asarray(token_lens, np.int64) + 1)))


def pack_cap(nvalid: int, dense_n: int, quantum: Optional[int] = None,
             threshold: float = 0.9) -> Optional[int]:
    """``nvalid`` rounded up to a multiple of ``quantum`` (default
    ``max(PACK_QUANTUM, ceil(dense_n / 8))``, so that a bucket shape sees at
    most about 7 caps) and at most ``dense_n``; None when that cap is at
    least ``threshold`` of the dense size."""
    if quantum is None:
        quantum = max(PACK_QUANTUM, -(-dense_n // 8))
    cap = min(dense_n, -(-nvalid // quantum) * quantum)
    if cap >= threshold * dense_n:
        return None
    return cap
