"""Model, feature, data and training configuration, mirroring the JAX
package's YAML configs (``caiman_asr_tpu/models/config.py``): ``rnnt:``,
``tokenizer:``, each input pipeline's ``audio_dataset``,
``filterbank_features``, ``frame_splicing`` and ``spec_augment``,
``grad_noise_scheduler``, ``user_tokens`` and ``ngram:``. The file is read
by ``models/yaml_lite``, with or without PyYAML installed."""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from caiman_asr_tpu_torch.models import yaml_lite
from caiman_asr_tpu_torch.ops.features import SpecAugmentConfig
from caiman_asr_tpu_torch.ops.logmel import LogMelConfig


@dataclass(frozen=True)
class RNNTModelConfig:
    """Model hyperparameters (the ``rnnt:`` block)."""

    in_feats: int = 240
    enc_n_hid: int = 1024
    enc_pre_rnn_layers: int = 2
    enc_post_rnn_layers: int = 6
    enc_stack_time_factor: int = 2
    enc_dropout: float = 0.1
    enc_batch_norm: bool = False
    enc_freeze: bool = False
    pred_n_hid: int = 512
    pred_rnn_layers: int = 2
    pred_dropout: float = 0.3
    pred_batch_norm: bool = False
    joint_n_hid: int = 768
    joint_dropout: float = 0.3
    forget_gate_bias: Optional[float] = 1.0
    custom_lstm: bool = True
    quantize: bool = False
    enc_rw_dropout: float = 0.0
    pred_rw_dropout: float = 0.0
    hidden_hidden_bias_scale: float = 0.0
    weights_init_scale: float = 1.0
    enc_lr_factor: float = 1.0
    pred_lr_factor: float = 1.0
    joint_enc_lr_factor: float = 1.0
    joint_pred_lr_factor: float = 1.0
    joint_net_lr_factor: float = 1.0
    hard_activations: bool = False


@dataclass(frozen=True)
class TokenizerConfig:
    """The ``tokenizer:`` block."""

    sentpiece_model: Optional[str] = None
    labels: tuple = tuple(" abcdefghijklmnopqrstuvwxyz'")
    sampling: float = 0.0


@dataclass(frozen=True)
class DatasetConfig:
    """An input pipeline's ``audio_dataset`` block: what the host loader
    and the evaluation read (transcript normalisation, filters, the train
    augmentations)."""

    sample_rate: int = 16000
    trim_silence: bool = False
    normalize_transcripts: str = "lowercase"
    standardize_wer: bool = True
    standardize_text: bool = False
    replacements: Optional[list] = None
    remove_tags: bool = True
    error_rate: str = "word"
    max_duration: Optional[float] = None
    min_duration: Optional[float] = None
    max_transcript_len: Optional[int] = None
    speed_perturbation: Optional[dict] = None


@dataclass(frozen=True)
class FrameSplicingConfig:
    frame_stacking: int = 3
    frame_subsampling: int = 3


@dataclass(frozen=True)
class PipelineConfig:
    """One of ``input_train`` / ``input_val``; ``specaugment`` is None
    where the block has no ``spec_augment``."""

    logmel: LogMelConfig = LogMelConfig()
    splicing: FrameSplicingConfig = FrameSplicingConfig()
    specaugment: Optional[SpecAugmentConfig] = None
    dataset: DatasetConfig = DatasetConfig()


@dataclass(frozen=True)
class GradNoiseConfig:
    """The ``grad_noise_scheduler`` block; noise is on when
    ``noise_level`` > 0 (``training/schedules.GradNoiseSchedule``)."""

    noise_level: float = 0.0
    decay_const: float = 0.55
    start_step: int = 2000


@dataclass(frozen=True)
class NgramConfig:
    """The ``ngram:`` block: the beam's n-gram and its fusion scale."""

    ngram_path: Optional[str] = None
    scale_factor: float = 0.05


@dataclass(frozen=True)
class Config:
    rnnt: RNNTModelConfig = RNNTModelConfig()
    tokenizer: TokenizerConfig = TokenizerConfig()
    input_train: PipelineConfig = PipelineConfig()
    input_val: PipelineConfig = PipelineConfig()
    stats_path: Optional[str] = None
    ngram: NgramConfig = NgramConfig()
    grad_noise: GradNoiseConfig = GradNoiseConfig()
    user_tokens: Dict[str, str] = field(default_factory=dict)


def _fill(cls, d: Optional[dict], where: str):
    """Construct dataclass ``cls`` from ``d``, rejecting unknown keys."""
    d = dict(d or {})
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"Unknown config keys in {where}: {sorted(unknown)}")
    if isinstance(d.get("labels"), list):
        d["labels"] = tuple(d["labels"])
    if d.get("replacements") is not None:
        d["replacements"] = list(d["replacements"])
    return cls(**d)


# filterbank_features key -> LogMelConfig field
_LOGMEL_KEYMAP = {
    "sample_rate": "sample_rate",
    "window_size": "window_size",
    "window_stride": "window_stride",
    "n_fft": "n_fft",
    "n_filt": "n_mels",
    "dither": "dither",
}
_LOGMEL_IGNORED = {"normalize", "window", "stats_path"}
# reference-only toggles with no counterpart here
_RNNT_IGNORED = {
    "joint_apex_transducer", "joint_apex_relu_dropout", "custom_lstm",
    "gpu_unavailable",
}


def _pipeline(d: Optional[dict]) -> tuple[PipelineConfig, Optional[str]]:
    d = dict(d or {})
    fb = dict(d.get("filterbank_features") or {})
    logmel = {}
    for k, v in fb.items():
        if k in _LOGMEL_IGNORED:
            continue
        if k not in _LOGMEL_KEYMAP:
            raise ValueError(f"Unknown filterbank_features key: {k}")
        logmel[_LOGMEL_KEYMAP[k]] = v
    splicing = _fill(FrameSplicingConfig, d.get("frame_splicing"), "frame_splicing")
    spec = d.get("spec_augment")
    specaugment = _fill(SpecAugmentConfig, spec, "spec_augment") if spec else None
    dataset = _fill(DatasetConfig, d.get("audio_dataset"), "audio_dataset")
    return (PipelineConfig(LogMelConfig(**logmel), splicing, specaugment, dataset),
            fb.get("stats_path"))


def load_raw(path: str | Path) -> dict:
    """The config file as nested dicts and lists (anchors and merges
    resolved), as the JAX package keeps it beside its ``Config``."""
    return copy.deepcopy(yaml_lite.safe_load(Path(path).read_text()))


def load_config(path: str | Path, max_duration: Optional[float] = None) -> Config:
    """Load a YAML config (anchors and merges supported). ``max_duration``
    (the trainer's ``--max_duration``) replaces ``input_train``'s
    ``audio_dataset.max_duration``."""
    raw = load_raw(path)
    if max_duration is not None:
        raw.setdefault("input_train", {}).setdefault("audio_dataset", {})[
            "max_duration"] = max_duration
    train, stats_train = _pipeline(raw.get("input_train"))
    val, stats_val = _pipeline(raw.get("input_val"))
    rnnt = {k: v for k, v in (raw.get("rnnt") or {}).items() if k not in _RNNT_IGNORED}
    return Config(
        rnnt=_fill(RNNTModelConfig, rnnt, "rnnt"),
        tokenizer=_fill(TokenizerConfig, raw.get("tokenizer"), "tokenizer"),
        input_train=train,
        input_val=val,
        stats_path=stats_train or stats_val,
        ngram=_fill(NgramConfig, raw.get("ngram"), "ngram"),
        grad_noise=_fill(GradNoiseConfig, raw.get("grad_noise_scheduler"),
                         "grad_noise_scheduler"),
        user_tokens=dict(raw.get("user_tokens") or {}),
    )
