"""Builders for the validation entry point (the validation half of
``caiman_asr_tpu/setup/builders.py``): a config and the command line in;
the tokenizer, the model, the manifest loader, the feature pipelines and
the decoder out. The decoders themselves are built in one place,
``offline.build_decoder``; ``build_decoder`` here maps the flags onto it.

The webdataset and HuggingFace sources, parallel beam decoding and the
train loader raise, naming the ``ROADMAP.md`` item that will port them.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from caiman_asr_tpu_torch.data.loader import AudioDataLoader, FeaturePipeline
from caiman_asr_tpu_torch.data.manifest import Utterance, load_manifests, utterances_from_dir
from caiman_asr_tpu_torch.data.sampler import SortedSampler
from caiman_asr_tpu_torch.data.text.normalize import NormalizeConfig, NormalizeLevel
from caiman_asr_tpu_torch.data.tokenizer import Tokenizer
from caiman_asr_tpu_torch.models.config import Config, PipelineConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.utils.user_tokens import get_all_user_tokens

_LEVELS = {
    "identity": NormalizeLevel.IDENTITY,
    "scrub": NormalizeLevel.SCRUB,
    "lowercase": NormalizeLevel.LOWERCASE,
    "unicode": NormalizeLevel.UNICODE,
    "full": NormalizeLevel.FULL,
}


def build_tokenizer(cfg: Config, override_path: Optional[str] = None,
                    sampling: Optional[float] = None) -> Tokenizer:
    """The config's tokenizer (or the one at ``override_path``); ``sampling``
    overrides the config's subword-sampling rate (validation passes 0)."""
    path = override_path or cfg.tokenizer.sentpiece_model
    if path is None or not Path(path).exists():
        raise FileNotFoundError(
            f"sentencepiece model not found: {path!r} "
            "(set tokenizer.sentpiece_model in the config or --tokenizer_model)")
    return Tokenizer(labels=list(cfg.tokenizer.labels), sentpiece_model=path,
                     sampling=cfg.tokenizer.sampling if sampling is None else sampling)


def build_model(cfg: Config, tokenizer: Tokenizer, args=None, *, device="cuda"):
    """(model, blank index): an ``RNNT`` on ``device`` with the blank as its
    last class (the tokenizer's pieces, then the blank); ``args`` may
    override ``weights_init_scale`` and ``hidden_hidden_bias_scale``."""
    rnnt_cfg = cfg.rnnt
    if args is not None:
        overrides = {k: getattr(args, k) for k in ("weights_init_scale",
                                                   "hidden_hidden_bias_scale")
                     if getattr(args, k, None) is not None}
        if overrides:
            rnnt_cfg = dataclasses.replace(rnnt_cfg, **overrides)
    return RNNT(rnnt_cfg, tokenizer.num_labels + 1, device=device), tokenizer.num_labels


def apply_input_overrides(cfg: Config, args) -> Config:
    """The command line's featuriser overrides: ``--turn_off_initial_padding``
    and ``--val_final_padding_secs`` (by default 0.24 s of trailing silence
    on validation audio, to flush the decoder as a live server does; a
    non-zero config value wins when the flag is not passed)."""
    if args is None:
        return cfg
    input_train, input_val = cfg.input_train, cfg.input_val
    if getattr(args, "turn_off_initial_padding", False):
        input_train = dataclasses.replace(
            input_train, logmel=dataclasses.replace(input_train.logmel, initial_padding=False))
        input_val = dataclasses.replace(
            input_val, logmel=dataclasses.replace(input_val.logmel, initial_padding=False))
    if hasattr(args, "val_final_padding_secs"):
        pad = args.val_final_padding_secs
        if pad is None and input_val.logmel.final_padding_secs == 0.0:
            pad = 0.24
        if pad is not None and pad != input_val.logmel.final_padding_secs:
            input_val = dataclasses.replace(
                input_val, logmel=dataclasses.replace(input_val.logmel, final_padding_secs=pad))
    if input_train is cfg.input_train and input_val is cfg.input_val:
        return cfg
    return dataclasses.replace(cfg, input_train=input_train, input_val=input_val)


def normalize_config_from(pipe: PipelineConfig,
                          user_tokens: Optional[dict] = None) -> NormalizeConfig:
    return NormalizeConfig(
        level=_LEVELS.get(pipe.dataset.normalize_transcripts, NormalizeLevel.FULL),
        remove_tags=pipe.dataset.remove_tags,
        replacements=pipe.dataset.replacements or [],
        user_symbols=tuple(get_all_user_tokens(user_tokens).values()),
    )


def _keep(u: Utterance, ds) -> bool:
    return ((ds.max_duration is None or u.duration <= ds.max_duration)
            and (ds.min_duration is None or u.duration >= ds.min_duration)
            and (ds.max_transcript_len is None or len(u.transcript) <= ds.max_transcript_len))


def load_utterances(manifests: Sequence[str], dataset_dir: str,
                    pipe: PipelineConfig) -> List[Utterance]:
    ds = pipe.dataset
    return load_manifests(
        [Path(dataset_dir) / m if not Path(m).is_absolute() else Path(m) for m in manifests],
        max_duration=ds.max_duration, min_duration=ds.min_duration,
        max_transcript_len=ds.max_transcript_len)


def build_data_source_loader(args, cfg: Config, tokenizer, batch_size: int, train: bool):
    """The loader over JSON manifests (``--val_manifests``) or, with
    ``--val_from_dir``, a directory of audio and ``{stem}.txt`` pairs, with
    the same utterance filters; ``--n_utterances_only`` keeps a seeded random
    subset."""
    if getattr(args, "read_from_tar", False):
        raise NotImplementedError(
            "--read_from_tar (the webdataset loader) is not ported yet (ROADMAP.md Queue 1 "
            "item 3)")
    if getattr(args, "use_hugging_face", False):
        raise NotImplementedError(
            "--use_hugging_face (the HuggingFace loader) is not ported yet (ROADMAP.md "
            "Queue 1 item 3)")
    if train:
        raise NotImplementedError(
            "the train loader is not ported yet (ROADMAP.md Queue 1 item 4, the training "
            "entry point)")
    pipe = cfg.input_val
    if getattr(args, "val_from_dir", False):
        root = Path(args.dataset_dir)
        utts = utterances_from_dir(
            root / args.val_audio_dir if args.val_audio_dir else root,
            (root / args.val_txt_dir) if args.val_txt_dir else None)
        # the manifest path's filters: over-long audio would otherwise be cut
        # and scored against the whole transcript
        utts = [u for u in utts if _keep(u, pipe.dataset)]
    else:
        utts = load_utterances(args.val_manifests, args.dataset_dir, pipe)
    n_only = getattr(args, "n_utterances_only", None)
    if n_only is not None and len(utts) > n_only:
        # seeded shuffle, then truncate
        utts = random.Random(getattr(args, "seed", 1)).sample(utts, n_only)
    if getattr(args, "multihost", False):
        raise NotImplementedError(
            "evaluation over several processes is not ported yet (ROADMAP.md Queue 1 item 4)")
    loader = build_val_loader(utts, tokenizer, pipe, batch_size,
                              prob_narrowband=getattr(args, "prob_val_narrowband", 0.0))
    loader.norm_cfg = normalize_config_from(pipe, cfg.user_tokens)
    return loader


def build_val_loader(utts, tokenizer, pipe: PipelineConfig, batch_size: int,
                     prob_narrowband: float = 0.0):
    """Sorted by duration (the least padding), no shuffling, the last
    batch kept."""
    sampler = SortedSampler([u.duration for u in utts], batch_size=batch_size,
                            pessimistic_first_batch=False, drop_last=False)
    return AudioDataLoader(utts, sampler, tokenizer, pipe, train=False,
                           normalize_config=normalize_config_from(pipe),
                           prob_narrowband=prob_narrowband)


def load_mel_stats(path: Optional[str]):
    """Dataset mel statistics (means, stds) from an ``.npz`` holding
    ``melmeans`` and ``melvars``."""
    if path is None:
        return None
    z = np.load(path)
    means = np.asarray(z["melmeans"], np.float32)
    var = np.asarray(z["melvars"], np.float32)
    return means, np.sqrt(var)


def build_feature_pipelines(cfg: Config, mel_stats=None, *, device="cuda"
                            ) -> Tuple[FeaturePipeline, FeaturePipeline]:
    """(train, eval) pipelines on ``device``."""
    return (FeaturePipeline(cfg.input_train, mel_stats, train=True, device=device),
            FeaturePipeline(cfg.input_val, mel_stats, train=False, device=device))


def build_eos_strategy(args, eos_idx: Optional[int]):
    """``--eos_decoding``: none, ignore, blank or predict (with
    ``--eos_alpha`` / ``--eos_beta``); None without an EOS token."""
    from caiman_asr_tpu_torch.decoding.eos import EOSBlank, EOSIgnore, EOSPredict

    mode = getattr(args, "eos_decoding", "none") if args is not None else "none"
    if mode == "none" or eos_idx is None or eos_idx < 0:
        return None
    if mode == "ignore":
        return EOSIgnore(eos_idx)
    if mode == "blank":
        return EOSBlank(eos_idx)
    return EOSPredict(eos_idx, args.eos_alpha, args.eos_beta)


def build_decoder(model, blank_idx, tokenizer, args, cfg: Optional[Config] = None,
                  eos_idx: Optional[int] = None):
    """The ``--decoder`` (greedy, beam or fast_beam) through
    ``offline.build_decoder``, with the n-gram (``--ngram_path`` or the
    config's, unless ``--skip_ngram``), keywords, pruning thresholds and the
    EOS strategy from the flags. The beams default to temperature 1.4 where
    the flag keeps its default of 1.0, and to 8 symbols a step."""
    from caiman_asr_tpu_torch.offline import build_decoder as offline_decoder

    if blank_idx != model.n_classes - 1:
        raise ValueError(f"the blank must be the last class, got {blank_idx}")
    if args is None:
        return offline_decoder(model, "greedy", tokenizer=tokenizer)
    eos_strategy = build_eos_strategy(args, eos_idx)
    name = args.decoder
    max_inputs = int(getattr(args, "max_inputs_per_batch", 1e7))
    common = dict(tokenizer=tokenizer, eos_strategy=eos_strategy,
                  max_symbol_per_sample=args.max_symbol_per_sample,
                  fuzzy_topk_logits=args.fuzzy_topk_logits, max_inputs_per_batch=max_inputs)
    if name == "greedy":
        return offline_decoder(model, "greedy", max_symbols_per_step=args.max_symbols_per_step,
                               temperature=args.temperature, **common)
    if name == "beam" and (args.beam_parallel_procs > 1 or args.beam_parallel_procs == -1):
        raise NotImplementedError(
            "--beam_parallel_procs > 1 (decoding/parallel.py) is not ported yet (ROADMAP.md "
            "Queue 1 item 5)")

    ngram_lm = None
    ngram_path = args.ngram_path or (cfg.ngram.ngram_path if cfg else None)
    if ngram_path and not getattr(args, "skip_ngram", False):
        if not Path(ngram_path).exists():
            raise FileNotFoundError(
                f"N-gram not found at {ngram_path}. Ensure you have a valid n-gram, or pass "
                "the `--skip_ngram` argument to disable n-grams during validation.")
        from caiman_asr_tpu_torch.lm.ngram import NGramLM

        ngram_lm = NGramLM.load(ngram_path)
    keywords = None
    if getattr(args, "keyword_boost_path", None):
        from caiman_asr_tpu_torch.keywords.process import load_keywords

        keywords = load_keywords(args.keyword_boost_path)
    scale = args.ngram_scale_factor
    if scale is None:
        scale = cfg.ngram.scale_factor if cfg else 0.05
    pipeline = cfg.input_val if cfg is not None else PipelineConfig()
    return offline_decoder(
        model, name, pipeline=pipeline, max_symbols_per_step=args.max_symbols_per_step or 8,
        beam_width=args.beam_width,
        temperature=args.temperature if args.temperature != 1.0 else 1.4,
        ngram_lm=ngram_lm, ngram_scale_factor=scale, keywords=keywords,
        beam_prune_score_thresh=args.beam_prune_score_thresh,
        beam_prune_topk_thresh=args.beam_prune_topk_thresh,
        beam_final_emission_thresh=args.beam_final_emission_thresh,
        eos_is_terminal=getattr(args, "eos_is_terminal", False),
        eos_vad_threshold=getattr(args, "eos_vad_threshold", float("inf")),
        user_token_ids=[i for i in [eos_idx] if i is not None and i >= 0],
        return_partials=not args.beam_no_partials, **common)
