"""Builders for the train and validation entry points (the port of
``caiman_asr_tpu/setup/builders.py``): a config and the command line in;
the tokenizer, the model, the manifest loaders (the train one with its
sampler and noise), the feature pipelines and the decoder out. The
decoders themselves are built in one place, ``offline.build_decoder``;
``build_decoder`` here maps the flags onto it.

Over several processes (``parallel/mesh.py``) every loader is this rank's
shard: the manifest samplers' ``batch[rank::world]`` of each global batch,
the tar reader's every ``world``-th sample pair, rank and world being the
data rank and the data world (under ``--model_parallel`` the ranks of a
model group load the same rows). The HuggingFace source
(``data/hugging_face.py``, validation over local files) is built here; the
host beam over worker processes (``--beam_parallel_procs``) is built in
``val.py`` over ``decoding/parallel.py``.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from caiman_asr_tpu_torch.data.loader import AudioDataLoader, FeaturePipeline
from caiman_asr_tpu_torch.data.manifest import Utterance, load_manifests, utterances_from_dir
from caiman_asr_tpu_torch.data.sampler import (BucketingSampler, RandomSampler, SortedSampler,
                                              WeightedBucketingSampler)
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
                    sampling: Optional[float] = None, seed: Optional[int] = None) -> Tokenizer:
    """The config's tokenizer (or the one at ``override_path``); ``sampling``
    overrides the config's subword-sampling rate (validation passes 0);
    ``seed`` seeds the sampling's stream (None: fresh entropy)."""
    path = override_path or cfg.tokenizer.sentpiece_model
    if path is None or not Path(path).exists():
        raise FileNotFoundError(
            f"sentencepiece model not found: {path!r} "
            "(set tokenizer.sentpiece_model in the config or --tokenizer_model)")
    return Tokenizer(labels=list(cfg.tokenizer.labels), sentpiece_model=path,
                     sampling=cfg.tokenizer.sampling if sampling is None else sampling,
                     seed=seed)


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


def build_train_loader(utts, tokenizer, pipe: PipelineConfig, batch_size: int, seed: int,
                       args=None, rank: int = 0, world_size: int = 1) -> AudioDataLoader:
    """The train loader: ``batch_size`` utterances a microbatch on each of
    ``world_size`` ranks (this one ``rank``), drawn by
    the sampler the flags choose (``--train_manifest_ratios``,
    ``--relative_train_manifest_ratios`` or ``--canary_manifest_exponent``:
    the weighted bucketing sampler; ``--num_buckets 0``: the random one;
    else duration buckets), ``--randomize_first_n_epochs``, the noise of
    ``build_noise``, ``--prob_train_narrowband`` and ``--inspect_audio``."""
    ratio_modes = {
        "absolute_ratios": getattr(args, "train_manifest_ratios", None),
        "relative_ratios": getattr(args, "relative_train_manifest_ratios", None),
        "canary_exponent": getattr(args, "canary_manifest_exponent", None),
    }
    rand_first = getattr(args, "randomize_first_n_epochs", 0) or 0
    num_buckets = getattr(args, "num_buckets", 6)
    durations = [u.duration for u in utts]
    if any(v is not None for v in ratio_modes.values()):
        sampler = WeightedBucketingSampler(
            durations, [u.manifest_idx for u in utts], batch_size=batch_size,
            world_size=world_size, seed=seed, num_buckets=num_buckets,
            randomize_first_n_epochs=rand_first,
            **{k: v for k, v in ratio_modes.items() if v is not None})
    elif num_buckets == 0:
        # no duration grouping at all (the reference's --num_buckets 0)
        sampler = RandomSampler(durations, batch_size=batch_size, world_size=world_size,
                                seed=seed)
    else:
        sampler = BucketingSampler(durations, batch_size=batch_size, world_size=world_size,
                                   seed=seed, num_buckets=num_buckets,
                                   randomize_first_n_epochs=rand_first)
    background, babble = build_noise(args, pipe, seed)
    return AudioDataLoader(
        utts, sampler, tokenizer, pipe, rank=rank, train=True,
        normalize_config=normalize_config_from(pipe), seed=seed,
        background_noise=background, babble_noise=babble,
        prob_narrowband=getattr(args, "prob_train_narrowband", 0.0),
        inspect_audio_dir=(str(Path(args.output_dir) / "augmented_audio")
                           if getattr(args, "inspect_audio", False) else None))


def build_noise(args, pipe: PipelineConfig, seed: int):
    """(background, babble): a ``(NoiseDataset, NoiseSampler)`` pair when
    ``--prob_background_noise`` > 0 and ``--noise_dataset`` names a
    directory, and a babble ``NoiseSampler`` when ``--prob_babble_noise`` >
    0; each None otherwise. Both samplers draw from one generator seeded
    with ``(seed, 77)``."""
    if args is None:
        return None, None
    from caiman_asr_tpu_torch.data.noise import NoiseDataset, NoiseSampler

    rng = np.random.default_rng((seed, 77))
    background = None
    if getattr(args, "prob_background_noise", 0.0) > 0 and getattr(args, "noise_dataset", None):
        ds = NoiseDataset.from_spec(args.noise_dataset, pipe.logmel.sample_rate,
                                    hf_config=getattr(args, "noise_config", None),
                                    max_clips=getattr(args, "noise_max_clips", 2048) or None)
        background = (ds, NoiseSampler(args.prob_background_noise, rng,
                                       args.noise_initial_low, args.noise_initial_high))
    babble = None
    if getattr(args, "prob_babble_noise", 0.0) > 0:
        babble = NoiseSampler(args.prob_babble_noise, rng,
                              getattr(args, "noise_initial_low", 30),
                              getattr(args, "noise_initial_high", 60))
    return background, babble


def build_data_source_loader(args, cfg: Config, tokenizer, batch_size: int, train: bool,
                             seed: int = 0):
    """The loader over JSON manifests (``--train_manifests`` with ``train``,
    else ``--val_manifests``), over tar or zip shards (``--read_from_tar``:
    ``--train_tar_files`` / ``--val_tar_files``, beneath ``--dataset_dir``
    where relative), for validation with ``--use_hugging_face`` over a
    HuggingFace dataset (``--hugging_face_val_*``; training stays on the
    other two) or, with ``--val_from_dir``, a directory
    of audio and ``{stem}.txt`` pairs, with the same utterance filters;
    ``--n_utterances_only`` keeps a seeded random subset. ``seed`` seeds the
    train loader's sampler, augmentation and noise, and the tar reader's
    shuffle. Each is this process's shard (``parallel/mesh.data_rank``,
    ``data_world``: the ranks of a model group load the same rows)."""
    from caiman_asr_tpu_torch.parallel import mesh

    pipe = cfg.input_train if train else cfg.input_val
    rank, world = mesh.data_rank(), mesh.data_world()
    if getattr(args, "read_from_tar", False):
        from caiman_asr_tpu_torch.data.webdataset import (WebDatasetLoader, WebDatasetReader,
                                                          shard_paths)

        tars = shard_paths(args.dataset_dir,
                           args.train_tar_files if train else args.val_tar_files)
        # sharded over the ranks, where the JAX package has every host read
        # every sample (ROADMAP.md Queue 3)
        reader = WebDatasetReader(
            tars, sample_rate=pipe.logmel.sample_rate, seed=seed, shard_id=rank,
            num_shards=world, max_duration=pipe.dataset.max_duration if train else None,
            max_transcript_len=pipe.dataset.max_transcript_len if train else None)
        return WebDatasetLoader(reader, tokenizer, batch_size,
                                normalize_config=normalize_config_from(pipe, cfg.user_tokens),
                                drop_last=train)
    if getattr(args, "use_hugging_face", False) and not train:
        # validation only, as in the JAX package: training stays on manifests
        # or tar shards
        from caiman_asr_tpu_torch.data.hugging_face import HuggingFaceLoader, HuggingFaceReader

        reader = HuggingFaceReader(
            args.hugging_face_val_dataset, split=args.hugging_face_val_split,
            config=args.hugging_face_val_config,
            text_column=args.hugging_face_val_transcript_key,
            sample_rate=pipe.logmel.sample_rate, shard_id=rank, num_shards=world)
        return HuggingFaceLoader(reader, tokenizer, batch_size,
                                 normalize_config=normalize_config_from(pipe))
    if not train and getattr(args, "val_from_dir", False):
        root = Path(args.dataset_dir)
        utts = utterances_from_dir(
            root / args.val_audio_dir if args.val_audio_dir else root,
            (root / args.val_txt_dir) if args.val_txt_dir else None)
        # the manifest path's filters: over-long audio would otherwise be cut
        # and scored against the whole transcript
        utts = [u for u in utts if _keep(u, pipe.dataset)]
    else:
        utts = load_utterances(args.train_manifests if train else args.val_manifests,
                               args.dataset_dir, pipe)
    n_only = getattr(args, "n_utterances_only", None)
    if n_only is not None and len(utts) > n_only:
        # seeded shuffle, then truncate
        utts = random.Random(getattr(args, "seed", 1)).sample(utts, n_only)
    if train:
        loader = build_train_loader(utts, tokenizer, pipe, batch_size, seed, args,
                                    rank=rank, world_size=world)
    else:
        loader = build_val_loader(utts, tokenizer, pipe, batch_size,
                                  prob_narrowband=getattr(args, "prob_val_narrowband", 0.0),
                                  rank=rank, world_size=world)
    loader.norm_cfg = normalize_config_from(pipe, cfg.user_tokens)
    return loader


def build_val_loader(utts, tokenizer, pipe: PipelineConfig, batch_size: int,
                     prob_narrowband: float = 0.0, rank: int = 0, world_size: int = 1):
    """Sorted by duration (the least padding), no shuffling, the last
    batch kept; over several ranks each evaluates its shard of every
    sorted global batch of ``batch_size * world_size``."""
    sampler = SortedSampler([u.duration for u in utts], batch_size=batch_size,
                            world_size=world_size, pessimistic_first_batch=False,
                            drop_last=False)
    return AudioDataLoader(utts, sampler, tokenizer, pipe, rank=rank, train=False,
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
