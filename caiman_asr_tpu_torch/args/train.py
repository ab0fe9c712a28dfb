"""Training CLI arguments (reference: args/train.py:23-415).

The port's copy of ``caiman_asr_tpu/args/train.py``: every flag and
default, so launch scripts carry over. The YAML dataset spec is read by
``models/yaml_lite``.
"""

from __future__ import annotations

import argparse

from caiman_asr_tpu_torch.args.shared import (
    add_decoder_args,
    add_shared_args,
    add_state_reset_args,
)


def train_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="RNN-T training (PyTorch / CUDA)")
    add_shared_args(parser)
    add_decoder_args(parser)
    add_state_reset_args(parser)

    training = parser.add_argument_group("training setup")
    training.add_argument("--training_steps", type=int, default=100000)
    training.add_argument(
        "--no_lattice_packing", action="store_true",
        help="disable the packed-joint loss path (pack the O(N*K) joint to "
             "valid lattice positions when batches are ragged enough)",
    )
    training.add_argument(
        "--pruned_loss_range", type=int, default=0,
        help="0 (default) = exact dense transducer loss; N > 0 = two-stage "
             "pruned loss (k2-style): a factored simple joint prunes the "
             "label lattice to a width-N band before the full joint runs — "
             "~(U+1)/N less joint compute/memory (ops/pruned_loss.py)",
    )
    training.add_argument(
        "--simple_loss_scale", type=float, default=0.5,
        help="weight of the auxiliary simple (factored) loss when "
             "--pruned_loss_range > 0 (icefall convention)",
    )
    training.add_argument("--warmup_steps", type=int, default=1632)
    training.add_argument("--hold_steps", type=int, default=18000)
    training.add_argument("--half_life_steps", type=int, default=10880)
    training.add_argument("--train_manifests", type=str, nargs="+", default=[])
    training.add_argument("--train_manifest_ratios", "--train_manifests_ratios", type=float, nargs="+",
                          default=None, help="absolute epoch share per manifest")
    training.add_argument("--relative_train_manifest_ratios", type=float,
                          nargs="+", default=None)
    training.add_argument("--canary_manifest_exponent", "--canary_exponent", type=float, default=None)
    training.add_argument(
        "--model_parallel", type=int, default=1,
        help="shard the joint vocab projection over this many devices "
             "(tensor parallelism via the vocab-parallel loss); the "
             "remaining devices form the data axis",
    )
    training.add_argument(
        "--log_layer_stats", action="store_true",
        help="log per-layer weight/grad norm, std and grad-max each "
             "log_frequency step (reference log/logging_layers.py); computed "
             "on the device inside the train step",
    )
    training.add_argument("--multihost", action="store_true",
                          help="data parallelism over torch.distributed, one process a card "
                               "(implied under torch.distributed.run); --global_batch_size "
                               "is then each process's")
    training.add_argument("--coordinator_address", type=str, default=None,
                          help="outside torch.distributed.run: rank 0's host:port, or an "
                               "init URL (tcp://, file://)")
    training.add_argument("--num_hosts", type=int, default=None,
                          help="outside torch.distributed.run: the number of processes")
    training.add_argument("--host_id", type=int, default=None,
                          help="outside torch.distributed.run: this process's rank")
    training.add_argument("--profiler", action="store_true",
                          help="capture a torch.profiler trace + phase timings")
    training.add_argument("--timings_frequency", type=int, default=500)

    optim = parser.add_argument_group("optimization setup")
    optim.add_argument("--global_batch_size", type=int, default=1024)
    optim.add_argument("--grad_accumulation_batches", type=int, default=8)
    optim.add_argument("--lr", "--learning_rate", type=float, default=4e-3)
    optim.add_argument("--min_lr", "--min_learning_rate", type=float, default=4e-4)
    optim.add_argument("--weight_decay", type=float, default=1e-2)
    optim.add_argument("--clip_norm", type=float, default=1.0)
    optim.add_argument("--beta1", type=float, default=0.9)
    optim.add_argument("--beta2", type=float, default=0.999)
    optim.add_argument("--ema", type=float, default=0.999)
    optim.add_argument("--no_amp", action="store_true",
                       help="disable bf16 mixed precision (f32 compute)")
    optim.add_argument("--weights_init_scale", type=float, default=0.5)
    optim.add_argument("--hidden_hidden_bias_scale", "--hidden_hidden_bias_scaled", type=float, default=None)

    ckpt = parser.add_argument_group("checkpointing")
    ckpt.add_argument("--resume", action="store_true")
    ckpt.add_argument("--fine_tune", action="store_true")
    ckpt.add_argument("--ckpt", "--checkpoint", type=str, default=None)
    ckpt.add_argument("--allow_partial_checkpoint", action="store_true")
    ckpt.add_argument("--save_frequency", type=int, default=5000)
    ckpt.add_argument("--val_frequency", type=int, default=1000)
    ckpt.add_argument("--log_frequency", type=int, default=25)
    ckpt.add_argument("--prediction_frequency", type=int, default=1000)
    ckpt.add_argument("--die_if_wer_bad", action="store_true")
    ckpt.add_argument("--skip_state_dict_check", action="store_true",
                      help="allow serving-bundle export for non-base/large shapes")

    pen = parser.add_argument_group("loss penalties")
    pen.add_argument("--delay_penalty", type=str, default="0.0",
                     help='float, or "linear_schedule" for StepSchedule')
    pen.add_argument("--dp_initial_value", type=float, default=0.0)
    pen.add_argument("--dp_final_value", type=float, default=0.01)
    pen.add_argument("--dp_toggle_step", type=int, default=25000)
    pen.add_argument("--dp_wer_threshold", type=float, default=None)
    pen.add_argument("--star_penalty", type=str, default=None,
                     help='float, or "linear_schedule" for StepSchedule '
                          "(reference args/star.py)")
    pen.add_argument("--star_initial_value", type=float, default=0.75)
    pen.add_argument("--star_final_value", type=float, default=1.0)
    pen.add_argument("--star_toggle_step", type=int, default=None)
    pen.add_argument("--star_wer_threshold", type=float, default=0.2)
    pen.add_argument("--eos_penalty", type=float, default=0.0)

    norm = parser.add_argument_group("mel normalization ramp")
    norm.add_argument("--norm_ramp_start_step", type=int, default=None)
    norm.add_argument("--norm_ramp_end_step", type=int, default=None)
    norm.add_argument("--norm_use_global_stats", action="store_true",
                      help="dataset mel stats from step 0 (no blend ramp; "
                           "reference args/mel_feat_norm.py:13)")
    norm.add_argument("--norm_starting_ratio", type=float, default=0.0,
                      help="initial dataset_to_utt blend ratio in [0, 1] "
                           "before the ramp starts (reference "
                           "args/mel_feat_norm.py:19)")

    parser.add_argument(
        "--num_buckets", type=int, default=6,
        help="duration-bucketing granularity: shuffle window of "
             "batch_size*num_buckets utterances sorted by length "
             "(reference data/dali/sampler.py:645-713); 0 selects the "
             "fully-random sampler",
    )
    parser.add_argument(
        "--randomize_first_n_epochs", type=int, default=0,
        help="completely randomize the first n epochs regardless of "
             "bucketing (reference args/train.py:233)",
    )
    parser.add_argument(
        "--train_dataset_yaml", type=str, default=None,
        help="YAML dataset spec {datasets: {name: {manifest, weight}}}; "
             "mutually exclusive with --train_manifests / ratio flags "
             "(reference args/train.py:247, data/schema.py)",
    )
    parser.add_argument(
        "--skip_val_loss", action="store_true",
        help="only calculate WER, not loss, on the validation set "
             "(reference args/train.py:396)",
    )
    parser.add_argument(
        "--dont_save_at_the_end", action="store_true",
        help="skip the final 'last' checkpoint save "
             "(reference args/train.py:186)",
    )
    parser.add_argument(
        "--log_verbose_utterance_statistics", action="store_true",
        help="expensive per-window utterance statistics (duration "
             "percentiles, token-length stats) in the step logs "
             "(reference args/train.py:402)",
    )

    noise = parser.add_argument_group("noise augmentation")
    noise.add_argument("--prob_background_noise", type=float, default=0.25)
    noise.add_argument("--prob_babble_noise", type=float, default=0.0)
    noise.add_argument("--noise_delay_steps", type=int, default=4896)
    noise.add_argument("--noise_ramp_steps", type=int, default=4896)
    noise.add_argument("--noise_initial_low", type=int, default=30)
    noise.add_argument("--noise_initial_high", type=int, default=60)
    noise.add_argument(
        "--prob_train_narrowband", type=float, default=0.0,
        help="probability of 8 kHz-resimulating a training utterance "
             "(reference args/train.py:389, dali/pipeline.py:407)",
    )
    noise.add_argument("--noise_dataset", type=str, default=None,
                       help="local directory of background-noise audio files "
                            "(or an HF hub dataset name in connected "
                            "environments; reference defaults to "
                            "Myrtle/CAIMAN-ASR-BackgroundNoise)")
    noise.add_argument("--use_noise_audio_folder", action="store_true",
                       help="treat --noise_dataset as a local audio folder "
                            "(reference args/noise_augmentation.py:79; here "
                            "local directories are auto-detected, so this "
                            "flag is accepted for script compatibility)")
    noise.add_argument("--noise_config", type=str, default=None,
                       help="HF hub config name for a hub-hosted noise "
                            "dataset (reference args/noise_augmentation.py:72)")
    noise.add_argument("--noise_max_clips", type=int, default=2048,
                       help="cap on hub-hosted noise clips decoded into host "
                            "RAM (the streaming HF path materializes clips; "
                            "local directories decode lazily); 0 = unlimited")

    rsp = parser.add_argument_group("random state passing")
    rsp.add_argument("--rsp_delay", type=int, default=None)
    rsp.add_argument("--rsp_seq_len_freq", type=int, nargs="+", default=[99, 0, 1],
                     help="relative frequency of 1x,2x,3x,... batch concatenation")

    return parser


def resolve_train_dataset_yaml(args) -> None:
    """Expand ``--train_dataset_yaml`` into train_manifests +
    relative_train_manifest_ratios, validating the schema
    (reference args/train.py:418-445 + data/schema.py:3-15:
    ``{datasets: {<name>: {manifest: str, weight?: float >= 0}}}``;
    unknown keys inside a dataset entry are purged, not rejected)."""
    path = getattr(args, "train_dataset_yaml", None)
    if not path:
        return
    if getattr(args, "train_manifests", None):
        raise SystemExit(
            "Cannot provide both --train_dataset_yaml and --train_manifests."
        )
    for flag in ("train_manifest_ratios", "relative_train_manifest_ratios",
                 "canary_manifest_exponent"):
        if getattr(args, flag, None) is not None:
            raise SystemExit(
                f"Cannot provide both --train_dataset_yaml and --{flag}."
            )
    from pathlib import Path

    from caiman_asr_tpu_torch.models import yaml_lite

    raw = yaml_lite.safe_load(Path(path).read_text())
    if not isinstance(raw, dict) or not isinstance(raw.get("datasets"), dict):
        raise ValueError(
            f"Invalid YAML format in {path}: expected a top-level "
            "'datasets' mapping"
        )
    manifests, weights = [], []
    for name, entry in raw["datasets"].items():
        if not isinstance(entry, dict) or "manifest" not in entry:
            raise ValueError(
                f"Invalid YAML format: dataset {name!r} must be a mapping "
                "with a 'manifest' key"
            )
        if not isinstance(entry["manifest"], str):
            raise ValueError(f"Invalid YAML format: {name}.manifest must be a string")
        w = entry.get("weight", 1.0)
        if not isinstance(w, (int, float)) or w < 0:
            raise ValueError(
                f"Invalid YAML format: {name}.weight must be a float >= 0"
            )
        manifests.append(entry["manifest"])
        weights.append(float(w))
    if not manifests:
        raise ValueError("No valid datasets found in YAML.")
    args.train_manifests = manifests
    args.relative_train_manifest_ratios = weights
