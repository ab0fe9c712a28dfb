"""Shared CLI arguments (reference: args/shared.py:19-210, args/decoder.py).

Grouped per concern like the reference; flags keep the reference's names
wherever the concept carries over so users can port launch scripts.

The port's copy of ``caiman_asr_tpu/args/shared.py``.
"""

from __future__ import annotations

import argparse


def add_shared_args(parser: argparse.ArgumentParser):
    io = parser.add_argument_group("io")
    io.add_argument("--model_config", type=str, default="configs/testing-1023sp.yaml")
    io.add_argument("--output_dir", type=str, default="/tmp/caiman_asr_tpu_out")
    io.add_argument("--dataset_dir", "--data_dir", type=str, default=".")
    io.add_argument("--val_manifests", type=str, nargs="+", default=[])
    io.add_argument("--max_duration", type=float, default=None)
    io.add_argument("--seed", type=int, default=1)
    io.add_argument("--tokenizer_model", type=str, default=None,
                    help="Override config sentpiece_model path (.model or .json)")
    io.add_argument("--tensorboard", action="store_true")
    io.add_argument("--log_file", type=str, default=None,
                    help="Path for the JSONL metrics logfile "
                         "(default: <output_dir>/log_<timestamp>.jsonl)")
    io.add_argument("--timestamp", type=str, default=None,
                    help="Timestamp string to use in log/args filenames "
                         "(default: current time)")
    io.add_argument("--skip_init", action="store_true",
                    help="Do not re-initialise once-only state (reference "
                         "flag for relaunched processes; accepted for "
                         "launch-script parity)")
    io.add_argument("--dump_preds", action="store_true")
    io.add_argument("--val_batch_size", type=int, default=16)
    io.add_argument("--mel_stats_path", type=str, default=None,
                    help="npz with melmeans/melvars dataset statistics")

    parser.add_argument("--val_from_dir", action="store_true",
                        help="validate on a directory of audio + {stem}.txt "
                             "pairs instead of JSON manifests")
    parser.add_argument("--val_audio_dir", type=str, default=None,
                        help="audio directory (relative to --dataset_dir)")
    parser.add_argument("--val_txt_dir", type=str, default=None,
                        help="transcript directory (defaults to the audio dir)")
    parser.add_argument(
        "--inspect_audio", action="store_true",
        help="debug: dump every fully-augmented utterance as wav under "
             "output_dir/augmented_audio (reference dali/pipeline.py:142)")
    parser.add_argument(
        "--n_utterances_only", type=int, default=None,
        help="debug: keep a seeded random subset of N utterances "
             "(reference semantics: shuffle then truncate, "
             "data/dali/utils.py:149-163)")
    parser.add_argument(
        "--max_inputs_per_batch", type=float, default=1e7,
        help="auto batch reduction: split the decode encoder batch so "
             "T*B_sub*feats stays under this (reference "
             "rnnt/unbatch_encoder.py:14-47)",
    )
    parser.add_argument(
        "--prob_val_narrowband", type=float, default=0.0,
        help="probability of 8 kHz-resimulating a validation utterance "
             "(reference args/shared.py:35)",
    )
    parser.add_argument(
        "--turn_off_initial_padding", action="store_true",
        help="disable the default (window_size - window_stride) seconds of "
             "leading silence that matches the asr-server's behaviour "
             "(reference args/shared.py:21)",
    )
    parser.add_argument(
        "--val_final_padding_secs", type=float, default=None,
        help="pad validation audio with this much trailing silence so the "
             "streaming decoder flushes (reference args/shared.py:29; "
             "default: the config's input_val value, else 0.24 s)",
    )
    src = parser.add_argument_group("data source")
    src.add_argument("--read_from_tar", action="store_true",
                     help="read webdataset tar shards instead of JSON manifests")
    src.add_argument("--train_tar_files", type=str, nargs="+", default=[])
    src.add_argument("--val_tar_files", type=str, nargs="+", default=[])
    src.add_argument("--use_hugging_face", "--use_hf", action="store_true")
    src.add_argument("--hugging_face_val_dataset", "--hf_val_dataset", type=str, default=None)
    src.add_argument("--hugging_face_val_config", "--hf_val_config", type=str, default=None)
    src.add_argument("--hugging_face_val_split", "--hf_val_split", type=str, default="validation")
    src.add_argument("--hugging_face_val_transcript_key", "--hf_val_transcript_key", type=str, default="text")


def add_decoder_args(parser: argparse.ArgumentParser):
    dec = parser.add_argument_group("decoder")
    dec.add_argument("--decoder", type=str, default="greedy", choices=["greedy", "beam", "fast_beam"])
    dec.add_argument("--max_symbols_per_step", type=int, default=30)
    dec.add_argument("--max_symbol_per_sample", type=int, default=None)
    dec.add_argument("--temperature", type=float, default=1.0)
    dec.add_argument("--fuzzy_topk_logits", action="store_true")
    dec.add_argument("--beam_width", type=int, default=4)
    dec.add_argument("--beam_prune_score_thresh", type=float, default=0.4)
    dec.add_argument("--beam_prune_topk_thresh", type=float, default=1.5)
    dec.add_argument("--beam_no_partials", action="store_true")
    dec.add_argument("--beam_final_emission_thresh", type=float, default=float("inf"))
    dec.add_argument("--ngram_path", "--override_ngram_path", type=str, default=None,
                     help="KenLM-style .arpa (or this framework's compiled "
                          "cache); overrides the model config's ngram_path")
    dec.add_argument("--skip_ngram", action="store_true",
                     help="disable n-gram fusion even if the model config "
                          "declares one (reference args/decoder.py:130)")
    dec.add_argument("--ngram_scale_factor", type=float, default=None)
    dec.add_argument("--keyword_boost_path", type=str, default=None)
    dec.add_argument("--beam_parallel_procs", "--beam_decoder_procs_per_gpu",
                     dest="beam_parallel_procs", type=int, default=1,
                     help="decode the beam over N worker processes (CPU "
                          "eval); -1 = all cores up to 8 (reference "
                          "args/decoder.py semantics)")
    dec.add_argument("--beam_min_decode_batch_size_per_proc", type=int,
                     default=128,
                     help="Minimum utterances per parallel-decode chunk")

    eos = parser.add_argument_group("eos decoding")
    eos.add_argument("--eos_decoding", type=str, default="none",
                     choices=["none", "ignore", "blank", "predict"])
    eos.add_argument("--eos_alpha", type=float, default=1.0)
    eos.add_argument("--eos_beta", type=float, default=0.0)
    eos.add_argument("--eos_is_terminal", action="store_true")
    eos.add_argument("--eos_vad_threshold", type=float, default=float("inf"))


def add_wer_analysis_args(parser: argparse.ArgumentParser):
    wa = parser.add_argument_group("wer analysis")
    wa.add_argument("--wer_breakdown", "--breakdown_wer", action="store_true",
                    help="print WER breakdown by case/punctuation class")
    wa.add_argument("--breakdown_chars", type=str, default=".,?")
    wa.add_argument("--punctuation_error_rate", action="store_true")


def add_latency_args(parser: argparse.ArgumentParser):
    lat = parser.add_argument_group("latency")
    lat.add_argument("--dump_ctm", action="store_true",
                     help="export word-level timestamps to a CTM file")
    lat.add_argument("--gt_ctm", type=str, default=None,
                     help="ground-truth CTM for emission-latency measurement")
    lat.add_argument("--latency_head_offset", type=float, default=0.0)
    lat.add_argument("--latency_tail_offset", type=float, default=0.0)
    lat.add_argument("--calculate_emission_latency", action="store_true",
                     help="measure emission latency against --gt_ctm "
                          "reference CTMs (reference args/shared.py:111)")


def add_state_reset_args(parser: argparse.ArgumentParser):
    sr = parser.add_argument_group("state resets")
    sr.add_argument("--sr_segment", type=float, default=0.0,
                    help="state-reset segment length (s); 0 disables")
    sr.add_argument("--sr_overlap", type=float, default=3.0)
