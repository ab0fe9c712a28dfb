"""Emission-latency measurement CLI: ground-truth CTM vs model CTM (the port
of ``caiman_asr_tpu/latency/measure_latency.py``; reference
latency/measure_latency.py).

Run: python -m caiman_asr_tpu_torch.latency.measure_latency \
       --gt_ctm gt.ctm --model_ctm model.ctm [--include_subs] \
       [--frame_width 0.06] [--output_img_path latency.png]

Prints the reference's latency-metric dict (mean/median/stdev/p90/p99
emission latency, with half a frame width subtracted) and optionally saves
an emission-latency-vs-sequence-position scatter plot (``matplotlib`` is
imported only for the plot).
"""

from __future__ import annotations

import argparse
import os

from caiman_asr_tpu_torch.latency.ctm import align_transcripts, load_ctm
from caiman_asr_tpu_torch.latency.measure_latency_lite import compute_latency_metrics


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Measure emission latency from CTM files"
    )
    parser.add_argument(
        "--gt_ctm",
        required=True,
        type=str,
        help="Absolute path to ground truth ctm file",
    )
    parser.add_argument(
        "--model_ctm",
        required=True,
        type=str,
        help="Absolute path to model ctm file",
    )
    parser.add_argument(
        "--include_subs",
        action="store_true",
        default=False,
        help="Include substitution errors in latency computation",
    )
    parser.add_argument(
        "--output_img_path",
        default=None,
        type=str,
        help="Absolute output path for latency vs sequence length graph",
    )
    parser.add_argument(
        "--frame_width",
        default=0.0,
        type=float,
        help=(
            "The expected frame latency is computed from this and "
            "subtracted from the emission latency statistics"
        ),
    )
    return parser.parse_args(argv)


def plot_latency_vs_seq_len(latencies, end_times, save_path) -> None:
    """Scatter emission latency against the matched word's position in the
    utterance (reference measure_latency.py:322-338)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    plt.scatter(end_times, latencies, alpha=0.2)
    plt.xlabel("Time from start of sequence (seconds)")
    plt.ylabel("Emission Latency (seconds)")
    plt.title("Emission Latency vs. Sequence Length")
    plt.grid(True)
    plt.savefig(save_path)
    plt.close()


def main(args: argparse.Namespace) -> dict:
    aligned = align_transcripts(
        load_ctm(args.gt_ctm),
        load_ctm(args.model_ctm),
        include_subs=args.include_subs,
    )
    metrics = compute_latency_metrics(
        aligned.latencies,
        aligned.sil_latency,
        aligned.eos_latency,
        frame_width=args.frame_width,
    )
    print(metrics)

    if args.output_img_path:
        if os.path.splitext(args.output_img_path)[1] != ".png":
            raise ValueError("Incorrect file extension for plot (want .png).")
        plot_latency_vs_seq_len(
            aligned.latencies, aligned.end_times, args.output_img_path
        )
    return metrics


if __name__ == "__main__":
    main(parse_args())
