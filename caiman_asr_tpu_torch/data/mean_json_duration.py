"""Mean utterance duration across JSON manifests (the port of
``caiman_asr_tpu/data/mean_json_duration.py``; reference
data/mean_json_duration.py).

Run: python -m caiman_asr_tpu_torch.data.mean_json_duration \
       --data_dir /data --jsons a.json b.json [--max_duration 20.0]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "mean_json_duration.py",
        description="Calculate mean duration of utterances in JSON files",
    )
    parser.add_argument(
        "--jsons", type=str, nargs="+", required=True,
        help="Relative paths to JSON files",
    )
    parser.add_argument(
        "--data_dir", type=str, required=True,
        help="Data directory containing JSON files",
    )
    parser.add_argument(
        "--max_duration", type=float, default=20.0,
        help="Filter out utterances longer than this duration, default 20.0",
    )
    return parser


def mean_duration(jsons, data_dir, max_duration) -> float:
    durations = []
    for j in jsons:
        with open(Path(data_dir) / j) as fh:
            for item in json.load(fh):
                if item["original_duration"] <= max_duration:
                    durations.append(item["original_duration"])
    if not durations:
        raise SystemExit("no utterances under --max_duration")
    return sum(durations) / len(durations)


def main(args: argparse.Namespace) -> float:
    result = mean_duration(args.jsons, args.data_dir, args.max_duration)
    print(f"Mean duration: {result}")
    return result


if __name__ == "__main__":
    main(get_parser().parse_args())
