"""Benchmark client: stream a manifest's files to an ASR server and report
WER + latency (the port of ``caiman_asr_tpu/inference/transcribe.py``;
reference: inference/benchmark/transcribe_caiman.py). Needs ``websockets``.

Run: python -m caiman_asr_tpu_torch.inference.transcribe \
       --uri ws://localhost:8765/asr/v0.1/stream \
       --dataset_dir DATA --manifests dev.json --concurrency 8
"""

from __future__ import annotations

import argparse
import asyncio
import json

from caiman_asr_tpu_torch.data.manifest import load_manifests
from caiman_asr_tpu_torch.inference.measures import measure
from caiman_asr_tpu_torch.inference.transcriber import transcribe_file


async def run(args):
    utts = load_manifests(
        [f"{args.dataset_dir}/{m}" for m in args.manifests]
    )
    if args.max_utts:
        utts = utts[: args.max_utts]
    sem = asyncio.Semaphore(args.concurrency)

    async def one(u):
        async with sem:
            return await transcribe_file(
                args.uri, u.fname, chunk_seconds=args.chunk_seconds,
                realtime=not args.no_realtime,
            )

    results = await asyncio.gather(*(one(u) for u in utts))
    stats = measure(list(results), [u.transcript for u in utts])
    print(json.dumps(stats, indent=1))
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="streaming transcription benchmark")
    p.add_argument("--uri", default="ws://localhost:8765/asr/v0.1/stream")
    p.add_argument("--dataset_dir", default=".")
    p.add_argument("--manifests", nargs="+", required=True)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--chunk_seconds", type=float, default=0.1)
    p.add_argument("--no_realtime", action="store_true",
                   help="stream as fast as possible (throughput mode)")
    p.add_argument("--max_utts", type=int, default=None)
    args = p.parse_args(argv)
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
