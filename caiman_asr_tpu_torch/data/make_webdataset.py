"""JSON manifests to webdataset tar shards (the port of
``caiman_asr_tpu/data/make_webdataset.py``).

Writes ``{key}.flac|wav`` + ``{key}.txt`` member pairs, the layout
``data/webdataset.py`` reads: audio files copied byte for byte (no
re-encoding), keys zero-padded sequence numbers, so that the shards and
their order are a fixed function of the manifests.

Run: python -m caiman_asr_tpu_torch.data.make_webdataset \\
       --manifests train.json --dataset_dir DATA \\
       --output_dir DATA/shards --samples_per_shard 2048
"""

from __future__ import annotations

import argparse
import io
import tarfile
from pathlib import Path

from caiman_asr_tpu_torch.data.manifest import load_manifests


def write_shards(utts, output_dir, samples_per_shard=2048, prefix="shard"):
    """``utts`` (``Utterance``s) into ``{prefix}-{n:06d}.tar`` files of
    ``samples_per_shard`` pairs each; returns their paths."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    tar = None

    def put(name: str, data: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))

    for i, u in enumerate(utts):
        if i % samples_per_shard == 0:
            if tar is not None:
                tar.close()
            paths.append(out / f"{prefix}-{len(paths):06d}.tar")
            tar = tarfile.open(paths[-1], "w")
        src = Path(u.fname)
        key = f"{i:09d}"
        put(f"{key}{src.suffix.lower()}", src.read_bytes())
        put(f"{key}.txt", u.transcript.encode("utf-8"))
    if tar is not None:
        tar.close()
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description="manifests -> webdataset shards")
    p.add_argument("--manifests", nargs="+", required=True)
    p.add_argument("--dataset_dir", default=".")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--samples_per_shard", type=int, default=2048)
    p.add_argument("--shard_prefix", default="shard")
    args = p.parse_args(argv)

    utts = load_manifests([f"{args.dataset_dir}/{m}" for m in args.manifests])
    paths = write_shards(utts, args.output_dir, args.samples_per_shard, args.shard_prefix)
    print(f"wrote {len(paths)} shard(s), {len(utts)} samples -> {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()
