"""Convert a HuggingFace audio dataset to local WAVs and JSON manifests (the
port of ``caiman_asr_tpu/data/make_datasets/hf_to_json.py``; reference
data/make_datasets/hugging_face_to_json.py).

Run: python -m caiman_asr_tpu_torch.data.make_datasets.hf_to_json \\
       --hf_dataset DATA/hf_local --hf_split validation \\
       --data_dir DATA/out --hf_transcript_key text

The dataset is read through :class:`~caiman_asr_tpu_torch.data.hugging_face.
HuggingFaceReader`; it needs no network for a dataset on local files (a
directory of ``<split>.jsonl`` files named by ``--hf_dataset``) or one
already in the datasets cache. Audio files land in a two-level directory tree bounded by
``--max_branch_dir_audios`` / ``--max_leaf_dir_audios`` and manifests are
split every ``--max_utterances_per_json`` utterances.
"""

from __future__ import annotations

import argparse
import json
import wave
from pathlib import Path

import numpy as np


def audio_relpath(i: int, max_leaf: int, max_branch: int, ext: str = "wav") -> str:
    """Two-level bounded tree: audio/<branch>/<leaf>/<i>.wav."""
    leaf = (i // max_leaf) % max_branch
    branch = i // (max_leaf * max_branch)
    return f"audio/{branch:04d}/{leaf:04d}/{i:08d}.{ext}"


def main(argv=None):
    p = argparse.ArgumentParser(description="HF dataset -> wav + JSON manifest")
    p.add_argument("--hugging_face_dataset", "--hf_dataset", "--dataset",
                   dest="dataset", required=True)
    p.add_argument("--hugging_face_config", "--hf_config", "--config",
                   dest="config", default=None)
    p.add_argument("--hugging_face_split", "--hf_split", "--split",
                   dest="split", default="train")
    p.add_argument("--data_dir", "--dataset_dir", "--output_dir",
                   dest="output_dir", required=True)
    p.add_argument("--audio_column", default="audio")
    p.add_argument("--hugging_face_transcript_key", "--hf_transcript_key",
                   "--text_column", dest="text_column", default="text")
    p.add_argument("--max_utts", type=int, default=None)
    p.add_argument("--max_utterances_per_json", type=int, default=100000,
                   help="Split manifests every this many utterances")
    p.add_argument("--max_leaf_dir_audios", type=int, default=100,
                   help="Max audio files per leaf directory")
    p.add_argument("--max_branch_dir_audios", type=int, default=100,
                   help="Max leaf directories per branch directory")
    p.add_argument("--num_jobs_manifest_preparation", type=int, default=8,
                   help="Accepted for reference-CLI parity (the streaming "
                        "reader is sequential here)")
    p.add_argument("--fallback_input_audio_extension", default=None,
                   help="Accepted for reference-CLI parity (audio is "
                        "re-encoded to wav here, so no input-extension "
                        "fallback is ever needed)")
    p.add_argument("--use_relative_path", action="store_true", default=True)
    p.add_argument("--use_absolute_path", dest="use_relative_path",
                   action="store_false",
                   help="write absolute audio paths into the manifests")
    p.add_argument("--sample_rate", type=int, default=16000)
    args = p.parse_args(argv)

    from caiman_asr_tpu_torch.data.hugging_face import HuggingFaceReader

    out = Path(args.output_dir)
    reader = HuggingFaceReader(
        args.dataset, split=args.split, config=args.config,
        audio_column=args.audio_column, text_column=args.text_column,
        sample_rate=args.sample_rate,
    )
    entries = []
    manifests = []

    def flush():
        if not entries:
            return
        mf = out / f"manifest_{len(manifests):04d}.json"
        mf.write_text(json.dumps(entries, indent=1))
        print(f"wrote {mf} ({len(entries)} utterances)")
        manifests.append(mf)
        entries.clear()

    for i, (audio, text, _key) in enumerate(reader):
        if args.max_utts and i >= args.max_utts:
            break
        fname = audio_relpath(i, args.max_leaf_dir_audios, args.max_branch_dir_audios)
        path = out / fname
        path.parent.mkdir(parents=True, exist_ok=True)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(args.sample_rate)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
        dur = len(audio) / args.sample_rate
        entries.append({
            "transcript": text,
            "files": [{"fname": fname if args.use_relative_path else str(path),
                       "duration": dur}],
            "original_duration": dur,
        })
        if len(entries) >= args.max_utterances_per_json:
            flush()
    flush()
    if not manifests:
        print("no utterances converted")
    return manifests


if __name__ == "__main__":
    main()
