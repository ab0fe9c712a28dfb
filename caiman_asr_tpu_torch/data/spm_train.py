"""Train a sentencepiece-compatible tokenizer from manifests (the port of
``caiman_asr_tpu/data/spm_train.py``; reference data/spm/spm_from_json.py +
scripts/train_spm), from JSON manifests or, with ``--read_from_tar``, the
transcripts of webdataset tar or zip shards (``--tar_files``, beneath
``--dataset_dir`` where relative).

Writes both a ``.json`` vocab (framework-native) and an SPM-compatible
binary ``.model`` protobuf (data/tokenizer.py save_sentencepiece_model) so
checkpoints interoperate with reference tooling.

Run: python -m caiman_asr_tpu_torch.data.spm_train --manifests train.json \
       --dataset_dir DATA --vocab_size 8703 --output_prefix DATA/spm8703
"""

from __future__ import annotations

import argparse

from caiman_asr_tpu_torch.data.manifest import load_manifests
from caiman_asr_tpu_torch.data.text.normalize import NormalizeConfig, normalize_transcript
from caiman_asr_tpu_torch.data.tokenizer import (
    save_sentencepiece_model,
    save_tokenizer_json,
    train_tokenizer,
)

CHARSET = list(" abcdefghijklmnopqrstuvwxyz'")


def _load_texts(args) -> list:
    """Transcripts from JSON manifests or webdataset shards."""
    if getattr(args, "read_from_tar", False):
        from caiman_asr_tpu_torch.data.webdataset import read_shard_transcripts, shard_paths

        return read_shard_transcripts(shard_paths(args.dataset_dir, args.tar_files))
    if not args.manifests:
        raise SystemExit("pass --manifests or --read_from_tar --tar_files")
    utts = load_manifests([f"{args.dataset_dir}/{m}" for m in args.manifests])
    return [u.transcript for u in utts]


def main(argv=None):
    p = argparse.ArgumentParser(description="train sentencepiece vocab")
    p.add_argument("--manifests", "--train_manifests", dest="manifests",
                   nargs="+", default=[])
    p.add_argument("--read_from_tar", action="store_true")
    p.add_argument("--tar_files", nargs="+", default=[],
                   help="webdataset tar/zip shards (with --read_from_tar)")
    p.add_argument("--dataset_dir", "--data_dir", dest="dataset_dir",
                   default=".")
    p.add_argument("--vocab_size", "--spm_size", dest="vocab_size",
                   type=int, default=8703)
    p.add_argument("--output_prefix", default=None)
    p.add_argument("--spm_name", default=None,
                   help="Tokenizer name; combined with --output_dir it "
                        "forms the output prefix (reference spm_from_json)")
    p.add_argument("--output_dir", default=None,
                   help="Where to save the spm (with --spm_name)")
    p.add_argument("--max_corpus", type=int, default=None)
    args = p.parse_args(argv)

    if args.output_prefix is None:
        if args.spm_name is None:
            raise SystemExit("pass --output_prefix or --spm_name")
        out_dir = args.output_dir or "."
        args.output_prefix = f"{out_dir}/{args.spm_name}"

    texts = _load_texts(args)
    corpus = [
        normalize_transcript(t, CHARSET, NormalizeConfig()) for t in texts
    ]
    if args.max_corpus:
        corpus = corpus[: args.max_corpus]
    pieces = train_tokenizer(corpus, vocab_size=args.vocab_size)
    save_tokenizer_json(f"{args.output_prefix}.json", pieces)
    save_sentencepiece_model(f"{args.output_prefix}.model", pieces)
    print(f"trained {len(pieces)}-piece vocab -> {args.output_prefix}.{{json,model}}")


if __name__ == "__main__":
    main()
