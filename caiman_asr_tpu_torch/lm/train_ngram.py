"""n-gram LM training: transcripts -> ARPA (+ binary cache); the port's own
copy of ``caiman_asr_tpu/lm/train_ngram.py``.

The reference prepares tokenized text and shells out to kenlm's ``lmplz``
(lm/prep_kenlm_data.py + scripts/generate_ngram.sh); this is a
self-contained replacement: count n-grams over sentencepiece pieces and
estimate an interpolated, Witten-Bell-smoothed backoff model written as
standard ARPA (loadable by caiman_asr_tpu_torch.lm.ngram.NGramLM *and* kenlm).

Run: python -m caiman_asr_tpu_torch.lm.train_ngram \
       --manifests train.json --dataset_dir DATA \
       --tokenizer_model spm.model --order 3 --output_dir DATA/ngram
"""

from __future__ import annotations

import argparse
import math
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

BOS, EOS_SYM, UNK = "<s>", "</s>", "<unk>"


def count_ngrams(sentences: Sequence[List[str]], order: int):
    """Counts for every 1..order-gram with <s>/</s> sentence padding."""
    counts = [Counter() for _ in range(order + 1)]  # index by n
    for toks in sentences:
        seq = [BOS] + list(toks) + [EOS_SYM]
        for n in range(1, order + 1):
            for i in range(len(seq) - n + 1):
                if n == 1 and seq[i] == BOS:
                    continue  # <s> has no unigram probability (kenlm style)
                counts[n][tuple(seq[i : i + n])] += 1
        counts[1][(BOS,)] += 0  # ensure presence for backoff context
    return counts


def witten_bell(counts, order: int):
    """Interpolated Witten-Bell estimates -> (logprob, backoff) per n-gram."""
    # unique continuation counts per context
    followers: List[Dict[tuple, set]] = [defaultdict(set) for _ in range(order + 1)]
    for n in range(2, order + 1):
        for ng in counts[n]:
            followers[n][ng[:-1]].add(ng[-1])

    vocab = sorted({ng[0] for ng in counts[1]} | {UNK, EOS_SYM})
    total_uni = sum(counts[1].values())
    V = len(vocab)

    probs: Dict[tuple, float] = {}
    backoffs: Dict[tuple, float] = {}

    # unigrams: add-epsilon floor so <unk> gets mass
    for w in vocab:
        c = counts[1].get((w,), 0)
        probs[(w,)] = (c + 0.5) / (total_uni + 0.5 * V)

    def p_interp(ng: tuple) -> float:
        n = len(ng)
        if n == 1:
            return probs[ng if ng in probs else (UNK,)]
        ctx = ng[:-1]
        c_ctx = counts[n - 1].get(ctx, 0) if n - 1 >= 1 else total_uni
        uniq = len(followers[n].get(ctx, ()))
        if c_ctx == 0 or uniq == 0:
            return p_interp(ng[1:])
        lam = c_ctx / (c_ctx + uniq)
        mle = counts[n].get(ng, 0) / c_ctx
        return lam * mle + (1.0 - lam) * p_interp(ng[1:])

    for n in range(2, order + 1):
        for ng in counts[n]:
            probs[ng] = p_interp(ng)

    # backoff weights: ensure normalization sum_w p(w|ctx) = 1
    for n in range(1, order):
        for ctx in (followers[n + 1] if n + 1 <= order else {}):
            seen = followers[n + 1][ctx]
            num = 1.0 - sum(probs[ctx + (w,)] for w in seen)
            den = 1.0 - sum(p_interp((ctx + (w,))[1:]) for w in seen)
            if den <= 1e-12 or num <= 1e-12:
                bo = 1e-12
            else:
                bo = num / den
            backoffs[ctx] = bo
    return probs, backoffs


def write_arpa(path: Path, probs, backoffs, order: int):
    by_n: List[List[tuple]] = [[] for _ in range(order + 1)]
    for ng in probs:
        by_n[len(ng)].append(ng)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\\data\\\n")
        for n in range(1, order + 1):
            fh.write(f"ngram {n}={len(by_n[n])}\n")
        for n in range(1, order + 1):
            fh.write(f"\n\\{n}-grams:\n")
            for ng in sorted(by_n[n]):
                lp = math.log10(max(probs[ng], 1e-99))
                line = f"{lp:.6f}\t{' '.join(ng)}"
                if n < order and ng in backoffs:
                    line += f"\t{math.log10(max(backoffs[ng], 1e-99)):.6f}"
                fh.write(line + "\n")
        fh.write("\n\\end\\\n")


def train_ngram_from_sentences(
    sentences: Sequence[List[str]], order: int, output_dir: str | Path
) -> Path:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    counts = count_ngrams(sentences, order)
    probs, backoffs = witten_bell(counts, order)
    arpa = out / "ngram.arpa"
    write_arpa(arpa, probs, backoffs, order)
    # binary cache for fast loading
    from caiman_asr_tpu_torch.lm.ngram import NGramLM

    NGramLM.load(arpa).save_binary(out / "ngram.binary")
    return arpa


def main(argv=None):
    p = argparse.ArgumentParser(description="train an ARPA n-gram over pieces")
    p.add_argument("--manifests", nargs="+", default=[])
    p.add_argument("--read_from_tar", action="store_true")
    p.add_argument("--tar_files", nargs="+", default=[],
                   help="webdataset tar/zip shards (with --read_from_tar)")
    p.add_argument("--dataset_dir", default=".")
    p.add_argument("--tokenizer_model", required=True)
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--unk_handling", default="WARN", choices=["FAIL", "WARN"])
    args = p.parse_args(argv)

    from caiman_asr_tpu_torch.data.manifest import load_manifests
    from caiman_asr_tpu_torch.data.text.normalize import NormalizeConfig, normalize_transcript
    from caiman_asr_tpu_torch.data.tokenizer import Tokenizer
    from caiman_asr_tpu_torch.data.unk_handling import UnkHandling, maybe_filter_transcripts

    tok = Tokenizer(list(" abcdefghijklmnopqrstuvwxyz'"), args.tokenizer_model)
    if getattr(args, "read_from_tar", False):
        from caiman_asr_tpu_torch.data.webdataset import read_shard_transcripts, shard_paths

        texts = read_shard_transcripts(shard_paths(args.dataset_dir, args.tar_files))
    elif args.manifests:
        utts = load_manifests([f"{args.dataset_dir}/{m}" for m in args.manifests])
        texts = [u.transcript for u in utts]
    else:
        raise SystemExit("pass --manifests or --read_from_tar --tar_files")
    token_ids = [
        tok.tokenize(normalize_transcript(t, tok.charset, NormalizeConfig()))
        for t in texts
    ]
    token_ids = maybe_filter_transcripts(token_ids, UnkHandling[args.unk_handling])
    sentences = [[tok.id_to_piece(i) for i in ids] for ids in token_ids]
    arpa = train_ngram_from_sentences(sentences, args.order, args.output_dir)
    print(f"wrote {arpa} (+ ngram.binary) over {len(sentences)} sentences")


if __name__ == "__main__":
    main()
