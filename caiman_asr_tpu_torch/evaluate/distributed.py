"""Evaluation across processes (the port of
``caiman_asr_tpu/evaluate/distributed.py:19-110``).

Each rank evaluates its own shard of the validation set; these functions
combine the shards over ``torch.distributed``. Every one returns the same
value on every rank (all-reduce and all-gather, not a gather to rank 0), so
what depends on the result (``--die_if_wer_bad``, the best-checkpoint
choice, the skipped-step alarm) takes the same branch everywhere. With one
process they return their input. Under model parallelism the ranks of a
model group evaluate the same rows (``parallel/mesh.data_rank``), so the
shards are combined over the data group: one rank a vocab shard.
"""

from __future__ import annotations

import dataclasses
from typing import List

from caiman_asr_tpu_torch.parallel import mesh


def sum_across_processes(x) -> float:
    """A host scalar summed over the processes, in float64."""
    return mesh.all_reduce_floats([x])[0]


def sync_wer_across_processes(scores, num_words) -> float:
    """The WER of the whole set from each process's (edit distance, word
    count) sums."""
    s, n = mesh.all_reduce_floats([scores, num_words])
    return s / max(n, 1.0)


def gather_objects(obj) -> List:
    """One picklable object a process, gathered to every process in process
    order."""
    return mesh.all_gather_objects(obj, data_only=True)


def aggregate_eval_results(result, loss_count: float = 0.0):
    """The processes' ``EvalResult``s combined, alike on every process: the
    WER from the summed scores and words, the loss weighted by each
    process's count of utterances, the per-utterance lists concatenated in
    process order."""
    if mesh.data_world() == 1:
        return result
    ls = result.loss if result.loss is not None else 0.0
    scores, num_words, loss_sum, count_sum = mesh.all_reduce_floats(
        [result.scores, result.num_words, ls * loss_count, loss_count])
    gathered = gather_objects({
        "hyps": result.hyps,
        "refs": result.refs,
        "fnames": result.fnames,
        "timestamps": result.timestamps,
        "word_timestamps": result.word_timestamps,
        "terminations": result.terminations,
    })
    merged_wts = None
    if any(g["word_timestamps"] for g in gathered):
        merged_wts = [w for g in gathered for w in (g["word_timestamps"] or [])]
    return dataclasses.replace(
        result,
        wer=scores / max(num_words, 1.0),
        scores=int(scores),
        num_words=int(num_words),
        loss=(loss_sum / count_sum) if count_sum else None,
        hyps=[h for g in gathered for h in g["hyps"]],
        refs=[r for g in gathered for r in g["refs"]],
        fnames=[f for g in gathered for f in g["fnames"]],
        timestamps=[t for g in gathered for t in g["timestamps"]],
        word_timestamps=merged_wts,
        terminations=[t for g in gathered for t in (g["terminations"] or [])] or None,
    )
