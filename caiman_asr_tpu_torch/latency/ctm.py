"""CTM export + emission-latency measurement
(reference: latency/ctm.py:22-249, latency/measure_latency.py).

CTM lines: ``<recording_id> <channel> <start> <duration> <word>``.
Emission latency for a correctly-recognised word = (time the model emitted
it) − (ground-truth end time from a forced-alignment CTM). Words are paired
by difflib alignment of the normalized word sequences; substitutions can be
included optionally (reference measure_latency.py:163-295).

The port's copy of ``caiman_asr_tpu/latency/ctm.py``.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass
from pathlib import Path
from statistics import mean, median
from typing import Dict, List, Optional, Tuple

from caiman_asr_tpu_torch.latency.timestamp import (
    EOS,
    Never,
    SequenceTimestamp,
    Silence,
    Termination,
    frame_to_time,
)


@dataclass
class CTMTimestamp:
    word: str
    beg_time: float
    end_time: float
    filename: str


def to_ctm(
    seq_time: SequenceTimestamp, output_fp: str, audio_fp: str, frame_width: float
):
    with open(output_fp, "a") as fh:
        for w in seq_time.seqs:
            wt = frame_to_time(w, frame_width)
            fh.write(
                f"{audio_fp} 1 {wt.start_time:.3f} {wt.end_time - wt.start_time:.3f} "
                f"{w.word} \n"
            )


def dump_ctm(
    flist: List[str],
    lst_seq_time: List[SequenceTimestamp],
    ctm_fpath: str,
    frame_width: float,
) -> Dict[str, Termination]:
    Path(ctm_fpath).write_text("")  # make repeatable
    for seq, fname in zip(lst_seq_time, flist):
        to_ctm(seq, ctm_fpath, fname, frame_width)
    return {f: s.eos for f, s in zip(flist, lst_seq_time)}


def load_ctm(ctm_file_path: str) -> List[CTMTimestamp]:
    out = []
    with open(ctm_file_path) as fh:
        for ln, line in enumerate(fh):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 5:
                raise ValueError(f"{ctm_file_path}:{ln}: bad CTM line: {line!r}")
            fname, _, beg, dur, word = parts[:5]
            out.append(
                CTMTimestamp(
                    word=word.lower(),
                    beg_time=float(beg),
                    end_time=float(beg) + float(dur),
                    filename=fname,
                )
            )
    return out


def _by_file(ctm: List[CTMTimestamp]) -> Dict[str, List[CTMTimestamp]]:
    files: Dict[str, List[CTMTimestamp]] = {}
    for t in ctm:
        files.setdefault(t.filename, []).append(t)
    return files


_BASIC_CHARS = frozenset(" abcdefghijklmnopqrstuvwxyz'")


def _norm_word(word: str) -> str:
    """Lowercase and strip to the basic character set used for alignment
    (reference measure_latency.py:20,225-226)."""
    return "".join(c for c in word.lower() if c in _BASIC_CHARS)


@dataclass
class _Delta:
    """Head/tail offsets of one matched (ground-truth, predicted) word pair."""

    gt_end: float
    head_lat: float
    tail_lat: float
    time_gt: float
    time_pr: float


@dataclass
class AlignedLatencies:
    """Everything the CTM-vs-CTM alignment produces
    (reference measure_latency.py:163-295 return tuple, named)."""

    latencies: List[float]  # tail latency per matched word (emission latency)
    end_times: List[float]  # ground-truth end time per matched word
    sil_latency: List[float]  # endpoint latency, SIL-terminated utterances
    eos_latency: List[float]  # endpoint latency, EOS-terminated utterances
    token_usage_rate: float  # matched words / ground-truth words
    terminal_token_usage_rate: float  # utts whose final word matched / utts
    timestamp_stats: Dict[str, float]


def _timestamp_stats(
    deltas: List[_Delta], head_offset: float, tail_offset: float
) -> Dict[str, float]:
    """Average-absolute-shift (AAS) timestamp accuracy: raw, after the given
    fixed offsets, and after per-run optimal (median) offsets
    (reference measure_latency.py:120-160)."""
    if not deltas:
        return {}

    def mean_abs_off(vals: List[float], off: float) -> float:
        return mean(abs(v - off) for v in vals)

    heads = [d.head_lat for d in deltas]
    tails = [d.tail_lat for d in deltas]
    opt_head = median(heads)
    opt_tail = median(tails)
    return {
        "mean_word_time_gt": mean(d.time_gt for d in deltas),
        "mean_word_time_pr": mean(d.time_pr for d in deltas),
        "optimal_head_offset": opt_head,
        "optimal_tail_offset": opt_tail,
        "raw_AAS": (mean_abs_off(heads, 0.0) + mean_abs_off(tails, 0.0)) / 2,
        "fixed_AAS": (
            mean_abs_off(heads, head_offset) + mean_abs_off(tails, tail_offset)
        )
        / 2,
        "corrected_AAS": (
            mean_abs_off(heads, opt_head) + mean_abs_off(tails, opt_tail)
        )
        / 2,
    }


def align_transcripts(
    gt_ctm: List[CTMTimestamp],
    model_ctm: List[CTMTimestamp],
    last_emit_time: Optional[Dict[str, Termination]] = None,
    include_subs: bool = False,
    head_offset: float = 0.0,
    tail_offset: float = 0.0,
) -> AlignedLatencies:
    """Difflib-align normalized word sequences per file and derive emission
    latencies, endpoint (SIL/EOS) latencies, and timestamp accuracy
    (reference measure_latency.py:163-295). Substituted spans count only
    when ``include_subs`` and both spans have equal length; tag words
    (``<eos>`` etc.) are excluded before alignment."""
    from caiman_asr_tpu_torch.utils.user_tokens import is_tag

    gt_files = _by_file(gt_ctm)
    pr_files = _by_file(model_ctm)

    deltas: List[_Delta] = []
    sil_latency: List[float] = []
    eos_latency: List[float] = []
    accepted = 0
    all_gt_words = 0
    end_acc = 0
    end_tot = 0

    def span_ok(op: str, len_gt: int, len_pr: int) -> bool:
        if op == "equal":
            return True
        return op == "replace" and include_subs and len_gt == len_pr

    for fname, gts_raw in gt_files.items():
        # a file the model produced no output for still counts in the
        # usage-rate denominators (it is a whole-file deletion, the exact
        # failure these rates exist to expose)
        prs_raw = pr_files.get(fname) or []
        # drop tag words and words that normalize to empty (digits /
        # punctuation-only): two empty strings would otherwise "match"
        gts = [t for t in gts_raw if not is_tag(t.word) and _norm_word(t.word)]
        prs = [t for t in prs_raw if not is_tag(t.word) and _norm_word(t.word)]
        gt_words = [_norm_word(t.word) for t in gts]
        pr_words = [_norm_word(t.word) for t in prs]

        sm = difflib.SequenceMatcher(a=gt_words, b=pr_words, autojunk=False)
        for op, a0, a1, b0, b1 in sm.get_opcodes():
            if not span_ok(op, a1 - a0, b1 - b0):
                continue
            for i, j in zip(range(a0, a1), range(b0, b1)):
                deltas.append(
                    _Delta(
                        gt_end=gts[i].end_time,
                        head_lat=prs[j].beg_time - gts[i].beg_time,
                        tail_lat=prs[j].end_time - gts[i].end_time,
                        time_gt=gts[i].end_time - gts[i].beg_time,
                        time_pr=prs[j].end_time - prs[j].beg_time,
                    )
                )
            accepted += b1 - b0

        if last_emit_time is not None:
            if fname not in last_emit_time:
                if prs_raw:
                    raise KeyError(f"missing termination time for {fname}")
                # no model output and no termination record: the file simply
                # never terminated; it still counts in end_tot below
            last_gt = gt_words[-1] if gt_words else ""
            last_pr = pr_words[-1] if pr_words else ""
            if last_gt == last_pr and fname in last_emit_time:
                # empty ground truth => worst-case endpoint latency base 0.0
                gt_final = gts[-1].end_time if gts else 0.0
                end_acc += 1
                term = last_emit_time[fname]
                if isinstance(term, EOS):
                    eos_latency.append(term.final_time - gt_final)
                elif isinstance(term, Silence):
                    sil_latency.append(term.final_time - gt_final)

        end_tot += 1
        all_gt_words += len(gt_words)

    return AlignedLatencies(
        latencies=[d.tail_lat for d in deltas],
        end_times=[d.gt_end for d in deltas],
        sil_latency=sil_latency,
        eos_latency=eos_latency,
        token_usage_rate=accepted / all_gt_words if all_gt_words else 0.0,
        terminal_token_usage_rate=end_acc / end_tot if end_tot else 0.0,
        timestamp_stats=_timestamp_stats(deltas, head_offset, tail_offset),
    )


def align_ctm_files(
    gt_ctm: List[CTMTimestamp],
    model_ctm: List[CTMTimestamp],
    include_subs: bool = False,
) -> List[float]:
    """Per matched word: model emission time − ground-truth word end time."""
    return align_transcripts(gt_ctm, model_ctm, include_subs=include_subs).latencies


def latency_stats(
    latencies: List[float], frame_width: float = 0.0
) -> Dict[str, Optional[float]]:
    """Summary stats; the expected half-frame wait can be subtracted via
    frame_width (reference measure_latency.py:120-160)."""
    if not latencies:
        return {"mean": None, "median": None, "p90": None, "p99": None, "n": 0}
    adj = [l - frame_width / 2.0 for l in latencies]
    s = sorted(adj)

    def pct(p):
        k = min(len(s) - 1, max(0, round(p * (len(s) - 1))))
        return s[k]

    return {
        "mean": mean(adj),
        "median": median(adj),
        "p90": pct(0.90),
        "p99": pct(0.99),
        "n": len(adj),
    }


def measure_emission_latency(
    gt_ctm_path: str,
    model_ctm_path: str,
    include_subs: bool = False,
    frame_width: float = 0.0,
    last_emit_time: Optional[Dict[str, Termination]] = None,
) -> Dict[str, Optional[float]]:
    """Emission-latency stats, plus SIL/EOS endpoint-latency stats when the
    per-file terminations are given (reference latency/ctm.py:116-140 →
    compute_latency_metrics keys)."""
    aligned = align_transcripts(
        load_ctm(gt_ctm_path),
        load_ctm(model_ctm_path),
        last_emit_time=last_emit_time,
        include_subs=include_subs,
    )
    metrics = latency_stats(aligned.latencies, frame_width)
    if last_emit_time is not None:
        if aligned.sil_latency:
            metrics["mean-SIL-latency"] = mean(aligned.sil_latency)
            metrics["median-SIL-latency"] = median(aligned.sil_latency)
        if aligned.eos_latency:
            metrics["mean-EOS-latency"] = mean(aligned.eos_latency)
            metrics["median-EOS-latency"] = median(aligned.eos_latency)
        metrics["terminal_token_usage_rate"] = (
            aligned.terminal_token_usage_rate
        )
    return metrics
