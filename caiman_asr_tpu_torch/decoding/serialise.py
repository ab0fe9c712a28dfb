"""Frame-response serialisation for beam decoding (the port's own copy of
``caiman_asr_tpu/decoding/serialise.py``)
(reference: rnnt/serialise_responses.py:11-201).

A **final** is emitted when every hypothesis in the beam shares a common
token prefix — that prefix can never change, so it is shipped and truncated
from all hypotheses. **Partials** carry the full current beam as provisional
alternatives. Per-token timesteps in a final take the minimum across
hypotheses (earliest plausible emission time).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from caiman_asr_tpu_torch.decoding.hypothesis import Hypothesis
from caiman_asr_tpu_torch.decoding.response import (
    DecodingResponse,
    FrameResponses,
    HypothesisResponse,
)


class ResponseSerializer:
    def __init__(self, nbest_sort: Callable[[List[Hypothesis]], List[Hypothesis]]):
        self.nbest_sort = nbest_sort

    # ---------------------------------------------------------------- API
    def frame_responses(
        self,
        kept_hyps: Dict[int, Hypothesis],
        time_idx: Optional[int] = None,
        partials: bool = True,
    ) -> Tuple[FrameResponses, Dict[int, Hypothesis]]:
        final, kept_hyps = self._common_prefix_final(kept_hyps)
        part = None
        if partials:
            assert time_idx is not None
            part = self._build_partials(kept_hyps, time_idx)
        return FrameResponses(partials=part, final=final), kept_hyps

    def last_frame_response(self, kept_hyps: Dict[int, Hypothesis]) -> FrameResponses:
        best = self.nbest_sort(list(kept_hyps.values()))[0]
        final = None
        if len(best.y_seq) > 1:
            final = self._build_final([best], len(best.y_seq))
        return FrameResponses(partials=None, final=final)

    # ------------------------------------------------------------ internals
    def _common_prefix_final(self, kept_hyps: Dict[int, Hypothesis]):
        # The common prefix of ALL hypotheses equals the common prefix of the
        # lexicographic min and max of their token-string sequences.
        hyps = sorted(kept_hyps.values(), key=lambda h: h.s_seq)
        lo, hi = hyps[0].s_seq, hyps[-1].s_seq
        n = min(len(lo), len(hi))
        idx = 1  # position 0 is the SOS / already-shipped sentinel
        while idx < n and lo[idx] == hi[idx]:
            idx += 1
        if idx == 1:
            return None, kept_hyps
        final = self._build_final(hyps, idx)
        for h in kept_hyps.values():
            h.truncate(idx)
        return final, kept_hyps

    def _build_partials(
        self, kept_hyps: Dict[int, Hypothesis], time_idx: int
    ) -> Optional[DecodingResponse]:
        alts = []
        start = time_idx
        for hyp in self.nbest_sort(list(kept_hyps.values())):
            ts = hyp.timesteps[1:]
            if not ts:
                continue
            start = min(start, min(ts))
            alts.append(
                HypothesisResponse(
                    y_seq=list(hyp.y_seq[1:]),
                    timesteps=list(ts),
                    token_seq=list(hyp.s_seq[1:]),
                    confidence=list(hyp.p_seq[1:]),
                )
            )
        return DecodingResponse(
            start_frame_idx=start,
            duration_frames=time_idx - start + 1,
            is_provisional=True,
            alternatives=alts,
        )

    def _build_final(self, hyps: List[Hypothesis], tkn_idx: int) -> DecodingResponse:
        # All hypotheses agree on tokens [1, tkn_idx); timesteps may differ,
        # take the per-token minimum.
        head = hyps[0]
        y = list(head.y_seq[1:tkn_idx])
        s = list(head.s_seq[1:tkn_idx])
        p = list(head.p_seq[1:tkn_idx])
        ts = [
            min(h.timesteps[i] for h in hyps if i < len(h.timesteps))
            for i in range(1, tkn_idx)
        ]
        start, end = (min(ts), max(ts)) if ts else (0, 0)
        return DecodingResponse(
            start_frame_idx=start,
            duration_frames=end - start + 1,
            is_provisional=False,
            alternatives=[
                HypothesisResponse(y_seq=y, timesteps=ts, token_seq=s, confidence=p)
            ],
        )
