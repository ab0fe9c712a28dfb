"""Adaptive beam search for RNN-T with a host-scheduled search (the port of
``caiman_asr_tpu/decoding/beam.py``).

Behavioural parity with the reference decoder (rnnt/beam.py:77-687):
adaptive per-frame expansion until ``beam_width`` blank-terminated
hypotheses beat the best open one, hash-based hypothesis merging with
log-sum-exp score accumulation, top-k pruning (``beam_prune_topk_thresh``),
length-normalised beam pruning (``beam_prune_score_thresh``), n-gram shallow
fusion + keyword boosting hooks, EOS-terminal handling, VAD silence
termination, forced-final emission (``final_emission_thresh``), and
common-prefix final serialisation.

The hypothesis bookkeeping (hashes, merging, LM and keyword states) stays on
the host, as in the reference. All per-hypothesis device work of one
scheduling round, across every utterance of the batch, is one batched step
on the decoder's device (the model's): embed + prediction-net LSTM step +
joint + log-softmax + top-k, padded to a power-of-two lane count, with one
upload of its packed inputs and one download of its packed outputs. The
top-k takes the lower index first among equal values, as ``lax.top_k``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.decoding.eos import EOSPredict, EOSStrategy, apply_eos_strategy
from caiman_asr_tpu_torch.decoding.fast_beam import top_k
from caiman_asr_tpu_torch.decoding.fuzzy import get_topk_logits
from caiman_asr_tpu_torch.decoding.hypothesis import (
    SOS_TOKEN,
    Hypothesis,
    init_sos_hyp,
)
from caiman_asr_tpu_torch.decoding.response import FrameResponses
from caiman_asr_tpu_torch.decoding.serialise import ResponseSerializer
from caiman_asr_tpu_torch.decoding.unbatch import encode_lower_batch_size
from caiman_asr_tpu_torch.models.rnnt import _linear
from caiman_asr_tpu_torch.ops.lstm import lstm_step
from caiman_asr_tpu_torch.training.tree import tree_map


class RNNTBeamDecoder:
    """Beam decoder (reference API: rnnt/beam.py:77-178)."""

    def __init__(
        self,
        model,
        blank_idx: int,
        tokenizer,
        beam_width: int = 4,
        max_symbols_per_step: Optional[int] = 8,
        max_symbol_per_sample: Optional[int] = None,
        temperature: float = 1.4,
        beam_prune_score_thresh: float = 0.4,
        beam_prune_topk_thresh: float = 1.5,
        eos_strategy: EOSStrategy = None,
        eos_is_terminal: bool = False,
        eos_vad_threshold: float = float("inf"),
        final_emission_thresh: float = float("inf"),
        frame_width: float = 0.06,
        ngram_lm=None,
        ngram_alpha: float = 0.05,
        keywords=None,
        user_token_ids: Sequence[int] = (),
        fuzzy_topk_logits: bool = False,
        return_partials: bool = True,
        max_inputs_per_batch: int = int(1e7),
    ):
        self.model = model
        self.blank_idx = blank_idx
        self.max_inputs_per_batch = max_inputs_per_batch
        self.tokenizer = tokenizer
        self.beam_width = beam_width
        self.max_symbols = max_symbols_per_step
        self.max_symbol_per_sample = max_symbol_per_sample
        self.temperature = temperature
        self.score_thresh = (
            float("inf") if beam_prune_score_thresh < 0 else beam_prune_score_thresh
        )
        self.topk_thresh = (
            float("inf") if beam_prune_topk_thresh < 0 else beam_prune_topk_thresh
        )
        assert self.score_thresh > 1e-9 and self.topk_thresh > 1e-9, (
            "zero prune thresholds degenerate to greedy; use the greedy decoder"
        )
        self.eos_strategy = eos_strategy
        self.eos_is_terminal = eos_is_terminal
        self.eos_vad_threshold = eos_vad_threshold
        self.final_emission_thresh = final_emission_thresh
        self.frame_width = frame_width
        self.ngram_lm = ngram_lm
        self.ngram_alpha = ngram_alpha
        self.keywords = keywords
        self.user_token_ids = set(user_token_ids)
        self.fuzzy = fuzzy_topk_logits
        self.return_partials = return_partials
        self.serialiser = ResponseSerializer(self._sort_nbest)

        # device step: topk size = beam_width + 1 so blank can be appended
        # host-side without a second gather
        self._k = min(beam_width, model.n_classes)
        self.device = next(model.parameters()).device
        self.dtype = torch.float32
        self._params: Dict[torch.dtype, dict] = {}

    def _params_for(self, dtype):
        """The model's parameters in the step's dtype (cached)."""
        if dtype not in self._params:
            self._params[dtype] = tree_map(lambda t: t.detach().to(self.device, dtype),
                                           self.model.param_tree())
        return self._params[dtype]

    # -------------------------------------------------------- device step
    def _device_step_impl(self, params, f, y, h, c):
        """One fused scoring round for N (hypothesis, frame) lanes.

        f: [N, Hj] encoder frames; y: [N] last tokens (-1 = SOS);
        h, c: [L, N, Hp] pred states (zeros where SOS).
        Returns (top_scores [N, k], top_idx [N, k], blank_lp [N],
        h', c' [L, N, Hp]).
        """
        embed = params["prediction"]["embed"]
        gate = (y >= 0).to(embed.dtype)[:, None]
        emb = embed[torch.clamp(y, 0, embed.shape[0] - 1)] * gate
        out, h2, c2 = lstm_step(
            params["prediction"]["dec_rnn"], emb, h, c,
            hard=self.model.cfg.hard_activations,
            quantize=self.model.cfg.quantize,
        )
        g = _linear(params["joint_pred"], out)
        logits = self.model.joint_step(f, g, params=params)
        if self.fuzzy:
            logits = get_topk_logits(logits)
        lp = torch.log_softmax(logits.float() / self.temperature, dim=-1)
        lp = apply_eos_strategy(lp, self.eos_strategy, self.blank_idx)
        top_scores, top_idx = top_k(lp, self._k)
        return top_scores, top_idx, lp[:, self.blank_idx], h2, c2

    @torch.inference_mode()
    def _batched_step(self, params, work: List[Tuple[Hypothesis, np.ndarray]]):
        """Pad work items to a power-of-two lane count, run the scoring step
        on the decoder's device (one upload of the packed inputs, one
        download of the packed outputs); returns per-item packets on host."""
        N = len(work)
        P = max(8, 1 << math.ceil(math.log2(N)))
        L, Hp = self.model.cfg.pred_rnn_layers, self.model.cfg.pred_n_hid
        Hj = work[0][1].shape[-1]
        # [f | y | h (L*Hp) | c (L*Hp)] a lane, fp32 (token ids are exact)
        host = np.zeros((P, Hj + 1 + 2 * L * Hp), np.float32)
        host[:, Hj] = SOS_TOKEN
        for i, (hyp, enc_f) in enumerate(work):
            host[i, :Hj] = enc_f
            host[i, Hj] = hyp.y_last
            if hyp.pred_state is not None:
                host[i, Hj + 1:Hj + 1 + L * Hp] = hyp.pred_state[0].reshape(-1)
                host[i, Hj + 1 + L * Hp:] = hyp.pred_state[1].reshape(-1)
        dev = torch.from_numpy(host).to(self.device)
        f = dev[:, :Hj].to(self.dtype)
        y = dev[:, Hj].long()
        h = dev[:, Hj + 1:Hj + 1 + L * Hp].reshape(P, L, Hp).transpose(0, 1).to(self.dtype)
        c = dev[:, Hj + 1 + L * Hp:].reshape(P, L, Hp).transpose(0, 1).to(self.dtype)
        ts, ti, bl, h2, c2 = self._device_step_impl(params, f, y, h, c)
        k = self._k
        packed = torch.cat([ts, ti.float(), bl[:, None], h2.transpose(0, 1).reshape(P, -1).float(),
                            c2.transpose(0, 1).reshape(P, -1).float()], dim=1).cpu().numpy()
        ts, ti, bl = packed[:, :k], packed[:, k:2 * k].astype(np.int64), packed[:, 2 * k]
        hs = packed[:, 2 * k + 1:2 * k + 1 + L * Hp].reshape(P, L, Hp)
        cs = packed[:, 2 * k + 1 + L * Hp:].reshape(P, L, Hp)
        return [(ts[i], ti[i], float(bl[i]), (hs[i], cs[i])) for i in range(N)]

    # ------------------------------------------------------ public decode
    def decode(self, feats, feat_lens) -> List[Dict[int, FrameResponses]]:
        """Encoder on the model's device, then the beam. feats: [T, B,
        in_feats] time-major."""
        encs, enc_lens = encode_lower_batch_size(
            self.model, feats, feat_lens, self.max_inputs_per_batch
        )
        return self.decode_encs(encs, enc_lens)

    def decode_encs(self, encs, enc_lens) -> List[Dict[int, FrameResponses]]:
        """encs [B, T, Hj] (a tensor on the device, or numpy), enc_lens [B]."""
        encs = torch.as_tensor(encs)
        self.dtype = encs.dtype if encs.is_floating_point() else torch.float32
        params = self._params_for(self.dtype)
        encs = encs.float().cpu().numpy()
        enc_lens = np.asarray(torch.as_tensor(enc_lens).cpu())
        B = encs.shape[0]
        gens = [
            self._utt_loop(encs[i], int(enc_lens[i])) for i in range(B)
        ]
        done: Dict[int, Dict[int, FrameResponses]] = {}
        pend = [(i, g, g.send(None)) for i, g in enumerate(gens)]
        while pend:
            work, senders = [], []
            for idx, gen, req in pend:
                if req is None:  # generator finished via StopIteration value
                    continue
                kind, payload = req
                if kind == "done":
                    done[idx] = payload
                else:
                    work.append(payload)
                    senders.append((idx, gen))
            if not work:
                break
            packets = self._batched_step(params, work)
            nxt = []
            for (idx, gen), pkt in zip(senders, packets):
                try:
                    nxt.append((idx, gen, gen.send(pkt)))
                except StopIteration:
                    pass
            pend = nxt
        return [done[i] for i in sorted(done)]

    # --------------------------------------------------------- search core
    def _sort_nbest(self, hyps: List[Hypothesis]) -> List[Hypothesis]:
        return sorted(hyps, key=lambda h: h.normalised_score(), reverse=True)

    def _utt_loop(self, enc: np.ndarray, T: int):
        """Generator decoding one utterance; yields ("work", (hyp, frame))
        and finally ("done", responses)."""
        sos = init_sos_hyp(self.ngram_lm, self.keywords)
        kept: Dict[int, Hypothesis] = {sos.hashval: sos}
        responses: Dict[int, FrameResponses] = {}
        last_final_idx = 0
        time_idx = -1

        for time_idx in range(T):
            if self.max_symbol_per_sample is not None:
                best = max(kept.values(), key=lambda h: h.score)
                if best.y_length_tot > self.max_symbol_per_sample:
                    break
            frame = enc[time_idx]

            kept = yield from self._expand_frame(frame, kept, time_idx)

            if max(kept.values(), key=lambda h: h.score).is_terminal:
                responses[time_idx] = self.serialiser.last_frame_response(kept)
                yield ("done", responses)
                return

            time_since_final = (time_idx - last_final_idx) * self.frame_width
            while True:
                responses[time_idx], kept = self.serialiser.frame_responses(
                    kept, time_idx, self.return_partials
                )
                if len(kept) <= 1:
                    last_final_idx = time_idx
                    break
                if responses[time_idx].final is not None:
                    last_final_idx = min(h.timesteps[0] for h in kept.values())
                    break
                if time_since_final <= self.final_emission_thresh:
                    break
                # over budget: drop the weakest hypothesis until a final ships
                weakest = min(kept.values(), key=lambda h: h.normalised_score())
                kept.pop(weakest.hashval)

            if self._silence_exceeded(kept, time_idx):
                break

        responses[time_idx + 1] = self.serialiser.last_frame_response(kept)
        yield ("done", responses)

    def _expand_frame(
        self, frame: np.ndarray, hyps: Dict[int, Hypothesis], time_idx: int
    ):
        """Adaptive expansion at one frame (reference _beam_run_timestep,
        beam.py:358-418)."""
        for h in hyps.values():
            h.y_len_t = 0
        kept: Dict[int, Hypothesis] = {}

        while hyps:
            best_hash = max(hyps.values(), key=lambda h: h.score).hashval
            max_hyp = hyps.pop(best_hash)

            top_scores, top_idx, blank_lp, new_state = yield (
                "work",
                (max_hyp, frame),
            )

            for klog_p, kidx in self._expansion_steps(
                top_scores, top_idx, blank_lp, self._may_emit(max_hyp)
            ):
                hyps, kept = self._apply_expansion(
                    klog_p, kidx, max_hyp, kept, hyps, time_idx, new_state
                )

            if hyps:
                bar = max(hyps.values(), key=lambda h: h.score).score
                better = {k: v for k, v in kept.items() if v.score > bar}
                if len(better) >= self.beam_width:
                    kept = self._top_beam(better)
                    break
            else:
                kept = self._top_beam(kept)
                break

        return self._prune_scores(kept)

    def _may_emit(self, hyp: Hypothesis) -> bool:
        return not self.max_symbols or hyp.y_len_t < self.max_symbols

    def _expansion_steps(self, top_scores, top_idx, blank_lp, may_emit):
        """Candidate (logp, token) expansions: pruned top-k (+ blank ensured)
        or blank alone when the per-frame symbol cap is hit."""
        if not may_emit:
            return [(blank_lp, self.blank_idx)]
        keep = top_scores >= top_scores.max() - self.topk_thresh
        steps = [
            (float(s), int(t)) for s, t in zip(top_scores[keep], top_idx[keep])
        ]
        if all(t != self.blank_idx for _, t in steps):
            steps.append((blank_lp, self.blank_idx))
        return steps

    def _apply_expansion(
        self, klog_p, kidx, max_hyp, kept, hyps, time_idx, new_state
    ):
        if kidx == self.blank_idx:
            if max_hyp.hashval in kept:
                prev = kept[max_hyp.hashval]
                prev.score = float(np.logaddexp(prev.score, max_hyp.score + klog_p))
            else:
                nh = max_hyp.clone()
                nh.score += klog_p
                kept[nh.hashval] = nh
            return hyps, kept

        nh = max_hyp.clone()
        nh.score += klog_p
        nh.p_seq.append(float(np.exp(klog_p)))
        nh.timesteps.append(time_idx)
        nh.pred_state = new_state
        nh.y_seq.append(kidx)
        nh.y_len_t += 1

        if self.eos_is_terminal and isinstance(self.eos_strategy, EOSPredict):
            if kidx == self.eos_strategy.idx:
                nh.is_terminal = True

        if self.ngram_lm is not None and kidx not in self.user_token_ids:
            lm_score, nh.ngram_state = self.ngram_lm.score(
                self.tokenizer.id_to_piece(kidx), max_hyp.ngram_state
            )
            nh.score += self.ngram_alpha * lm_score
        if self.keywords is not None:
            delta, nh.kws_state = self.keywords.steps(
                self.tokenizer.id_to_piece(kidx), nh.kws_state
            )
            nh.score += delta

        piece = self.tokenizer.id_to_piece(kidx)
        nh.s_seq.append(piece)
        # leading-underscore dedup uses the PREVIOUS piece, so compute against
        # the sequence before appending:
        prev_piece = nh.s_seq[-2] if len(nh.s_seq) >= 2 else ""
        text = piece[1:] if (prev_piece.endswith("▁") and piece.startswith("▁")) else piece
        if text:
            nh.update_hash(text)

        if nh.hashval in hyps:
            other = hyps[nh.hashval]
            summed = float(np.logaddexp(other.score, nh.score))
            if nh.score > other.score:
                hyps[nh.hashval] = nh
            hyps[nh.hashval].score = summed
        else:
            hyps[nh.hashval] = nh
        return hyps, kept

    def _top_beam(self, hyps: Dict[int, Hypothesis]) -> Dict[int, Hypothesis]:
        if len(hyps) <= self.beam_width:
            return hyps
        best = sorted(hyps.values(), key=lambda h: h.score, reverse=True)
        return {h.hashval: h for h in best[: self.beam_width]}

    def _prune_scores(self, hyps: Dict[int, Hypothesis]) -> Dict[int, Hypothesis]:
        bar = max(h.normalised_score() for h in hyps.values()) - self.score_thresh
        return {k: v for k, v in hyps.items() if v.normalised_score() >= bar}

    def _silence_exceeded(self, kept: Dict[int, Hypothesis], time_idx: int) -> bool:
        if self.eos_vad_threshold == float("inf"):
            return False
        last = max(h.timesteps[-1] for h in kept.values())
        if last < 0:
            return False
        return (time_idx - last) * self.frame_width >= self.eos_vad_threshold
