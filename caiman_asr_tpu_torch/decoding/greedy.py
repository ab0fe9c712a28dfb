"""Batched lock-step greedy transducer decoding (mirrors ``GreedyDecoder`` in
``caiman_asr_tpu/decoding/greedy.py``).

Every stream advances in lock-step; a stream's encoder offset advances when
it predicts blank or reaches ``max_symbols_per_step`` emissions on one
frame. A stream is done when, at its last frame, it predicts blank or
overflows ``max_symbols_per_step``, or when it has emitted
``max_symbol_per_sample`` non-blank tokens. The prediction net runs on the
whole batch each iteration and non-emitters keep their old state (select,
not gather). The loop is a host ``while`` that stops when every stream is
done or after ``T * max_symbols_per_step + 8`` iterations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.decoding.eos import EOSStrategy, apply_eos_strategy
from caiman_asr_tpu_torch.decoding.fuzzy import get_topk_logits
from caiman_asr_tpu_torch.decoding.response import (
    DecodingResponse,
    FrameResponses,
    HypothesisResponse,
)
from caiman_asr_tpu_torch.decoding.unbatch import encode_lower_batch_size


class GreedyDecoder:
    """Greedy decoder over encoder features; ``model`` is an ``RNNT``."""

    def __init__(
        self,
        model,
        blank_idx: int,
        eos_strategy: EOSStrategy = None,
        max_symbols_per_step: Optional[int] = 30,
        max_symbol_per_sample: Optional[int] = None,
        temperature: float = 1.0,
        fuzzy_topk_logits: bool = False,
        tokenizer=None,
        max_inputs_per_batch: int = int(1e7),
    ):
        self.model = model
        self.blank_idx = blank_idx
        self.eos_strategy = eos_strategy
        self.max_symbols = max_symbols_per_step or 30
        self.max_symbol_per_sample = max_symbol_per_sample
        self.temperature = temperature
        self.fuzzy = fuzzy_topk_logits
        self.tokenizer = tokenizer
        self.max_inputs_per_batch = max_inputs_per_batch

    def _logprobs(self, f, g):
        logits = self.model.joint_step(f, g)
        if self.fuzzy:
            logits = get_topk_logits(logits)
        lp = torch.log_softmax(logits.float() / self.temperature, dim=-1)
        return apply_eos_strategy(lp, self.eos_strategy, self.blank_idx)

    @torch.no_grad()
    def _decode(self, encs, enc_lens, cap: int):
        B, T, _ = encs.shape
        dev = encs.device
        cfg = self.model.cfg
        L, Hp = cfg.pred_rnn_layers, cfg.pred_n_hid
        zeros = encs.new_zeros((L, B, Hp))
        g, (h, c) = self.model.pred_step(None, (zeros, zeros))

        enc_lens = enc_lens.to(dev, torch.int64)
        max_off = torch.clamp(enc_lens - 1, min=0)
        enc_offset = torch.zeros(B, dtype=torch.int64, device=dev)
        done = enc_lens <= 0
        any_tok = torch.zeros(B, dtype=torch.int64, device=dev)
        nb = torch.zeros(B, dtype=torch.int64, device=dev)
        out_tok = torch.full((B, cap), self.blank_idx, dtype=torch.int64, device=dev)
        out_ts = torch.zeros((B, cap), dtype=torch.int64, device=dev)
        out_lp = torch.zeros((B, cap), dtype=torch.float32, device=dev)
        count = torch.zeros(B, dtype=torch.int64, device=dev)
        bix = torch.arange(B, device=dev)
        max_iters = T * self.max_symbols + 8

        iters = 0
        while iters < max_iters and not bool(done.all()):
            f = encs[bix, enc_offset]
            lp = self._logprobs(f, g)
            k = lp.argmax(dim=-1)  # first maximum on ties, as jnp.argmax
            klp = lp.amax(dim=-1)

            at_end = enc_offset == max_off
            is_blank = k == self.blank_idx
            done = done | (at_end & is_blank)
            done = done | (at_end & (any_tok >= self.max_symbols))
            if self.max_symbol_per_sample is not None:
                done = done | (nb >= self.max_symbol_per_sample)
            emit = ~done & ~is_blank

            pos = torch.clamp(count, 0, cap - 1)
            out_tok[bix, pos] = torch.where(emit, k, out_tok[bix, pos])
            out_ts[bix, pos] = torch.where(emit, enc_offset, out_ts[bix, pos])
            out_lp[bix, pos] = torch.where(emit, klp, out_lp[bix, pos])
            count = count + emit.long()

            nb = nb + (~is_blank).long()
            any_tok = any_tok + (~is_blank).long()
            advance = is_blank | (any_tok >= self.max_symbols)
            any_tok = any_tok * ((any_tok < self.max_symbols) | at_end).long()
            enc_offset = torch.minimum(enc_offset + advance.long(), max_off)

            g_new, (h_new, c_new) = self.model.pred_step(k, (h, c))
            g = torch.where(emit[:, None], g_new, g)
            h = torch.where(emit[None, :, None], h_new, h)
            c = torch.where(emit[None, :, None], c_new, c)
            iters += 1
        return out_tok, out_ts, out_lp, count

    def decode_encs(
        self, encs: torch.Tensor, enc_lens: torch.Tensor, cap: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Decode encoder output encs [B, T, Hj] with lengths [B]; returns
        numpy (tokens, frame indices, log-probs, counts), each row padded to
        ``cap``."""
        B, T, _ = encs.shape
        if cap is None:
            cap = int(min(self.max_symbol_per_sample or T * self.max_symbols,
                          T * self.max_symbols))
        cap = max(cap, 1)
        out = self._decode(encs, enc_lens, cap)
        return tuple(x.cpu().numpy() for x in out)

    def decode(
        self, feats: torch.Tensor, feat_lens: torch.Tensor
    ) -> List[Dict[int, FrameResponses]]:
        """Encoder + greedy loop -> per-utterance FrameResponses.
        feats: [T, B, in_feats] time-major."""
        encs, enc_lens = encode_lower_batch_size(
            self.model, feats, feat_lens, self.max_inputs_per_batch
        )
        return self.build_responses(*self.decode_encs(encs, enc_lens))

    def build_responses(self, toks, ts, lps, counts) -> List[Dict[int, FrameResponses]]:
        """Group emissions by frame into FrameResponses (greedy: all finals)."""
        out: List[Dict[int, FrameResponses]] = []
        for b in range(toks.shape[0]):
            resp: Dict[int, FrameResponses] = {}
            for i in range(int(counts[b])):
                t = int(ts[b, i])
                y = int(toks[b, i])
                p = float(np.exp(lps[b, i]))
                piece = self.tokenizer.id_to_piece(y) if self.tokenizer else ""
                if t not in resp:
                    resp[t] = FrameResponses(
                        partials=None,
                        final=DecodingResponse(
                            start_frame_idx=t,
                            duration_frames=1,
                            is_provisional=False,
                            alternatives=[HypothesisResponse(
                                y_seq=[y], timesteps=[t],
                                token_seq=[piece], confidence=[p],
                            )],
                        ),
                    )
                else:
                    hyp = resp[t].final.alternatives[0]
                    hyp.y_seq.append(y)
                    hyp.timesteps.append(t)
                    hyp.token_seq.append(piece)
                    hyp.confidence.append(p)
            out.append(resp)
        return out


def make_streaming_step(
    model,
    blank_idx: int,
    max_symbols_per_step: int = 8,
    temperature: float = 1.0,
    eos_strategy: EOSStrategy = None,
    fuzzy_topk_logits: bool = False,
):
    """The per-frame streaming decode step of the serving tick
    (``caiman_asr_tpu/decoding/greedy.py:232-323``).

    Returns ``step(params, f [B, Hj], dec_state) -> (tokens [B,
    max_symbols_per_step] int32, n [B] int32, dec_state)``: one encoder
    frame per stream, at most ``max_symbols_per_step`` emissions, with
    ``dec_state = (g [B, Hj], h, c [L, B, Hp])`` and ``params`` a tree as
    ``RNNT.param_tree`` gives. The loop is unrolled ``max_symbols_per_step``
    times on every call, with a select per lane and no host decision, so
    its work is fixed and it can be captured in a CUDA graph: a lane stops
    at its first blank and its state stays frozen from there. The JAX
    package's ``CAIMAN_GREEDY_EARLY_EXIT`` loop is not ported: its exit test
    would read a device value on the host every emission. With no EOS
    strategy and no fuzzy top-k, the token is the argmax of the logits, the
    same as of the log-softmax, which is then never formed.
    """
    fast = eos_strategy is None and not fuzzy_topk_logits

    def tokens(params, f, g):
        logits = model.joint_step(f, g, params=params)
        if fast:
            return logits.argmax(dim=-1).to(torch.int32)
        if fuzzy_topk_logits:
            logits = get_topk_logits(logits)
        lp = torch.log_softmax(logits.float() / temperature, dim=-1)
        return apply_eos_strategy(lp, eos_strategy, blank_idx).argmax(dim=-1).to(torch.int32)

    @torch.no_grad()
    def step(params, f, dec_state):
        g, h, c = dec_state
        B = f.shape[0]
        toks = torch.full((B, max_symbols_per_step), blank_idx, dtype=torch.int32,
                          device=f.device)
        n = torch.zeros(B, dtype=torch.int32, device=f.device)
        stopped = torch.zeros(B, dtype=torch.bool, device=f.device)
        for i in range(max_symbols_per_step):
            k = tokens(params, f, g)
            emit = ~stopped & (k != blank_idx)
            toks[:, i] = torch.where(emit, k, blank_idx)
            n = n + emit.to(torch.int32)
            g_new, (h_new, c_new) = model.pred_step(k, (h, c), params=params)
            g = torch.where(emit[:, None], g_new, g)
            h = torch.where(emit[None, :, None], h_new, h)
            c = torch.where(emit[None, :, None], c_new, c)
            stopped = stopped | ~emit
        return toks, n, (g, h, c)

    return step


@torch.no_grad()
def init_decode_state(model, batch_size: int, *, params=None, dtype=torch.float32):
    """Initial (g, h, c) streaming decode state (``greedy.py:326-332``):
    the prediction net's zero-vector SOS step from zero states in ``dtype``
    on the model's device; ``params`` as for ``RNNT.pred_step``."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    h = torch.zeros((cfg.pred_rnn_layers, batch_size, cfg.pred_n_hid), dtype=dtype,
                    device=dev)
    g, (h, c) = model.pred_step(None, (h, torch.zeros_like(h)), params=params)
    return g, h, c
