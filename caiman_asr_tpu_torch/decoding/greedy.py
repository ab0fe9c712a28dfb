"""Batched lock-step greedy transducer decoding (mirrors ``GreedyDecoder`` in
``caiman_asr_tpu/decoding/greedy.py``).

Every stream advances in lock-step; a stream's encoder offset advances when
it predicts blank or reaches ``max_symbols_per_step`` emissions on one
frame. A stream is done when, at its last frame, it predicts blank or
overflows ``max_symbols_per_step``, or when it has emitted
``max_symbol_per_sample`` non-blank tokens. The prediction net runs on the
whole batch each iteration and non-emitters keep their old state (select,
not gather).

The loop runs on the device, the counterpart of the JAX package's
``lax.while_loop``. One iteration (``_iterate``) is a function of device
tensors only, with no host read: it updates the state in place, every
update gated by the JAX loop's condition computed on the device,
``run = ~done.all() & (iters < max_iters)``, so an iteration past the point
where the JAX loop stops changes nothing. The loop runs in chunks of
``chunk_iters`` iterations, and the host reads one flag a chunk (every
stream done, or ``max_iters = T * max_symbols_per_step + 8`` reached) and
stops there. On ``cuda`` one chunk is captured as a CUDA graph, cached per
decoder by (B, T, cap, dtype, device), and replayed: the state, the
encoder output and the limits are static buffers copied in before the
first replay, the capture follows two warm-up iterations on a side stream,
and the outputs are read back once at the end. A capture that fails
raises: the decoder never falls back to the eager loop on the card, unless
the caller asks for it with ``cuda_graph=False``. On the CPU the same
chunks run eagerly.
"""

from __future__ import annotations

from collections import OrderedDict
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

# the captured chunks a decoder keeps, the least recently used dropped first
MAX_GRAPHS = 4
# eager iterations on the capture's stream before it is captured
WARMUP_ITERS = 2


class _Loop:
    """The loop's device buffers: the encoder output, the limits and the
    state the iterations update in place (static buffers under a graph)."""

    def __init__(self, encs, max_off, max_iters, state):
        self.encs, self.max_off, self.max_iters, self.state = encs, max_off, max_iters, state
        self.stop = torch.zeros((), dtype=torch.bool, device=encs.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def load(self, encs, max_off, max_iters, state) -> None:
        self.encs.copy_(encs)
        self.max_off.copy_(max_off)
        self.max_iters.copy_(max_iters)
        for name, t in state.items():
            self.state[name].copy_(t)


class GreedyDecoder:
    """Greedy decoder over encoder features; ``model`` is an ``RNNT``.

    ``chunk_iters``: loop iterations between two host reads of the stop
    flag. ``cuda_graph``: on the card, replay each chunk as one CUDA graph
    (the default) or run it eagerly; ignored on the CPU. ``last_run`` holds
    the last decode's iterations, chunks, host reads and whether it
    replayed a graph."""

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
        chunk_iters: int = 32,
        cuda_graph: bool = True,
    ):
        if chunk_iters < 1:
            raise ValueError(f"chunk_iters must be at least 1, got {chunk_iters}")
        self.model = model
        self.blank_idx = blank_idx
        self.eos_strategy = eos_strategy
        self.max_symbols = max_symbols_per_step or 30
        self.max_symbol_per_sample = max_symbol_per_sample
        self.temperature = temperature
        self.fuzzy = fuzzy_topk_logits
        self.tokenizer = tokenizer
        self.max_inputs_per_batch = max_inputs_per_batch
        self.chunk_iters = chunk_iters
        self.cuda_graph = cuda_graph
        self._graphs: "OrderedDict[tuple, _Loop]" = OrderedDict()
        self.last_run: Optional[dict] = None

    def _logprobs(self, f, g):
        logits = self.model.joint_step(f, g)
        if self.fuzzy:
            logits = get_topk_logits(logits)
        lp = torch.log_softmax(logits.float() / self.temperature, dim=-1)
        return apply_eos_strategy(lp, self.eos_strategy, self.blank_idx)

    def _init_state(self, encs, enc_lens, cap: int) -> Dict[str, torch.Tensor]:
        B = encs.shape[0]
        dev = encs.device
        cfg = self.model.cfg
        zeros = encs.new_zeros((cfg.pred_rnn_layers, B, cfg.pred_n_hid))
        g, (h, c) = self.model.pred_step(None, (zeros, zeros))
        i64 = dict(dtype=torch.int64, device=dev)
        return dict(
            enc_offset=torch.zeros(B, **i64),
            done=enc_lens <= 0,
            g=g, h=h, c=c,
            any_tok=torch.zeros(B, **i64),
            nb=torch.zeros(B, **i64),
            out_tok=torch.full((B, cap), self.blank_idx, **i64),
            out_ts=torch.zeros((B, cap), **i64),
            out_lp=torch.zeros((B, cap), dtype=torch.float32, device=dev),
            count=torch.zeros(B, **i64),
            iters=torch.zeros((), **i64),
        )

    def _iterate(self, loop: _Loop) -> None:
        """One iteration of the JAX loop's body on ``loop.state``, in place,
        gated by its condition: device work only, no host read."""
        s, encs, max_off = loop.state, loop.encs, loop.max_off
        cap = s["out_tok"].shape[1]
        bix = torch.arange(encs.shape[0], device=encs.device)
        run = ~s["done"].all() & (s["iters"] < loop.max_iters)

        f = encs[bix, s["enc_offset"]]
        lp = self._logprobs(f, s["g"])
        k = lp.argmax(dim=-1)  # first maximum on ties, as jnp.argmax
        klp = lp.amax(dim=-1)

        at_end = s["enc_offset"] == max_off
        is_blank = k == self.blank_idx
        done = s["done"] | (at_end & is_blank)
        done = done | (at_end & (s["any_tok"] >= self.max_symbols))
        if self.max_symbol_per_sample is not None:
            done = done | (s["nb"] >= self.max_symbol_per_sample)
        emit = run & ~done & ~is_blank

        # the emissions scattered at position count: a fixed-shape index_put
        pos = torch.clamp(s["count"], 0, cap - 1)
        for name, val in (("out_tok", k), ("out_ts", s["enc_offset"]), ("out_lp", klp)):
            buf = s[name]
            buf.index_put_((bix, pos), torch.where(emit, val, buf[bix, pos]))

        nonblank = (~is_blank).long()
        any_tok = s["any_tok"] + nonblank
        advance = is_blank | (any_tok >= self.max_symbols)
        # the count resets only when it reaches max_symbols (or at the last
        # frame), not at each blank: the reference's trait
        any_tok = any_tok * ((any_tok < self.max_symbols) | at_end).long()
        enc_offset = torch.minimum(s["enc_offset"] + advance.long(), max_off)

        g_new, (h_new, c_new) = self.model.pred_step(k, (s["h"], s["c"]))
        new = dict(
            done=torch.where(run, done, s["done"]),
            count=s["count"] + emit.long(),
            nb=torch.where(run, s["nb"] + nonblank, s["nb"]),
            any_tok=torch.where(run, any_tok, s["any_tok"]),
            enc_offset=torch.where(run, enc_offset, s["enc_offset"]),
            g=torch.where(emit[:, None], g_new, s["g"]),
            h=torch.where(emit[None, :, None], h_new, s["h"]),
            c=torch.where(emit[None, :, None], c_new, s["c"]),
            iters=s["iters"] + run.long(),
        )
        for name, val in new.items():
            s[name].copy_(val)

    def _chunk(self, loop: _Loop) -> None:
        """``chunk_iters`` iterations, then the stop flag on the device."""
        for _ in range(self.chunk_iters):
            self._iterate(loop)
        loop.stop.copy_(loop.state["done"].all() | (loop.state["iters"] >= loop.max_iters))

    def _capture(self, loop: _Loop) -> None:
        """Warm up on a side stream, put the state back, capture one chunk."""
        dev = loop.encs.device
        saved = {name: t.clone() for name, t in loop.state.items()}
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_ITERS):
                self._iterate(loop)
        torch.cuda.current_stream(dev).wait_stream(stream)
        for name, t in saved.items():
            loop.state[name].copy_(t)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            self._chunk(loop)
        loop.graph = graph

    def _graph_loop(self, encs, max_off, max_iters, state) -> _Loop:
        """The cached captured chunk for these shapes, loaded with this
        call's inputs (captured on first use)."""
        key = (tuple(encs.shape), state["out_tok"].shape[1], encs.dtype, encs.device)
        loop = self._graphs.pop(key, None)
        if loop is None:
            loop = _Loop(encs.clone(), max_off.clone(), max_iters.clone(),
                         {name: t.clone() for name, t in state.items()})
            with torch.cuda.device(encs.device):
                self._capture(loop)
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            loop.load(encs, max_off, max_iters, state)
        self._graphs[key] = loop
        return loop

    @torch.inference_mode()
    def _decode(self, encs, enc_lens, cap: int):
        B, T, _ = encs.shape
        dev = encs.device
        enc_lens = enc_lens.to(dev, torch.int64)
        state = self._init_state(encs, enc_lens, cap)
        n_iters = T * self.max_symbols + 8  # from the true T
        max_off = torch.clamp(enc_lens - 1, min=0)
        max_iters = torch.tensor(n_iters, dtype=torch.int64, device=dev)
        # T = 0: every length is 0, so every stream is done and nothing runs
        graph = dev.type == "cuda" and self.cuda_graph and T > 0
        if graph:
            loop = self._graph_loop(encs, max_off, max_iters, state)
        else:
            loop = _Loop(encs, max_off, max_iters, state)
        chunks = 0
        if T > 0:
            # after this many chunks iters has reached max_iters
            for chunks in range(1, -(-n_iters // self.chunk_iters) + 1):
                if graph:
                    loop.graph.replay()
                else:
                    self._chunk(loop)
                if loop.stop.item():  # the chunk's one host read
                    break
        s = loop.state
        out = [s[name].cpu() for name in ("out_tok", "out_ts", "out_lp", "count", "iters")]
        self.last_run = dict(iters=int(out.pop()), chunks=chunks, host_reads=chunks,
                             graph=graph)
        return out

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
        return tuple(x.numpy() for x in self._decode(encs, enc_lens, cap))

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
    on the device of ``params`` (as for ``RNNT.pred_step``; default: the
    model's own)."""
    cfg = model.cfg
    p = model.param_tree() if params is None else params
    dev = p["prediction"]["embed"].device
    h = torch.zeros((cfg.pred_rnn_layers, batch_size, cfg.pred_n_hid), dtype=dtype,
                    device=dev)
    g, (h, c) = model.pred_step(None, (h, torch.zeros_like(h)), params=params)
    return g, h, c
