"""Batched fixed-expansion beam search on the device (the port of
``caiman_asr_tpu/decoding/fast_beam.py``).

A label-synchronous beam of width W per utterance: per frame, score the W
hypotheses, blank-extend them into a *finished* pool (top-W, duplicates
merged by logaddexp), replace the active set by the top-W non-blank
continuations, and repeat up to E times (E = max symbols per frame); the
finished pool is the beam of the next frame. Hypothesis merging rides a
rolling uint32 token hash, n-gram fusion and keyword boosting are dense
``[S, K]`` automata (``lm/device_table.py``, ``keywords/device_table.py``)
gathered vocab-wide before the preselection, and the host beam's pruning
thresholds (score, top-k, final emission) are compiled in as score masks,
all as the JAX module does.

Device translation of the JAX control flow:

- the expansion loop, a ``lax.while_loop`` on ``e < E & _improvable(...)``
  there, runs all E trips here, each trip's every update gated by a device
  flag ``go &= improvable`` that stays false once it turns false, so no trip
  reads the host and the result is the early-exit loop's;
- ``lax.top_k`` takes the lower index first among equal values, and the
  pools are full of ``NEG_INF`` ties whose slots still ship their buffers;
  :func:`top_k` gives that order (``torch.topk`` gives none) by selecting
  on an int64 key of the value's order-preserving bits and the reversed
  index. ``lax.approx_max_k`` is exact on the CPU; the port uses the exact
  top-k everywhere (the JAX package on a TPU has recall 0.99);
- the uint32 hash is computed in int64 masked to 32 bits.

``FastBeamDecoder`` runs the offline frame loop on the device the way
``GreedyDecoder`` runs its loop: ``chunk_frames`` frames a chunk, one host
read of a stop flag a chunk, and on ``cuda`` one chunk captured as a CUDA
graph (static buffers, warm-up on a side stream, the state put back before
the capture) and replayed. ``make_streaming_beam_step`` is the per-frame
body for the serving engine over ``[B, W, ...]`` state, with the token
buffers composed once after the expansion loop from backpointers.
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
from caiman_asr_tpu_torch.models.rnnt import _linear
from caiman_asr_tpu_torch.ops.lstm import lstm_step
from caiman_asr_tpu_torch.training.tree import tree_map

NEG_INF = -1.0e30
HASH_MULT = 1000003
U32 = 0xFFFFFFFF
# the captured chunks a decoder keeps, the least recently used dropped first
MAX_GRAPHS = 4
# eager frames on the capture's stream before it is captured
WARMUP_FRAMES = 1
# the beam state's leaves whose lane (W) axis is 2: [L, B, W, Hp]
STACK_KEYS = ("h", "c")


def lane_axis(key: str) -> int:
    """The B axis of a beam-state leaf (W follows it)."""
    return 1 if key in STACK_KEYS else 0


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, sorted descending,
    the lower index first among equal values (fp32 values)."""
    n = x.shape[-1]
    bits = x.float().contiguous().view(torch.int32)
    order = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    rev = n - 1 - torch.arange(n, device=x.device, dtype=torch.int64)
    idx = torch.topk((order << 32) | rev, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def _hash_step(h: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Rolling token-sequence hash, uint32 arithmetic in int64."""
    return (h * HASH_MULT + token.to(torch.int64) + 1) & U32


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Gather x's W axis (``axis + 1``, after the B axis) by idx [B, W']."""
    w = axis + 1
    shape = [1] * x.dim()
    shape[axis], shape[w] = idx.shape
    out_shape = list(x.shape)
    out_shape[w] = idx.shape[1]
    return torch.gather(x, w, idx.reshape(shape).expand(out_shape))


def gather_w(tree: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: _take(v, idx, lane_axis(k)) for k, v in tree.items()}


def concat_w(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    return {k: torch.cat([v, b[k]], dim=lane_axis(k) + 1) for k, v in a.items()}


def select(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor, axis: int) -> torch.Tensor:
    """new where ``mask`` (0-d, or [B] on the leaf's lane axis), else old."""
    if mask.dim():
        shape = [1] * new.dim()
        shape[axis] = mask.shape[0]
        mask = mask.reshape(shape)
    return torch.where(mask, new, old)


def select_tree(mask, new: Dict[str, torch.Tensor], old: Dict[str, torch.Tensor]):
    return {k: select(mask, new[k], old[k], lane_axis(k)) for k in new}


def _tables(table, alpha: Optional[float] = None):
    """(score, next_state, init_state) from a DeviceNgram / DeviceKeywords as
    numpy, or None when fusion is off (an n-gram with alpha <= 0)."""
    if table is None or (alpha is not None and alpha <= 0.0):
        return None
    return (np.asarray(table.score, np.float32), np.asarray(table.next_state, np.int64),
            int(table.init_state))


class _OnDevice:
    """Fusion tables moved to a device on first use there."""

    def __init__(self, tables):
        self.tables, self._dev = tables, {}

    def __call__(self, device):
        if self.tables is None:
            return None
        if device not in self._dev:
            s, n, i = self.tables
            self._dev[device] = (torch.from_numpy(s).to(device), torch.from_numpy(n).to(device), i)
        return self._dev[device]


def _improvable(active, finished, W: int, merge: bool) -> torch.Tensor:
    """Whether any lane's active hypotheses can still change the finished
    top-W (the JAX loop's exact early-exit condition; with merging, mass
    below exp(-16) relative no longer counts)."""
    slack = 16.0 if merge else 0.0
    worst_kept = finished["scores"][:, W - 1]
    best_active = active["scores"].amax(dim=1)
    return (best_active > worst_kept - slack).any()


def _merged_scores(s, h, l):
    """logaddexp duplicate (hash, len) entries into their best-scoring copy;
    the other copies drop to NEG_INF. s, h, l: [B, M]."""
    alive = s > NEG_INF / 2
    eq = ((h[:, :, None] == h[:, None, :]) & (l[:, :, None] == l[:, None, :])
          & alive[:, :, None] & alive[:, None, :])
    contrib = torch.where(eq, s[:, None, :], NEG_INF)
    m = contrib.amax(dim=-1)
    merged = m + torch.log(torch.exp(contrib - m[..., None]).sum(dim=-1))
    best = contrib.argmax(dim=-1)  # the first maximum, as jnp.argmax
    keeper = best == torch.arange(s.shape[1], device=s.device)
    return torch.where(alive & keeper, merged, NEG_INF)


def _opt_thresh(v):
    """None / inf / negative all disable a pruning threshold."""
    v = None if v is None else float(v)
    return None if v is None or not np.isfinite(v) or v < 0 else v


def _apply_score_thresh(scores, lens, thresh):
    """Kill hypotheses whose length-normalised score trails the lane best by
    more than ``thresh`` (SOS counts one)."""
    norm = scores / torch.clamp(lens + 1, min=1).float()
    bar = norm.amax(dim=1, keepdim=True)
    return torch.where(norm >= bar - thresh, scores, NEG_INF)


def _final_emission_prune(scores, toks, lens, committed, since, limit):
    """Final-emission depth pruning (``fast_beam.py:186-234``): track the
    beam's common-prefix length ``committed``; when it stalls past ``limit``
    frames while the best hypothesis holds uncommitted tokens, drop every
    live hypothesis blocking the divergence point. Returns (scores,
    committed, since)."""
    live = scores > NEG_INF / 2
    n_live = live.to(torch.int64).sum(dim=1)
    best = scores.argmax(dim=1)
    ref_toks = _take(toks, best[:, None], 0)
    agree = (toks == ref_toks) | ~live[:, :, None]
    agree_all = agree.all(dim=1)  # [B, cap]
    minlen = torch.where(live, lens, 1 << 30).amin(dim=1)
    pos = torch.arange(agree_all.shape[1], device=scores.device)[None]
    cp = ((torch.cumprod(agree_all.to(torch.int64), dim=1) > 0)
          & (pos < minlen[:, None])).to(torch.int64).sum(dim=1)
    best_len = torch.gather(lens, 1, best[:, None])[:, 0]
    cp = torch.where(n_live <= 1, best_len, cp)
    advanced = cp > committed
    committed = torch.maximum(cp, committed)
    since = torch.where(advanced, 0, since + 1)
    lagging = best_len > committed
    over = (since > limit) & (n_live > 1) & lagging
    at_cm = torch.clamp(committed, max=toks.shape[2] - 1)
    div_tok = torch.gather(toks, 2, at_cm[:, None, None].expand(-1, toks.shape[1], 1))[:, :, 0]
    best_div = torch.gather(div_tok, 1, best[:, None])
    extends = (lens > committed[:, None]) & (div_tok == best_div)
    wix = torch.arange(scores.shape[1], device=scores.device)[None]
    keep = extends | (wix == best[:, None])
    drop = over[:, None] & ~keep
    return torch.where(drop, NEG_INF, scores), committed, since


def _pred_advance(model, params, tokens, h, c):
    """tokens [B, W] (None: the zero-vector SOS step); h, c [L, B, W, Hp]
    -> (g [B, W, Hj], h', c')."""
    L, B, W, Hp = h.shape
    if tokens is None:
        emb = h.new_zeros((B * W, Hp))
    else:
        embed = params["prediction"]["embed"]
        emb = embed[torch.clamp(tokens.reshape(B * W).long(), 0, embed.shape[0] - 1)]
    out, h2, c2 = lstm_step(params["prediction"]["dec_rnn"], emb, h.reshape(L, B * W, Hp),
                            c.reshape(L, B * W, Hp), hard=model.cfg.hard_activations,
                            quantize=model.cfg.quantize)
    g = _linear(params["joint_pred"], out).reshape(B, W, -1)
    return g, h2.reshape(L, B, W, Hp), c2.reshape(L, B, W, Hp)


def _init_beam(model, params, B: int, W: int, cap: int, blank_idx: int, dtype, device, lm, kw):
    """Lane 0 the SOS hypothesis (zero pred input and state), the rest dead."""
    cfg = model.cfg
    z = torch.zeros((cfg.pred_rnn_layers, B, W, cfg.pred_n_hid), dtype=dtype, device=device)
    g, h, c = _pred_advance(model, params, None, z, z)
    i64 = dict(dtype=torch.int64, device=device)
    lane = torch.arange(W, device=device)[None].expand(B, W)
    st = dict(
        scores=torch.where(lane == 0, 0.0, NEG_INF).float(),
        toks=torch.full((B, W, cap), blank_idx, dtype=torch.int32, device=device),
        ts=torch.zeros((B, W, cap), dtype=torch.int32, device=device),
        lens=torch.zeros((B, W), **i64),
        hash=torch.zeros((B, W), **i64),
        g=g, h=h, c=c,
    )
    if lm is not None:
        st["lm"] = torch.full((B, W), lm[2], **i64)
    if kw is not None:
        st["kw"] = torch.full((B, W), kw[2], **i64)
    return st


class _Loop:
    """The offline frame loop's device buffers: the encoder output, the
    lengths and the state the frames update in place (static buffers under
    a graph)."""

    def __init__(self, encs, enc_lens, state):
        self.encs, self.enc_lens, self.state = encs, enc_lens, state
        self.stop = torch.zeros((), dtype=torch.bool, device=encs.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def load(self, encs, enc_lens, state) -> None:
        self.encs.copy_(encs)
        self.enc_lens.copy_(enc_lens)
        for name, t in state.items():
            self.state[name].copy_(t)


class FastBeamDecoder:
    """Batched fixed-expansion beam decoder over encoder features; ``model``
    is an ``RNNT``, whose weights the decoder uses in the encoder output's
    dtype.

    score_thresh / topk_thresh / final_emission_frames: the host beam's
    pruning thresholds (0.4, 1.5, final_emission_thresh in frames); None /
    inf disables each. ``chunk_frames``: frames between two host reads of
    the stop flag. ``cuda_graph``: on the card, replay each chunk as one
    CUDA graph (the default) or run it eagerly; ignored on the CPU.
    ``last_run`` holds the last decode's frames, chunks, host reads and
    whether it replayed a graph."""

    def __init__(
        self,
        model,
        blank_idx: int,
        beam_width: int = 4,
        max_symbols_per_step: int = 4,
        temperature: float = 1.4,
        eos_strategy: EOSStrategy = None,
        fuzzy_topk_logits: bool = False,
        tokenizer=None,
        cap: int = 256,
        ngram_lm=None,
        ngram_alpha: float = 0.0,
        keywords=None,
        merge: bool = True,
        max_inputs_per_batch: int = int(1e7),
        score_thresh: Optional[float] = None,
        topk_thresh: Optional[float] = None,
        final_emission_frames: Optional[int] = None,
        chunk_frames: int = 16,
        cuda_graph: bool = True,
    ):
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be at least 1, got {chunk_frames}")
        self.model = model
        self.blank_idx = blank_idx
        self.max_inputs_per_batch = max_inputs_per_batch
        self.W = beam_width
        self.E = max_symbols_per_step
        self.temperature = temperature
        self.eos_strategy = eos_strategy
        self.fuzzy = fuzzy_topk_logits
        self.tokenizer = tokenizer
        self.cap = cap
        self.merge = merge
        self.score_thresh = _opt_thresh(score_thresh)
        self.topk_thresh = _opt_thresh(topk_thresh)
        fe = _opt_thresh(final_emission_frames)
        self.final_emission_frames = None if fe is None else int(fe)
        self.ngram_alpha = float(ngram_alpha)
        self._lm = _OnDevice(_tables(ngram_lm, ngram_alpha))
        self._kw = _OnDevice(_tables(keywords))
        self.chunk_frames = chunk_frames
        self.cuda_graph = cuda_graph
        self._graphs: "OrderedDict[tuple, _Loop]" = OrderedDict()
        self._params: Dict[tuple, dict] = {}
        self.last_run: Optional[dict] = None

    def _params_for(self, dtype, device):
        key = (dtype, device)
        if key not in self._params:
            self._params[key] = tree_map(lambda t: t.detach().to(device, dtype),
                                         self.model.param_tree())
        return self._params[key]

    def _logprobs(self, params, f, g):
        """f [B, Hj], g [B, W, Hj] -> lp [B, W, K]."""
        logits = _linear(params["joint_fc"], torch.relu(f[:, None, :] + g))
        if self.fuzzy:
            B, W, K = logits.shape
            logits = get_topk_logits(logits.reshape(B * W, K)).reshape(B, W, K)
        lp = torch.log_softmax(logits.float() / self.temperature, dim=-1)
        return apply_eos_strategy(lp, self.eos_strategy, self.blank_idx)

    def _frame(self, loop: _Loop, params, lm, kw) -> None:
        """One frame of the JAX scan's body on ``loop.state``, in place."""
        s = loop.state
        beam = {k: v for k, v in s.items() if k not in ("committed", "since", "t")}
        B, W, cap = beam["toks"].shape
        E, K, blank = self.E, self.model.n_classes, self.blank_idx
        t = s["t"]
        T = loop.encs.shape[1]
        f_t = loop.encs.index_select(1, torch.clamp(t, max=T - 1).reshape(1))[:, 0]
        valid = t < loop.enc_lens  # [B]
        t32 = t.to(torch.int32)

        def fin_update(finished, active, lp):
            pool = concat_w(finished, dict(active, scores=active["scores"] + lp[..., blank]))
            if self.merge:
                pool["scores"] = _merged_scores(pool["scores"], pool["hash"], pool["lens"])
            top_s, top_i = top_k(pool["scores"], W)
            finished = gather_w(pool, top_i)
            finished["scores"] = top_s
            return finished

        def expand(active, lp):
            lp_nb = lp.clone()
            lp_nb[..., blank] = NEG_INF
            if self.topk_thresh is not None:
                bar = lp.amax(dim=-1, keepdim=True) - self.topk_thresh
                tk_keep = lp_nb >= bar
            if lm is not None:
                lp_nb = lp_nb + self.ngram_alpha * lm[0][active["lm"]]
            if kw is not None:
                lp_nb = lp_nb + kw[0][active["kw"]]
            if self.topk_thresh is not None:
                lp_nb = torch.where(tk_keep, lp_nb, NEG_INF)
            cand_s, cand_i = top_k(lp_nb.reshape(B * W, K), W)
            cand_s = cand_s.reshape(B, W, W) + active["scores"][:, :, None]
            top_es, sel = top_k(cand_s.reshape(B, W * W), W)
            parent = sel // W
            token = torch.gather(cand_i.reshape(B, W * W), 1, sel)
            new = gather_w(active, parent)
            pos = torch.clamp(new["lens"], 0, cap - 1)[:, :, None]
            new["toks"] = new["toks"].scatter(2, pos, token.to(torch.int32)[:, :, None])
            new["ts"] = new["ts"].scatter(2, pos, t32.expand(B, W, 1))
            new["lens"] = torch.clamp(new["lens"] + 1, max=cap)
            new["scores"] = top_es
            new["hash"] = _hash_step(new["hash"], token)
            if lm is not None:
                new["lm"] = lm[1][new["lm"], token]
            if kw is not None:
                new["kw"] = kw[1][new["kw"], token]
            new["g"], new["h"], new["c"] = _pred_advance(self.model, params, token,
                                                         new["h"], new["c"])
            return new

        active = beam
        finished = dict(beam, scores=torch.full_like(beam["scores"], NEG_INF))
        go = torch.ones((), dtype=torch.bool, device=t.device)
        for _ in range(E):
            go = go & _improvable(active, finished, W, self.merge)
            lp = self._logprobs(params, f_t, active["g"])
            finished = select_tree(go, fin_update(finished, active, lp), finished)
            active = select_tree(go, expand(active, lp), active)
        finished = fin_update(finished, active, self._logprobs(params, f_t, active["g"]))

        committed, since = s["committed"], s["since"]
        if self.score_thresh is not None:
            finished["scores"] = _apply_score_thresh(finished["scores"], finished["lens"],
                                                     self.score_thresh)
        if self.final_emission_frames is not None and W > 1:
            s2, c2, f2 = _final_emission_prune(finished["scores"], finished["toks"],
                                               finished["lens"], committed, since,
                                               self.final_emission_frames)
            finished["scores"] = torch.where(valid[:, None], s2, finished["scores"])
            committed = torch.where(valid, c2, committed)
            since = torch.where(valid, f2, since)
        new = {k: select(valid, finished[k], beam[k], lane_axis(k)) for k in beam}
        new.update(committed=committed, since=since, t=t + 1)
        for name, val in new.items():
            s[name].copy_(val)

    def _chunk(self, loop: _Loop, params) -> None:
        """``chunk_frames`` frames, then the stop flag on the device."""
        dev = loop.encs.device
        lm, kw = self._lm(dev), self._kw(dev)
        for _ in range(self.chunk_frames):
            self._frame(loop, params, lm, kw)
        loop.stop.copy_(loop.state["t"] >= loop.enc_lens.amax())

    def _capture(self, loop: _Loop, params) -> None:
        """Warm up on a side stream, put the state back, capture one chunk."""
        dev = loop.encs.device
        lm, kw = self._lm(dev), self._kw(dev)
        saved = {name: t.clone() for name, t in loop.state.items()}
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_FRAMES):
                self._frame(loop, params, lm, kw)
        torch.cuda.current_stream(dev).wait_stream(stream)
        for name, t in saved.items():
            loop.state[name].copy_(t)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            self._chunk(loop, params)
        loop.graph = graph

    def _graph_loop(self, encs, enc_lens, state, params) -> _Loop:
        key = (tuple(encs.shape), state["toks"].shape[2], encs.dtype, encs.device)
        loop = self._graphs.pop(key, None)
        if loop is None:
            loop = _Loop(encs.clone(), enc_lens.clone(),
                         {name: t.clone() for name, t in state.items()})
            with torch.cuda.device(encs.device):
                self._capture(loop, params)
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            loop.load(encs, enc_lens, state)
        self._graphs[key] = loop
        return loop

    @torch.inference_mode()
    def _decode(self, encs, enc_lens, cap: int):
        B, T, _ = encs.shape
        dev = encs.device
        enc_lens = enc_lens.to(dev, torch.int64)
        params = self._params_for(encs.dtype, dev)
        state = _init_beam(self.model, params, B, self.W, cap, self.blank_idx, encs.dtype, dev,
                           self._lm(dev), self._kw(dev))
        zb = torch.zeros(B, dtype=torch.int64, device=dev)
        state.update(committed=zb, since=zb.clone(),
                     t=torch.zeros((), dtype=torch.int64, device=dev))
        graph = dev.type == "cuda" and self.cuda_graph and T > 0
        loop = (self._graph_loop(encs, enc_lens, state, params) if graph
                else _Loop(encs, enc_lens, state))
        chunks = 0
        if T > 0:
            for chunks in range(1, -(-T // self.chunk_frames) + 1):
                if graph:
                    loop.graph.replay()
                else:
                    self._chunk(loop, params)
                if loop.stop.item():  # the chunk's one host read
                    break
        s = loop.state
        norm = s["scores"] / torch.clamp(s["lens"] + 1, min=1).float()
        order = torch.sort(-norm, dim=1, stable=True).indices
        out = [_take(s[k], order, 0).cpu() for k in ("toks", "ts", "lens", "scores")]
        self.last_run = dict(frames=int(s["t"]), chunks=chunks, host_reads=chunks,
                             chunk_frames=self.chunk_frames, graph=graph)
        return out

    def decode_encs(self, encs: torch.Tensor, enc_lens: torch.Tensor,
                    cap: Optional[int] = None):
        """Decode encoder output encs [B, T, Hj] with lengths [B]; returns
        numpy (toks [B, W, cap], ts, lens [B, W], scores [B, W]), each
        utterance's hypotheses ordered by length-normalised score."""
        if cap is None:
            cap = min(self.cap, encs.shape[1] * self.E)
        cap = max(int(cap), 1)
        return tuple(x.numpy() for x in self._decode(encs, torch.as_tensor(enc_lens), cap))

    def decode(self, feats: torch.Tensor, feat_lens: torch.Tensor
               ) -> List[Dict[int, FrameResponses]]:
        """Encoder + beam -> per-utterance FrameResponses. feats: [T, B,
        in_feats] time-major."""
        encs, enc_lens = encode_lower_batch_size(self.model, feats, feat_lens,
                                                 self.max_inputs_per_batch)
        return self.build_responses(*self.decode_encs(encs, enc_lens))

    def build_responses(self, toks, ts, lens, scores) -> List[Dict[int, FrameResponses]]:
        """One closing final per utterance carrying the n-best beam."""
        out: List[Dict[int, FrameResponses]] = []
        B, W, _ = toks.shape
        for b in range(B):
            alts = []
            for w in range(W):
                n = int(lens[b, w])
                if scores[b, w] <= NEG_INF / 2:
                    continue
                y = [int(t) for t in toks[b, w, :n]]
                alts.append(HypothesisResponse(
                    y_seq=y, timesteps=[int(t) for t in ts[b, w, :n]],
                    token_seq=[self.tokenizer.id_to_piece(t) if self.tokenizer else ""
                               for t in y],
                    confidence=[1.0] * n))
            start = min((a.timesteps[0] for a in alts if a.timesteps), default=0)
            end = max((a.timesteps[-1] for a in alts if a.timesteps), default=0)
            out.append({} if not alts or not alts[0].y_seq else {
                end: FrameResponses(partials=None, final=DecodingResponse(
                    start_frame_idx=start, duration_frames=end - start + 1,
                    is_provisional=False, alternatives=alts))})
        return out


class StreamingBeamStep:
    """The streaming beam step (``fast_beam.py:558-851``): ``init_state``
    and ``step`` over a per-lane beam, one encoder frame a call, with no
    host read. State leaves: scores [B, W] fp32, toks / ts [B, W, cap]
    int32, lens / hash (and lm / kw) [B, W] int64, g [B, W, Hj], h / c
    [L, B, W, Hp], frame [B] int64, and with a final-emission limit
    committed / since_final [B] int64."""

    def __init__(self, model, blank_idx: int, beam_width: int = 4, expansions: int = 4,
                 temperature: float = 1.4, cap: int = 256, ngram_lm=None,
                 ngram_alpha: float = 0.0, keywords=None, merge: bool = True,
                 score_thresh: Optional[float] = None, topk_thresh: Optional[float] = None,
                 final_emission_frames: Optional[int] = None):
        self.model, self.blank_idx = model, blank_idx
        self.W, self.E, self.K = beam_width, expansions, model.n_classes
        self.temperature, self.cap, self.merge = temperature, cap, merge
        self.alpha = float(ngram_alpha)
        self._lm = _OnDevice(_tables(ngram_lm, ngram_alpha))
        self._kw = _OnDevice(_tables(keywords))
        self.score_thresh = _opt_thresh(score_thresh)
        self.topk_thresh = _opt_thresh(topk_thresh)
        fe = _opt_thresh(final_emission_frames)
        self.fe_limit = None if fe is None or beam_width <= 1 else int(fe)

    def init_state(self, params, B: int, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        dev = params["prediction"]["embed"].device
        st = _init_beam(self.model, params, B, self.W, self.cap, self.blank_idx, dtype, dev,
                        self._lm(dev), self._kw(dev))
        st["frame"] = torch.zeros(B, dtype=torch.int64, device=dev)
        if self.fe_limit is not None:
            st["committed"] = torch.zeros(B, dtype=torch.int64, device=dev)
            st["since_final"] = torch.zeros(B, dtype=torch.int64, device=dev)
        return st

    @torch.no_grad()
    def step(self, params, f_t: torch.Tensor, state: Dict[str, torch.Tensor]):
        """One frame: f_t [B, Hj]. Returns the new state (a new dict). The
        token and frame buffers are not carried through the expansion trips:
        each trip records (parent, token, write position) backpointers, and
        the buffers are composed once after the trips."""
        W, EM, K, blank, cap = self.W, max(self.E, 1), self.K, self.blank_idx, self.cap
        B = f_t.shape[0]
        dev = f_t.device
        lm, kw = self._lm(dev), self._kw(dev)
        fused = lm is not None or kw is not None
        frame = state["frame"]
        init_toks, init_ts = state["toks"], state["ts"]
        small = {k: v for k, v in state.items()
                 if k not in ("toks", "ts", "frame", "committed", "since_final")}
        wix = torch.arange(W, device=dev)[None].expand(B, W)

        def z_lse(g):
            logits = _linear(params["joint_fc"], torch.relu(f_t[:, None, :] + g))
            z = logits.float() / self.temperature
            return z, torch.logsumexp(z, dim=-1)

        def fin_update(fin, fin_gen, fin_row, active, z, lse, gen):
            pool = concat_w(fin, dict(active, scores=active["scores"] + z[..., blank] - lse))
            if self.merge:
                pool["scores"] = _merged_scores(pool["scores"], pool["hash"], pool["lens"])
            top_s, top_i = top_k(pool["scores"], W)
            new_fin = gather_w(pool, top_i)
            new_fin["scores"] = top_s
            gen_t = gen.expand(B, W) if torch.is_tensor(gen) else torch.full_like(fin_gen, gen)
            new_gen = torch.where(top_i < W,
                                  torch.gather(torch.cat([fin_gen, gen_t], 1), 1, top_i), gen_t)
            new_row = torch.gather(torch.cat([fin_row, wix], 1), 1, top_i)
            return new_fin, new_gen, new_row

        def expand(e, active, z, lse, trace):
            zf = z
            if self.topk_thresh is not None and fused:
                bar = z.amax(dim=-1, keepdim=True) - self.topk_thresh
                zf = torch.where(z >= bar, z, NEG_INF)
            if lm is not None:
                zf = zf + self.alpha * lm[0][active["lm"]]
            if kw is not None:
                zf = zf + kw[0][active["kw"]]
            cs, ci = top_k(zf.reshape(B * W, K), W + 1)
            if self.topk_thresh is not None and not fused:
                bar = z.amax(dim=-1).reshape(B * W, 1) - self.topk_thresh
                cs = torch.where(cs >= bar, cs, NEG_INF)
            cs = torch.where(ci == blank, NEG_INF, cs)
            cand_s = cs.reshape(B, W, W + 1) - lse[:, :, None] + active["scores"][:, :, None]
            cand_i = ci.reshape(B, W, W + 1)
            top_es, sel = top_k(cand_s.reshape(B, W * (W + 1)), W)
            parent = sel // (W + 1)
            token = torch.gather(cand_i.reshape(B, W * (W + 1)), 1, sel)
            new = gather_w(active, parent)
            pos = torch.clamp(new["lens"], 0, cap - 1)
            trace = tuple(torch.cat([tr[:e], v[None], tr[e + 1:]])
                          for tr, v in zip(trace, (parent, token, pos)))
            new["lens"] = torch.clamp(new["lens"] + 1, max=cap)
            new["scores"] = top_es
            new["hash"] = _hash_step(new["hash"], token)
            if lm is not None:
                new["lm"] = lm[1][new["lm"], token]
            if kw is not None:
                new["kw"] = kw[1][new["kw"], token]
            new["g"], new["h"], new["c"] = _pred_advance(self.model, params, token,
                                                         new["h"], new["c"])
            return new, trace

        active = small
        fin = dict(small, scores=torch.full_like(small["scores"], NEG_INF))
        fin_gen = torch.zeros((B, W), dtype=torch.int64, device=dev)
        fin_row = wix.clone()
        trace = tuple(torch.zeros((EM, B, W), dtype=torch.int64, device=dev) for _ in range(3))
        go = torch.ones((), dtype=torch.bool, device=dev)
        e_fin = torch.zeros((), dtype=torch.int64, device=dev)
        for e in range(EM):
            go = go & _improvable(active, fin, W, self.merge)
            z, lse = z_lse(active["g"])
            fin2, gen2, row2 = fin_update(fin, fin_gen, fin_row, active, z, lse, e)
            active2, trace2 = expand(e, active, z, lse, trace)
            fin = select_tree(go, fin2, fin)
            fin_gen = torch.where(go, gen2, fin_gen)
            fin_row = torch.where(go, row2, fin_row)
            active = select_tree(go, active2, active)
            trace = tuple(torch.where(go, a, b) for a, b in zip(trace2, trace))
            e_fin = e_fin + go.to(torch.int64)
        z, lse = z_lse(active["g"])
        fin, fin_gen, fin_row = fin_update(fin, fin_gen, fin_row, active, z, lse, e_fin)

        # the buffers: walk the backpointer chains (generations EM..1), then
        # one gather of each buffer and at most EM small scatters, the oldest
        # generation first so that at cap saturation the latest write wins
        tp, tt, tpos = trace
        row = fin_row
        writes = []
        for gg in range(EM, 0, -1):
            valid = fin_gen >= gg
            writes.append((torch.gather(tpos[gg - 1], 1, row),
                           torch.gather(tt[gg - 1], 1, row), valid))
            row = torch.where(valid, torch.gather(tp[gg - 1], 1, row), row)
        out_toks = _take(init_toks, row, 0)
        out_ts = _take(init_ts, row, 0)
        frame_w = frame[:, None].expand(B, W).to(torch.int32)
        for pos_w, tok_w, valid in reversed(writes):
            p = pos_w[:, :, None]
            cur_t = torch.gather(out_toks, 2, p)[:, :, 0]
            cur_s = torch.gather(out_ts, 2, p)[:, :, 0]
            out_toks = out_toks.scatter(2, p, torch.where(valid, tok_w.to(torch.int32),
                                                          cur_t)[:, :, None])
            out_ts = out_ts.scatter(2, p, torch.where(valid, frame_w, cur_s)[:, :, None])
        fin["toks"], fin["ts"] = out_toks, out_ts
        if self.score_thresh is not None:
            fin["scores"] = _apply_score_thresh(fin["scores"], fin["lens"], self.score_thresh)
        if self.fe_limit is not None:
            fin["scores"], fin["committed"], fin["since_final"] = _final_emission_prune(
                fin["scores"], out_toks, fin["lens"], state["committed"],
                state["since_final"], self.fe_limit)
        fin["frame"] = frame + 1
        return {k: fin[k] for k in state}


def make_streaming_beam_step(model, blank_idx: int, beam_width: int = 4, expansions: int = 4,
                             temperature: float = 1.4, cap: int = 256, ngram_lm=None,
                             ngram_alpha: float = 0.0, keywords=None, merge: bool = True,
                             score_thresh: Optional[float] = None,
                             topk_thresh: Optional[float] = None,
                             final_emission_frames: Optional[int] = None):
    """Returns (init_state, step) as the JAX function does:
    ``init_state(params, B, dtype)`` on the device of ``params`` (a tree as
    ``RNNT.param_tree`` gives) and ``step(params, f [B, Hj], state)``."""
    s = StreamingBeamStep(model, blank_idx, beam_width, expansions, temperature, cap,
                          ngram_lm, ngram_alpha, keywords, merge, score_thresh, topk_thresh,
                          final_emission_frames)
    return s.init_state, s.step
