"""Greedy streaming decisions held against the reference.

A greedy streaming decoder makes, at each 60 ms encoder frame, up to
``max_symbols`` decisions: each emitted token, then a blank unless the cap
was reached. ``decision_gaps`` walks the served tokens of some streams
through the reference: at every decision it reads how far the served
token's logit lies below the reference's best (0 where they agree). With a
control precision it also reads, at the same decisions, the gap of the
token that the control puts first."""

from __future__ import annotations

from typing import List, Optional

import torch

from benchmark.reference import model
from benchmark.reference.precision import PRECISIONS, Precision


@torch.no_grad()
def decision_gaps(w, rnnt: dict, blank: int, feats: List[torch.Tensor],
                  served: List[List[List[int]]], max_symbols: int,
                  control: Optional[Precision] = None) -> dict:
    """feats: [T, L, 240] of L streams from their first chunk, by the
    reference's front end (and, after it, by the control's); ``served[l][t]``
    the tokens stream l was served at frame t. Returns the widest gap of a
    served decision, the decisions counted, and with ``control`` the widest
    gap of the control's first choice at the same decisions."""
    ref = PRECISIONS["fp32"]
    sides = [(ref, None)] + ([(control, None)] if control is not None else [])
    encs = [model.encode(w, rnnt, x, pr)[0] for x, (pr, _) in zip(feats, sides)]  # [L, F, Hj]
    L, F = encs[0].shape[:2]
    if any(len(s) < F for s in served):
        raise ValueError("fewer served frames than encoder frames")
    dev = feats[0].device
    Lp, Hp = rnnt["pred_rnn_layers"], rnnt["pred_n_hid"]
    zero = torch.zeros((Lp, L, Hp), device=dev)
    states = [model.pred_step(w, rnnt, None, (zero, zero), pr) for pr, _ in sides]
    worst = torch.zeros((), device=dev)
    worst_ctl = torch.zeros((), device=dev)
    n_dec = 0
    for t in range(F):
        toks = [served[lane][t] for lane in range(L)]
        n = torch.tensor([len(x) for x in toks], device=dev)
        for i in range(min(max(len(x) for x in toks) + 1, max_symbols)):
            tok = torch.tensor([x[i] if i < len(x) else blank for x in toks], device=dev)
            active = (i < n) | ((i == n) & (n < max_symbols))
            logits = [model.joint_logits(w, e[:, t], g, pr) for e, (g, _), (pr, _)
                      in zip(encs, states, sides)]
            best = logits[0].amax(1)
            gap = best - logits[0].gather(1, tok[:, None])[:, 0]
            worst = torch.maximum(worst, torch.where(active, gap, 0.0).amax())
            if control is not None:
                pick = logits[1].argmax(1)
                gap_c = best - logits[0].gather(1, pick[:, None])[:, 0]
                worst_ctl = torch.maximum(worst_ctl, torch.where(active, gap_c, 0.0).amax())
            n_dec += int(active.sum())
            emit = i < n
            if not bool(emit.any()):
                break
            new = []
            for (g, st), (pr, _) in zip(states, sides):
                g2, st2 = model.pred_step(w, rnnt, torch.where(emit, tok, 0), st, pr)
                new.append((torch.where(emit[:, None], g2, g),
                            tuple(torch.where(emit[None, :, None], a, b)
                                  for a, b in zip(st2, st))))
            states = new
    out = {"worst_gap": float(worst), "decisions": n_dec}
    if control is not None:
        out["worst_gap_control"] = float(worst_ctl)
    return out

