"""LAMB as the published trainer runs it: gradients made finite, the global
norm taken before clipping to ``clip_norm``, Adam moments with bias
correction at the incremented count, weight decay added to the direction,
the trust ratio ||p|| / ||u|| (1 where either is 0), the learning rate of
the schedule (linear warmup, hold, exponential decay, a floor) at the
count before the increment times the module's factor."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.weights import lr_group


def schedule(opt: dict, step: int) -> float:
    f32 = np.float32
    s, wu, hold = f32(step), opt["warmup_steps"], opt["hold_steps"]
    if s < wu:
        a = (s + f32(1.0)) / f32(wu + 1.0)
    elif s < wu + hold:
        a = f32(1.0)
    else:
        a = f32(0.5) ** ((s - f32(wu) - f32(hold)) / f32(opt["half_life_steps"]))
    return float(max(f32(a * f32(opt["lr"])), f32(opt["min_lr"])))


class Lamb:
    def __init__(self, params: Dict[str, torch.Tensor], opt: dict, lr_factors: Dict[str, float]):
        self.opt, self.factors = opt, lr_factors
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Updates ``params`` in place; returns the gradients as clipped."""
        o = self.opt
        g = {k: torch.nan_to_num(grads[k]) if grads.get(k) is not None
             else torch.zeros_like(p) for k, p in params.items()}
        norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
        scale = 1.0 if norm < o["clip_norm"] else o["clip_norm"] / norm
        g = {k: v * scale for k, v in g.items()}
        lr = schedule(o, self.count)
        self.count += 1
        bc1, bc2 = 1.0 - o["beta1"] ** self.count, 1.0 - o["beta2"] ** self.count
        for k, p in params.items():
            self.mu[k].mul_(o["beta1"]).add_((1.0 - o["beta1"]) * g[k])
            self.nu[k].mul_(o["beta2"]).add_((1.0 - o["beta2"]) * g[k] * g[k])
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + o["eps"]) \
                + o["weight_decay"] * p
            pn, un = p.norm(), u.norm()
            trust = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            p.add_(-lr * self.factors.get(lr_group(k), 1.0) * trust * u)
        return g
