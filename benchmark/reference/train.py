"""The training steps of the reference, from the benchmark's weights and
microbatches: features with SpecAugment, the encoder and predictor with
dropout, the joint with dropout, the transducer loss summed over the
utterances and divided by A * B, the gradients summed over the A
microbatches, then LAMB. Dither, SpecAugment and dropout are drawn from
each step's seed in the published trainer's order (``follow``), so both
sides draw the same masks from the benchmark's seed."""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import frontend, model
from benchmark.reference.lamb import Lamb
from benchmark.reference.precision import Precision

# the faults a run can plant in the reference put in the program's place
FAULTS = ("half_batch",)


def follow(cfg: dict, weights: Dict[str, torch.Tensor], steps: List[dict], pr: Precision,
           fault: str = "") -> dict:
    """Run ``steps`` from ``weights``: each step a dict of its generator
    ``seed``, its ``pack_to`` (the joint's rows, or None) and its A
    microbatches (audio [B, S], audio_lens, txt [B, U], txt_lens). Returns
    each step's loss, the first step's gradients as LAMB took them (clipped)
    and the parameters after the last step.

    The random draws are the published step's, from a generator on the
    device seeded with the step's seed, in its order: each microbatch's
    dither and SpecAugment; then, microbatch by microbatch, the encoder's
    and the predictor's dropout masks (between layers and on each stack's
    output) and the joint's, over the padded shapes of the step."""
    rnnt, K = cfg["rnnt"], cfg["n_classes"]
    blank = K - 1
    params = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    factors = {"encoder": 1.0, "prediction": 1.0, "joint_enc": 1.0, "joint_pred": 1.0,
               "joint_fc": rnnt["joint_net_lr_factor"]}
    opt = Lamb(params, cfg["optimizer"], factors)
    dev = next(iter(weights.values())).device
    losses, first = [], None
    for st in steps:
        micro = st["micro"]
        A = len(micro)
        gen = torch.Generator(device=dev).manual_seed(st["seed"])
        feats = [frontend.train_features(mb["audio"], mb["audio_lens"], cfg["spec_augment"], gen,
                                         cfg["dither"], pr) for mb in micro]
        T = max(x.shape[0] for x, _ in feats)
        U = max(mb["txt"].shape[1] for mb in micro)
        grads = {k: None for k in params}
        total = 0.0
        for (x, fl), mb in zip(feats, micro):
            B = x.shape[1]
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, T - x.shape[0]))
            txt = torch.nn.functional.pad(mb["txt"], (0, U - mb["txt"].shape[1]))
            f, _ = model.encode(params, rnnt, x, pr, gen, train=True)
            f_lens = -(-fl // rnnt["enc_stack_time_factor"])
            g = model.predict(params, rnnt, txt, pr, gen, train=True)
            bl, ll = model.lattice_scores(params, f, g, txt, f_lens, mb["txt_lens"], blank, pr,
                                          rnnt["joint_dropout"], gen, st["pack_to"])
            nll = model.transducer_nll(bl, ll, f_lens, mb["txt_lens"])
            if fault == "half_batch":
                loss = nll[:B // 2].sum() / (A * (B // 2))
            else:
                loss = nll.sum() / (A * B)
            names = list(params)
            got = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
            for k, gk in zip(names, got):
                if gk is not None:
                    grads[k] = gk if grads[k] is None else grads[k] + gk
            total += float(loss.detach())
            del f, g, bl, ll, nll, loss, got
        del feats
        clipped = opt.step(params, grads)
        if first is None:
            first = {k: v.detach() for k, v in clipped.items()}
        losses.append(total)
    return {"losses": losses, "first_grads": first,
            "params": {k: v.detach() for k, v in params.items()}}
