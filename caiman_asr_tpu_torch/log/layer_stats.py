"""Per-parameter weight and gradient statistics
(``caiman_asr_tpu/log/layer_stats.py``): five scalars a leaf (weight norm,
weight std, gradient norm, gradient abs-max, gradient std), computed on the
device as one vector, so that logging them costs one host read a step.

The leaves are taken in the JAX package's order, its pytree flattening of
the parameter dicts by sorted key at every level (``training/tree.tree_items``
walks insertion order instead); the std is the population std.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.training.tree import Tree

STATS = ("weight-norm", "weight-std", "grad-norm", "grad-max", "grad-std")


def sorted_items(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                                           torch.Tensor]]:
    """(path, leaf) pairs in sorted-key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from sorted_items(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def layer_stat_names(params: Tree) -> List[str]:
    """``per-layer-<stat>/<dotted path>``, five a leaf, in the layout of
    :func:`layer_stats_vec`."""
    return [f"per-layer-{stat}/{'.'.join(path)}" for path, _ in sorted_items(params)
            for stat in STATS]


def layer_stats_vec(params: Tree, grads: Tree) -> torch.Tensor:
    """[5 * leaves] fp32: per leaf, the weight's norm and std and the
    gradient's norm, abs-max and std. ``grads`` has ``params``' layout."""
    vals = []
    for (path, p), (gpath, g) in zip(sorted_items(params), sorted_items(grads)):
        if path != gpath:
            raise ValueError(f"gradient tree differs from the parameters at {path}, {gpath}")
        p = p.detach().float().reshape(-1)
        g = g.detach().float().reshape(-1)
        vals.extend([torch.linalg.vector_norm(p), torch.std(p, correction=0),
                     torch.linalg.vector_norm(g), g.abs().max(), torch.std(g, correction=0)])
    return torch.stack(vals)


def layer_stats_dict(names: List[str], vec) -> Dict[str, float]:
    arr = vec.detach().cpu().numpy() if isinstance(vec, torch.Tensor) else np.asarray(vec)
    return {n: float(v) for n, v in zip(names, arr)}
