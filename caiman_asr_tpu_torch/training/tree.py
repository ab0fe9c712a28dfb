"""Parameter trees: nested dicts with tensors for leaves, the layout of the
JAX package's parameter pytrees (``RNNT.param_tree``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple

import torch

Tree = Dict[str, Any]


def tree_items(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) pairs in insertion order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from tree_items(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """A tree of fn(leaf, *matching leaves of rest), same structure."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}
