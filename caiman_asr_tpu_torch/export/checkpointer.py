"""Checkpoint files in the JAX package's format (the port of
``caiman_asr_tpu/export/checkpointer.py:34-180``).

One ``.npz`` a checkpoint: ``params/<a/b/c>`` and ``ema/<a/b/c>``, the
weights by name in the layout of ``RNNT.param_tree``; ``extra/<name>``,
auxiliary arrays (the carried RNN-T state of random state passing);
``opt/<i>``, the optimizer's leaves; ``meta``, a JSON blob (epoch, step,
best WER, ...). A checkpoint the JAX package writes loads here, and one
written here loads there. Writing the optimizer's leaves, restoring them
(``restore_opt_state``), the directory manager (``Checkpointer``) and
``average_checkpoints`` come with the training entry point.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from caiman_asr_tpu_torch.training.tree import tree_items


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_named(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict (or list) of arrays or tensors -> ``{"a/b/c": numpy
    array}``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_named(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_named(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def unflatten_named(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": array}`` -> nested dicts (numeric keys stay strings, as
    the JAX package rebuilds them)."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def save_checkpoint(
    path: str | Path,
    params,
    ema_params=None,
    meta: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Path:
    """Write one checkpoint file atomically (a temporary file, then a
    rename). ``params`` / ``ema_params``: trees as ``RNNT.param_tree`` gives
    them (tensors on any device, or numpy); ``extra``: named auxiliary
    arrays, stored under ``extra/``."""
    path = Path(path)
    payload: Dict[str, np.ndarray] = {}
    for k, v in flatten_named(params).items():
        payload[f"params/{k}"] = v
    if ema_params is not None:
        for k, v in flatten_named(ema_params).items():
            payload[f"ema/{k}"] = v
    for k, v in (extra or {}).items():
        payload[f"extra/{k}"] = _to_numpy(v)
    payload["meta"] = np.frombuffer(json.dumps(dict(meta or {})).encode("utf-8"), dtype=np.uint8)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)
    return path


def load_extra(path: str | Path) -> Dict[str, np.ndarray]:
    """The ``extra/`` auxiliary arrays of a checkpoint (empty if none)."""
    with np.load(path) as z:
        return {k[len("extra/"):]: z[k] for k in z.keys() if k.startswith("extra/")}


def load_checkpoint(
    path: str | Path,
) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], Optional[List[np.ndarray]], Dict]:
    """(params, EMA params or None, the optimizer's leaves or None, meta),
    the trees as nested dicts of numpy arrays."""
    with np.load(path) as z:
        keys = list(z.keys())
        meta = json.loads(bytes(z["meta"]).decode("utf-8")) if "meta" in keys else {}
        params = unflatten_named(
            {k[len("params/"):]: z[k] for k in keys if k.startswith("params/")})
        ema_flat = {k[len("ema/"):]: z[k] for k in keys if k.startswith("ema/")}
        ema = unflatten_named(ema_flat) if ema_flat else None
        opt_keys = sorted((k for k in keys if k.startswith("opt/")), key=lambda k: int(k[4:]))
        opt_leaves = [z[k] for k in opt_keys] if opt_keys else None
    return params, ema, opt_leaves, meta


@torch.no_grad()
def apply_params(template_params, loaded, allow_partial: bool = False):
    """Copy ``loaded`` (a tree of arrays) into the tensors of
    ``template_params`` (``model.param_tree()``), by name, in place, cast to
    each tensor's dtype; returns the template.

    A name the template does not know raises (the training-only
    ``simple_am`` / ``simple_lm`` heads of a pruned-loss checkpoint are
    skipped); a missing name raises unless ``allow_partial``, which keeps
    the template's values; shapes must match."""
    t_flat = {"/".join(path): t for path, t in tree_items(template_params)}
    l_flat = flatten_named(loaded)
    extra = {k for k in set(l_flat) - set(t_flat)
             if k.split("/")[0] not in ("simple_am", "simple_lm")}
    if extra:
        raise ValueError(f"checkpoint has unknown parameters: {sorted(extra)[:8]}")
    missing = set(t_flat) - set(l_flat)
    if missing and not allow_partial:
        raise ValueError(f"checkpoint is missing parameters: {sorted(missing)[:8]} "
                         "(pass allow_partial=True to keep fresh values)")
    for k, t in t_flat.items():
        if k not in l_flat:
            continue
        v = l_flat[k]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {k}: {v.shape} vs {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(v)).to(t.dtype))
    return template_params
