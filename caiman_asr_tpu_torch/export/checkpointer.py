"""Checkpoint files in the JAX package's format (the port of
``caiman_asr_tpu/export/checkpointer.py``).

One ``.npz`` a checkpoint: ``params/<a/b/c>`` and ``ema/<a/b/c>``, the
weights by name in the layout of ``RNNT.param_tree``; ``extra/<name>``,
auxiliary arrays (the carried RNN-T state of random state passing);
``opt/<i>``, the optimizer's leaves in the order of the JAX package's optax
chain (Adam's count, the first moments and the second moments each in
sorted-key order, the schedule's count) with ``meta["_opt_fingerprint"]``;
``meta``, a JSON blob (epoch, step, best WER, ...). A checkpoint the JAX
package writes loads here, its optimizer state included, and one written
here loads there. ``Checkpointer`` manages a directory of them (tracked
``step{N}.npz``, ``last.npz``, ``best.npz``); ``average_checkpoints``
averages weights over several.
"""

from __future__ import annotations

import json
import os
import re
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


def _sorted_leaves(tree) -> List[Any]:
    """The leaves of a nested dict in sorted-key order (JAX's flatten)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    return [tree]


def opt_leaves(opt_state) -> List[np.ndarray]:
    """A ``training/optimizer.LambState`` as the JAX package's optax state
    flattens: Adam's count (int32), the first moments, the second moments,
    the schedule's count (int32)."""
    return ([np.asarray(opt_state.count, np.int32)]
            + [_to_numpy(m) for m in _sorted_leaves(opt_state.mu)]
            + [_to_numpy(v) for v in _sorted_leaves(opt_state.nu)]
            + [np.asarray(opt_state.sched_count, np.int32)])


def _fingerprint(leaves: List[np.ndarray]) -> str:
    """The JAX package's structure fingerprint of the optimizer's leaves."""
    return f"{len(leaves)}:" + ",".join(f"{l.shape}{l.dtype}" for l in leaves[:64])


def save_checkpoint(
    path: str | Path,
    params,
    ema_params=None,
    opt_state=None,
    meta: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Path:
    """Write one checkpoint file atomically (a temporary file, then a
    rename). ``params`` / ``ema_params``: trees as ``RNNT.param_tree`` gives
    them (tensors on any device, or numpy); ``opt_state``: a ``LambState``,
    stored as ``opt/<i>`` (``opt_leaves``); ``extra``: named auxiliary
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
    meta = dict(meta or {})
    if opt_state is not None:
        leaves = opt_leaves(opt_state)
        for i, leaf in enumerate(leaves):
            payload[f"opt/{i}"] = leaf
        meta["_opt_fingerprint"] = _fingerprint(leaves)
    payload["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
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
def restore_opt_state(template, leaves: List[np.ndarray]):
    """A ``LambState`` from saved ``opt/`` leaves: the moments copied, in
    place, into ``template``'s tensors (a fresh ``Lamb.init``), the counts
    taken as ints."""
    from caiman_asr_tpu_torch.training.optimizer import LambState

    mu, nu = _sorted_leaves(template.mu), _sorted_leaves(template.nu)
    if len(leaves) != len(mu) + len(nu) + 2:
        raise ValueError(f"optimizer state mismatch: template has {len(mu) + len(nu) + 2} "
                         f"leaves, checkpoint has {len(leaves)}")
    for t, v in zip(mu + nu, leaves[1:-1]):
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"optimizer leaf shape mismatch: {v.shape} vs {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(v)).to(t.dtype))
    return LambState(template.mu, template.nu, int(leaves[0]), int(leaves[-1]))


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


class Checkpointer:
    """A directory of checkpoints (``caiman_asr_tpu/export/checkpointer.py``'s
    ``Checkpointer``): ``step{N}.npz`` (tracked), ``last.npz``, ``best.npz``."""

    STEP_RE = re.compile(r"step(\d+)\.npz$")

    def __init__(self, save_dir: str | Path, model_name: str = "RNN-T"):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.model_name = model_name
        self.tracked: Dict[int, Path] = {
            int(m.group(1)): p for p in sorted(self.save_dir.glob("step*.npz"))
            if (m := self.STEP_RE.search(p.name))}

    def save(self, params, ema_params, opt_state, epoch: int, step: int, best_wer: float, *,
             is_best: bool = False, is_last: bool = False,
             meta: Optional[Dict[str, Any]] = None,
             extra: Optional[Dict[str, Any]] = None) -> Path:
        """Write ``best.npz``, ``last.npz`` or the tracked ``step{step}.npz``;
        ``meta`` holds epoch, step and best WER, then ``meta``'s own keys."""
        m = {"epoch": int(epoch), "step": int(step), "best_wer": float(best_wer)}
        m.update(meta or {})
        if is_best:
            path = self.save_dir / "best.npz"
        elif is_last:
            path = self.save_dir / "last.npz"
        else:
            path = self.save_dir / f"step{step}.npz"
            self.tracked[step] = path
        return save_checkpoint(path, params, ema_params, opt_state, m, extra)

    def last_checkpoint(self) -> Optional[Path]:
        """The newest loadable checkpoint: ``last.npz``, else the tracked
        steps from the newest; a file that does not load is skipped with a
        warning."""
        candidates = [self.save_dir / "last.npz"] + [
            self.tracked[s] for s in sorted(self.tracked, reverse=True)]
        for p in candidates:
            if p.is_file():
                try:
                    load_checkpoint(p)
                    return p
                except Exception:
                    print(f"WARNING: checkpoint {p} appears corrupted; skipping")
        return None

    def load_for_resume(self, path, params, ema_params, opt_state):
        """Everything (``--resume``): the weights and EMA copied into the
        ``params`` / ``ema_params`` trees in place, the optimizer state
        restored into ``opt_state``'s tensors. Returns (params, EMA, optimizer
        state, meta)."""
        loaded, ema, leaves, meta = load_checkpoint(path)
        apply_params(params, loaded)
        apply_params(ema_params, ema if ema is not None else loaded)
        if leaves is not None:
            opt_state = restore_opt_state(opt_state, leaves)
        return params, ema_params, opt_state, meta

    def load_for_fine_tune(self, path, params, allow_partial: bool = False):
        """The weights only (``--fine_tune``), the EMA where the checkpoint
        has one, copied into ``params`` in place. Returns (params, meta)."""
        loaded, ema, _, meta = load_checkpoint(path)
        apply_params(params, ema if ema is not None else loaded, allow_partial=allow_partial)
        return params, meta


def average_checkpoints(paths: List[str | Path]):
    """(params, EMA, the first checkpoint's meta): the weights and the EMA
    (the weights where a checkpoint has none) averaged in float64 over
    ``paths``, as float32 trees of numpy arrays."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc_p, acc_e, meta0 = None, None, None
    n = len(paths)
    for p in paths:
        params, ema, _, meta = load_checkpoint(p)
        fp = flatten_named(params)
        fe = flatten_named(ema) if ema is not None else fp
        if acc_p is None:
            acc_p = {k: v.astype(np.float64) / n for k, v in fp.items()}
            acc_e = {k: v.astype(np.float64) / n for k, v in fe.items()}
            meta0 = meta
        else:
            if set(fp) != set(acc_p):
                raise ValueError("checkpoints have differing parameter sets")
            for k in acc_p:
                acc_p[k] += fp[k].astype(np.float64) / n
                acc_e[k] += fe[k].astype(np.float64) / n
    params = unflatten_named({k: v.astype(np.float32) for k, v in acc_p.items()})
    ema = unflatten_named({k: v.astype(np.float32) for k, v in acc_e.items()})
    return params, ema, meta0
