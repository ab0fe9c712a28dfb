"""Named-array trees, as the JAX package's checkpoints and serving bundles
store them (``caiman_asr_tpu/export/checkpointer.py:40-64``): a nested
dict of arrays flattened to ``{"a/b/c": array}``. Saving and loading whole
checkpoints are not ported yet."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def unflatten_named(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
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
