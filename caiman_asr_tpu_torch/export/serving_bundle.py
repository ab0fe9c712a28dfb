"""Read a serving bundle, the ``.npz`` that the JAX package's
``export/serving_bundle.py`` writes for the inference server: fp32 weights
under ``weights/<path>``, the dataset mel statistics (``melmeans``,
``melvars``), the SentencePiece model's bytes (``sentencepiece``), an
optional n-gram, and a JSON ``bundle_meta``. The weights go into a model
through ``export/from_jax.load_jax_params``. Writing bundles is not ported
yet."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from caiman_asr_tpu_torch.export.checkpointer import unflatten_named


def load_serving_bundle(path: str | Path):
    """Returns (weights tree of numpy arrays, extras dict, meta dict), as
    ``caiman_asr_tpu/export/serving_bundle.py:108-121``."""
    with np.load(path) as z:
        weights = unflatten_named(
            {k[len("weights/"):]: z[k] for k in z.files if k.startswith("weights/")})
        extras = {k: z[k] for k in z.files
                  if not k.startswith("weights/") and k != "bundle_meta"}
        meta = json.loads(bytes(z["bundle_meta"]).decode("utf-8"))
    return weights, extras, meta


def bundle_mel_stats(extras) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The bundle's (means, stds), or None when it carries no statistics."""
    if "melmeans" not in extras:
        return None
    return (np.asarray(extras["melmeans"], np.float32),
            np.sqrt(np.asarray(extras["melvars"], np.float32)))

