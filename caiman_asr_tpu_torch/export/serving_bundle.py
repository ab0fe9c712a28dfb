"""Serving bundles, the ``.npz`` the inference server loads (the port of
``caiman_asr_tpu/export/serving_bundle.py``; the reference's "hardware
checkpoint", export/hardware_ckpt.py:1-183): fp32 weights under
``weights/<path>`` (the EMA where the checkpoint has one), the dataset mel
statistics (``melmeans``, ``melvars``), the SentencePiece model's bytes
(``sentencepiece``), an optional n-gram (``ngram``, ``ngram_scale``), and a
JSON ``bundle_meta`` (version, the config's ``rnnt`` block, step, best
WER, tokenizer keywords). A bundle this module writes loads in the JAX
package, and one the JAX package writes loads here; the weights go into a
model through ``export/from_jax.load_jax_params``.

Gates (reference hardware_ckpt.py:60-100 + checkpointer.py:106-140):
``logmel_norm_weight`` must be 1.0 (the mel-normalisation ramp complete:
the server normalises with dataset statistics only), and the parameter
shapes must match a supported ``ModelVariant`` schema unless
``--skip_state_dict_check``.

CLI: python -m caiman_asr_tpu_torch.export.serving_bundle --ckpt best.npz \
       --config configs/base-8703sp.yaml --mel_stats stats.npz --output hw.npz
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from caiman_asr_tpu_torch.export.checkpointer import (flatten_named, load_checkpoint,
                                                      unflatten_named)

BUNDLE_VERSION = 1


def create_serving_bundle(
    ckpt_path: str | Path,
    config_path: str | Path,
    output_path: str | Path,
    mel_stats_path: Optional[str | Path] = None,
    sentencepiece_path: Optional[str | Path] = None,
    ngram_path: Optional[str | Path] = None,
    ngram_scale: Optional[float] = None,
    skip_state_dict_check: bool = False,
    use_ema: bool = True,
) -> Path:
    """Write the bundle of checkpoint ``ckpt_path`` under ``config_path``'s
    model to ``output_path``: the EMA weights (unless ``use_ema`` is False
    or the checkpoint has none) without the pruned loss's training-only
    ``simple_am`` / ``simple_lm`` heads, the statistics of
    ``mel_stats_path``, the tokenizer file (``sentencepiece_path`` or the
    config's) and the n-gram (``ngram_path`` or the config's) where they
    exist. Raises ``ValueError`` when the checkpoint's
    ``logmel_norm_weight`` is not 1.0 and ``CheckpointNotSupportedError``
    when the shapes match no supported model (unless
    ``skip_state_dict_check``)."""
    from caiman_asr_tpu_torch.export.model_schema import check_schema_training
    from caiman_asr_tpu_torch.lm.ngram import find_ngram_path
    from caiman_asr_tpu_torch.models.config import load_config, load_raw

    params, ema, _, meta = load_checkpoint(ckpt_path)
    weights = ema if (use_ema and ema is not None) else params
    weights = {k: v for k, v in weights.items() if k not in ("simple_am", "simple_lm")}

    norm_w = float(meta.get("logmel_norm_weight", 0.0))
    if not math.isclose(norm_w, 1.0):
        raise ValueError(
            f"logmel_norm_weight is {norm_w}, not 1.0: the mel-norm ramp did not "
            "complete during training; --resume past --norm_ramp_end_step first.")
    check_schema_training(weights, skip_state_dict_check)

    cfg, raw = load_config(config_path), load_raw(config_path)
    payload = {f"weights/{k}": np.asarray(v, np.float32)
               for k, v in flatten_named(weights).items()}
    if mel_stats_path is not None:
        with np.load(mel_stats_path) as z:
            payload["melmeans"] = np.asarray(z["melmeans"], np.float32)
            payload["melvars"] = np.asarray(z["melvars"], np.float32)
    spm = sentencepiece_path or cfg.tokenizer.sentpiece_model
    if spm and Path(spm).exists():
        payload["sentencepiece"] = np.frombuffer(Path(spm).read_bytes(), dtype=np.uint8)
    ng = ngram_path
    if ng is None and cfg.ngram.ngram_path:
        ng = find_ngram_path(cfg.ngram.ngram_path)
    if ng and Path(ng).exists():
        payload["ngram"] = np.frombuffer(Path(ng).read_bytes(), dtype=np.uint8)
        payload["ngram_scale"] = np.float32(
            ngram_scale if ngram_scale is not None else cfg.ngram.scale_factor)
    info = {
        "version": BUNDLE_VERSION,
        "rnnt_config": raw.get("rnnt", {}),
        "step": meta.get("step"),
        "best_wer": meta.get("best_wer"),
        "tokenizer_kw": meta.get("tokenizer_kw", {}),
    }
    payload["bundle_meta"] = np.frombuffer(json.dumps(info).encode("utf-8"), dtype=np.uint8)
    output_path = Path(output_path)
    with open(output_path, "wb") as fh:
        np.savez(fh, **payload)
    return output_path


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



def main(argv=None):
    p = argparse.ArgumentParser(description="Build a serving bundle")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--output_ckpt", "--output", dest="output", required=True)
    p.add_argument("--mel_stats", default=None)
    p.add_argument("--sentencepiece", default=None)
    p.add_argument("--ngram_path", default=None)
    p.add_argument("--ngram_scale_factor", type=float, default=None)
    p.add_argument("--skip_ngram", action="store_true")
    p.add_argument("--skip_state_dict_check", action="store_true")
    args = p.parse_args(argv)
    out = create_serving_bundle(
        args.ckpt, args.config, args.output, mel_stats_path=args.mel_stats,
        sentencepiece_path=args.sentencepiece,
        ngram_path=None if args.skip_ngram else args.ngram_path,
        ngram_scale=args.ngram_scale_factor,
        skip_state_dict_check=args.skip_state_dict_check)
    print(f"wrote serving bundle {out}")


if __name__ == "__main__":
    main()
