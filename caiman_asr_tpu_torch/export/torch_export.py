"""Convert a ``.npz`` checkpoint (the JAX package's format, which the port
reads and writes) into a reference torch ``.pt`` — the inverse of
``torch_import``; the port of ``caiman_asr_tpu/export/torch_export.py`` —
so models trained here can be loaded by MyrtleSoftware/caiman-asr (``--fine_tune`` weight loads, CPU
validation, or its FPGA hardware-checkpoint exporter) without retraining.

Key layout produced (reference rnnt/model.py:184-225, state_dict dedup at
:460-491 — ``joint_fc.*`` is NOT emitted; the reference re-derives it from
``joint_net.2.*`` on load):

  encoder.pre_rnn.lstm.weight_ih_l{i}       (plain stacks)
  encoder.pre_rnn.lstms.{i}.weight_ih_l0    (batch-norm stacks)
  encoder.pre_rnn.batch_norms.{i}.{weight,bias,running_mean,running_var,
                                   num_batches_tracked}
  prediction.embed.weight
  joint_enc.{weight,bias}  joint_pred.{weight,bias}  joint_net.2.{weight,bias}

Tensor layouts are identical (LSTM [4H, in] i,f,g,o; Linear [out, in]):
conversion is pure renaming. These are the names of the port's own
``RNNT.state_dict()``, so the port loads an exported ``state_dict`` strictly
(``torch_import.load_into``). Training-only leaves with no reference
analogue (the pruned-loss simple heads ``simple_am``/``simple_lm``) are
dropped.

Run:  python -m caiman_asr_tpu_torch.export.torch_export ckpt.npz out.pt
"""

from __future__ import annotations

import argparse
import re
from typing import Dict

import numpy as np

from caiman_asr_tpu_torch.export.checkpointer import flatten_named, load_checkpoint

_LSTM_FIELD = {"w_ih": "weight_ih", "w_hh": "weight_hh",
               "b_ih": "bias_ih", "b_hh": "bias_hh"}
_BN_FIELD = {"scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
_DROPPED = ("simple_am", "simple_lm")  # pruned-loss training heads


def export_state_dict(params) -> Dict[str, np.ndarray]:
    """Our params pytree -> reference-named flat state_dict (numpy values).

    Stacks containing batch-norm leaves emit the reference's stacked-1-layer
    naming (``lstms.{i}.*_l0`` + ``batch_norms.{i}.*``); plain stacks emit
    the multi-layer ``lstm.*_l{i}`` naming — exactly what the reference's
    two LSTM constructions produce (rnn.py:100-196 there)."""
    flat = flatten_named(params)
    bn_stacks = {
        k.split("/layer_")[0]
        for k in flat
        if "/bn/" in k
    }
    out: Dict[str, np.ndarray] = {}
    unmatched = []
    for key, val in flat.items():
        if key.split("/")[0] in _DROPPED:
            continue
        v = np.asarray(val)
        m = re.fullmatch(
            r"(encoder/(?:pre|post)_rnn|prediction/dec_rnn)/layer_(\d+)/"
            r"(w_ih|w_hh|b_ih|b_hh)", key
        )
        if m:
            stack, layer, field = m.groups()
            tstack = stack.replace("/", ".")
            if stack in bn_stacks:
                out[f"{tstack}.lstms.{layer}.{_LSTM_FIELD[field]}_l0"] = v
            else:
                out[f"{tstack}.lstm.{_LSTM_FIELD[field]}_l{layer}"] = v
            continue
        m = re.fullmatch(
            r"(encoder/(?:pre|post)_rnn|prediction/dec_rnn)/layer_(\d+)/bn/"
            r"(scale|bias|mean|var)", key
        )
        if m:
            stack, layer, field = m.groups()
            tstack = stack.replace("/", ".")
            out[f"{tstack}.batch_norms.{layer}.{_BN_FIELD[field]}"] = v
            # torch BN bookkeeping the reference's strict load expects
            out.setdefault(
                f"{tstack}.batch_norms.{layer}.num_batches_tracked",
                np.asarray(0, np.int64),
            )
            continue
        if key == "prediction/embed":
            out["prediction.embed.weight"] = v
            continue
        m = re.fullmatch(r"(joint_enc|joint_pred)/(w|b)", key)
        if m:
            field = "weight" if m.group(2) == "w" else "bias"
            out[f"{m.group(1)}.{field}"] = v
            continue
        m = re.fullmatch(r"joint_fc/(w|b)", key)
        if m:
            field = "weight" if m.group(1) == "w" else "bias"
            out[f"joint_net.2.{field}"] = v
            continue
        unmatched.append(key)
    if unmatched:
        raise ValueError(
            f"params leaves with no reference analogue: "
            f"{sorted(unmatched)[:8]}{' ...' if len(unmatched) > 8 else ''}"
        )
    return out


def export_checkpoint(npz_path: str, pt_path: str) -> dict:
    """Load our ``.npz`` and write a reference-layout torch ``.pt``
    ({state_dict, ema_state_dict, step, best_wer, epoch}). Returns meta."""
    import torch

    params, ema, _, meta = load_checkpoint(npz_path)
    to_t = lambda sd: {k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()}
    meta = meta or {}
    ckpt = {
        "epoch": int(meta.get("epoch", 0) or 0),
        "step": int(meta.get("step", 0) or 0),
        "best_wer": meta.get("best_wer"),
        "state_dict": to_t(export_state_dict(params)),
        "ema_state_dict": (
            to_t(export_state_dict(ema)) if ema is not None else None
        ),
        "optimizer": None,  # optimizer states do not translate (LAMB/optax
                            # vs apex FusedLAMB); reference --fine_tune
                            # loads weights only
        "exported_from": npz_path,
    }
    torch.save(ckpt, pt_path)
    return {"step": ckpt["step"], "n_tensors": len(ckpt["state_dict"])}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="convert our .npz checkpoint to a reference torch .pt"
    )
    p.add_argument("npz_path")
    p.add_argument("pt_path")
    args = p.parse_args(argv)
    meta = export_checkpoint(args.npz_path, args.pt_path)
    print(f"wrote {args.pt_path} "
          f"(step {meta['step']}, {meta['n_tensors']} tensors)")


if __name__ == "__main__":
    main()
