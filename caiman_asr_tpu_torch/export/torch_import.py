"""Convert a reference torch ``.pt`` checkpoint into the ``.npz`` layout (the
JAX package's format, which the port reads and writes; the port of
``caiman_asr_tpu/export/torch_import.py``), so models trained with MyrtleSoftware/caiman-asr can be
served/fine-tuned here without retraining.

The reference checkpoint (export/checkpointer.py:91-108 there) is a dict
with ``state_dict`` / ``ema_state_dict`` / ``step`` / ``best_wer``. Module
naming (rnnt/model.py:184-225 there):

  encoder.pre_rnn.lstm.weight_ih_l{i}       (plain stacks)
  encoder.pre_rnn.lstms.{i}.weight_ih_l0    (batch-norm stacks: 1-layer LSTMs)
  encoder.pre_rnn.batch_norms.{i}.{weight,bias,running_mean,running_var}
  encoder.post_rnn...                        (same shapes)
  prediction.embed.weight
  prediction.dec_rnn....
  joint_enc.{weight,bias}  joint_pred.{weight,bias}
  joint_net.{k}.weight     (the final Linear of the Sequential = joint_fc)

Tensor layouts are identical to ours (LSTM [4H, in] with i,f,g,o gate
order; Linear [out, in]), so conversion is pure renaming. The port's
``RNNT`` uses the reference names itself: :func:`load_into` loads a ``.pt``
straight into it.

Run:  python -m caiman_asr_tpu_torch.export.torch_import ckpt.pt out.npz
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Optional

import numpy as np

from caiman_asr_tpu_torch.export.checkpointer import save_checkpoint, unflatten_named

_LSTM_FIELD = {"weight_ih": "w_ih", "weight_hh": "w_hh",
               "bias_ih": "b_ih", "bias_hh": "b_hh"}
_BN_FIELD = {"weight": "scale", "bias": "bias",
             "running_mean": "mean", "running_var": "var"}


def convert_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torch state_dict (tensor or ndarray values) -> flat named-array dict
    in our ``flatten_named`` key layout (e.g. encoder/pre_rnn/layer_0/w_ih)."""
    out: Dict[str, np.ndarray] = {}
    unmatched = []
    for key, val in sd.items():
        v = np.asarray(getattr(val, "numpy", lambda: val)())
        # plain multi-layer stack: <stack>.lstm.weight_ih_l{i}
        m = re.fullmatch(
            r"(encoder\.(?:pre|post)_rnn|prediction\.dec_rnn)\.lstm\."
            r"(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)", key
        )
        if m:
            stack, field, layer = m.groups()
            out[f"{stack.replace('.', '/')}/layer_{layer}/{_LSTM_FIELD[field]}"] = v
            continue
        # batch-norm stack: <stack>.lstms.{i}.<field>_l0
        m = re.fullmatch(
            r"(encoder\.(?:pre|post)_rnn|prediction\.dec_rnn)\.lstms\.(\d+)\."
            r"(weight_ih|weight_hh|bias_ih|bias_hh)_l0", key
        )
        if m:
            stack, layer, field = m.groups()
            out[f"{stack.replace('.', '/')}/layer_{layer}/{_LSTM_FIELD[field]}"] = v
            continue
        m = re.fullmatch(
            r"(encoder\.(?:pre|post)_rnn|prediction\.dec_rnn)\.batch_norms\.(\d+)\."
            r"(weight|bias|running_mean|running_var)", key
        )
        if m:
            stack, layer, field = m.groups()
            out[f"{stack.replace('.', '/')}/layer_{layer}/bn/{_BN_FIELD[field]}"] = v
            continue
        if re.fullmatch(r".*\.num_batches_tracked", key):
            continue  # torch BN bookkeeping; momentum here is constant
        if key == "prediction.embed.weight":
            out["prediction/embed"] = v
            continue
        m = re.fullmatch(r"(joint_enc|joint_pred)\.(weight|bias)", key)
        if m:
            out[f"{m.group(1)}/{'w' if m.group(2) == 'weight' else 'b'}"] = v
            continue
        m = re.fullmatch(r"joint_net\.\d+\.(weight|bias)", key)
        if m:
            out[f"joint_fc/{'w' if m.group(1) == 'weight' else 'b'}"] = v
            continue
        unmatched.append(key)
    if unmatched:
        raise ValueError(
            f"unrecognised reference checkpoint keys: {sorted(unmatched)[:8]}"
            f"{' ...' if len(unmatched) > 8 else ''}"
        )
    return out


def convert_checkpoint(pt_path: str, npz_path: str,
                       use_ema_as_params: bool = False) -> dict:
    """Load a reference ``.pt`` and write our ``.npz``. Returns the meta."""
    import torch

    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    params = unflatten_named(convert_state_dict(sd))
    ema = None
    if isinstance(ckpt, dict) and ckpt.get("ema_state_dict") is not None:
        ema = unflatten_named(convert_state_dict(ckpt["ema_state_dict"]))
    if use_ema_as_params and ema is not None:
        params = ema
    best_wer = ckpt.get("best_wer") if isinstance(ckpt, dict) else None
    meta = {
        "step": int(ckpt.get("step", 0)) if isinstance(ckpt, dict) else 0,
        "best_wer": float(best_wer) if best_wer is not None else None,
        "converted_from": pt_path,
    }
    save_checkpoint(npz_path, params, ema_params=ema, meta=meta)
    return meta


def load_into(model, pt_path: str, use_ema: bool = True) -> dict:
    """Load a reference-layout ``.pt`` (its EMA weights where it has them and
    ``use_ema``) into the port's ``RNNT``, strictly. ``joint_fc`` is the
    reference's ``joint_net.2``; ``num_batches_tracked`` is bookkeeping the
    model does not hold. Returns the checkpoint's step and which weights."""
    import torch

    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    which = "ema_state_dict" if use_ema and ckpt.get("ema_state_dict") is not None \
        else "state_dict"
    own = model.state_dict()
    sd = {}
    for k, v in ckpt[which].items():
        if k not in own and k.endswith("num_batches_tracked"):
            continue
        t = torch.as_tensor(v)
        sd[k] = t.to(own[k].device, own[k].dtype) if k in own else t
    model.load_state_dict(sd, strict=True)
    return {"step": int(ckpt.get("step", 0) or 0), "weights": which}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="convert a reference torch .pt checkpoint to .npz"
    )
    p.add_argument("pt_path")
    p.add_argument("npz_path")
    p.add_argument("--use_ema_as_params", action="store_true",
                   help="write EMA weights into the primary slot too")
    args = p.parse_args(argv)
    meta = convert_checkpoint(args.pt_path, args.npz_path,
                              args.use_ema_as_params)
    print(f"wrote {args.npz_path} (step {meta['step']})")


if __name__ == "__main__":
    main()
