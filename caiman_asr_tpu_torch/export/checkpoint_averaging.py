"""Checkpoint averaging CLI (the port of
``caiman_asr_tpu/export/checkpoint_averaging.py``; reference
export/checkpoint_averaging.py:17-120).

Averages the weights and the EMA of N checkpoints into a new checkpoint
file, without optimizer state, keeping the newest input's meta.

Run: python -m caiman_asr_tpu_torch.export.checkpoint_averaging \
       --ckpts step1000.npz step2000.npz --output_path averaged.npz
"""

from __future__ import annotations

import argparse
from pathlib import Path

from caiman_asr_tpu_torch.export.checkpointer import (
    average_checkpoints,
    load_checkpoint,
    save_checkpoint,
)


def main(argv=None):
    p = argparse.ArgumentParser(description="Average N checkpoints")
    p.add_argument("--ckpts", "--checkpoints", nargs="+", required=True,
                   help="checkpoint paths to average (reference "
                        "export/checkpoint_averaging.py --checkpoints)")
    p.add_argument("--output_path", required=True)
    args = p.parse_args(argv)

    params, ema, _ = average_checkpoints(args.ckpts)
    newest = max(args.ckpts, key=lambda c: Path(c).stat().st_mtime)
    _, _, _, meta = load_checkpoint(newest)
    meta = dict(meta)
    meta.pop("_opt_fingerprint", None)
    meta["averaged_from"] = [str(c) for c in args.ckpts]
    save_checkpoint(args.output_path, params, ema, None, meta)
    print(f"averaged {len(args.ckpts)} checkpoints -> {args.output_path}")


if __name__ == "__main__":
    main()
