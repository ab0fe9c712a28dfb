"""Validate across multiple datasets and/or checkpoints (the port of
``caiman_asr_tpu/val_multiple.py``, over the port's ``val.validate``; on the
card, or on the CPU under ``--cpu``).

Reference parity: caiman_asr_train/val_multiple.py validates ONE checkpoint
over MULTIPLE datasets (`--all_dataset_dirs` + `--all_val_manifests`, with
optional `--custom_batch_sizes`, writing
``<output_dir>/validate_multiple.json`` and ``.csv``; overwriting gated on
``--overwrite_ok``). This module implements that mode, plus a
``--ckpt_glob`` sweep over checkpoints; given both, the full cross product
runs.

Run:
  python -m caiman_asr_tpu_torch.val_multiple --ckpt out/ckpts/best.npz \
      --all_dataset_dirs /d1 /d2 --all_val_manifests a.json b.json ...
  python -m caiman_asr_tpu_torch.val_multiple --ckpt_glob 'out/ckpts/step*.npz' ...
"""

from __future__ import annotations

import csv
import glob
import json
from copy import copy
from pathlib import Path

from caiman_asr_tpu_torch.val import val_arg_parser, validate


def add_val_multiple_args(parser):
    g = parser.add_argument_group("validate multiple")
    g.add_argument(
        "--ckpt_glob", type=str, default=None,
        help="validate every checkpoint matching this glob",
    )
    g.add_argument(
        "--all_dataset_dirs", "--all_data_dirs", dest="all_dataset_dirs",
        nargs="+", default=None,
        help="dataset dir per validation set (pairs with --all_val_manifests; "
             "--dataset_dir is ignored in this mode)",
    )
    g.add_argument(
        "--all_val_manifests", nargs="+", default=None,
        help="manifest per validation set (pairs with --all_dataset_dirs)",
    )
    g.add_argument(
        "--custom_batch_sizes", nargs="+", type=int, default=None,
        help="per-dataset batch size override (same length as "
             "--all_dataset_dirs); default: --val_batch_size everywhere",
    )
    g.add_argument(
        "--overwrite_ok", action="store_true",
        help="allow overwriting <output_dir>/validate_multiple.json",
    )


def _check(args):
    if args.all_dataset_dirs or args.all_val_manifests:
        if not (args.all_dataset_dirs and args.all_val_manifests):
            raise ValueError(
                "--all_dataset_dirs and --all_val_manifests go together"
            )
        if len(args.all_dataset_dirs) != len(args.all_val_manifests):
            raise ValueError(
                "--all_dataset_dirs and --all_val_manifests must be the "
                "same length"
            )
        if args.custom_batch_sizes is not None and len(
            args.custom_batch_sizes
        ) != len(args.all_dataset_dirs):
            raise ValueError(
                "--custom_batch_sizes must match --all_dataset_dirs in length"
            )
        for d, m in zip(args.all_dataset_dirs, args.all_val_manifests):
            if not (Path(d) / m).exists():
                raise FileNotFoundError(f"{Path(d) / m} does not exist")


def _dataset_jobs(args):
    """(label, per-run args) for every dataset x checkpoint combination."""
    ckpts = (
        sorted(glob.glob(args.ckpt_glob)) if args.ckpt_glob else [args.ckpt]
    )
    if args.ckpt_glob and not ckpts:
        raise FileNotFoundError(f"no checkpoints match {args.ckpt_glob}")
    if args.all_dataset_dirs:
        sets = list(
            zip(
                args.all_dataset_dirs,
                args.all_val_manifests,
                args.custom_batch_sizes
                or [args.val_batch_size] * len(args.all_dataset_dirs),
            )
        )
    else:
        sets = [(args.dataset_dir, m, args.val_batch_size)
                for m in (args.val_manifests or [])] or [
            (args.dataset_dir, None, args.val_batch_size)
        ]
    for ckpt in ckpts:
        for d, m, bs in sets:
            va = copy(args)
            va.ckpt = ckpt
            va.dataset_dir = d
            if m is not None:
                va.val_manifests = [m]
                name = Path(m).with_suffix("").name
            else:
                name = "val"
            va.val_batch_size = bs
            sub = Path(args.output_dir) / name
            if len(ckpts) > 1:
                sub = sub / Path(ckpt).with_suffix("").name
            va.output_dir = str(sub)
            label = str(Path(d) / m) if m is not None else name
            if len(ckpts) > 1:
                label = f"{ckpt}::{label}"
            yield label, va


def main(argv=None):
    parser = val_arg_parser()
    add_val_multiple_args(parser)
    args = parser.parse_args(argv)
    _check(args)

    out_json_fp = Path(args.output_dir) / "validate_multiple.json"
    out_csv_fp = Path(args.output_dir) / "validate_multiple.csv"
    if out_json_fp.exists() and not args.overwrite_ok:
        raise ValueError(
            f"refusing to overwrite {out_json_fp}; pass --overwrite_ok or a "
            "new --output_dir"
        )
    out_json_fp.parent.mkdir(parents=True, exist_ok=True)

    all_results = {}
    for label, va in _dataset_jobs(args):
        Path(va.output_dir).mkdir(parents=True, exist_ok=True)
        res = validate(va)
        all_results[label] = {"wer": res.wer, "loss": res.loss}
        print(f"{label}: WER {res.wer:.4%}"
              + (f"  loss {res.loss:.4f}" if res.loss is not None else ""))

    payload = dict(all_results)
    payload["args"] = {
        k: v for k, v in vars(args).items() if not k.startswith("_")
    }
    out_json_fp.write_text(json.dumps(payload, indent=2, default=str))

    with out_csv_fp.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Metric", *all_results.keys()])
        w.writeheader()
        w.writerow({
            "Metric": "WER",
            **{k: f"{v['wer']:.4f}" for k, v in all_results.items()},
        })
        w.writerow({
            "Metric": "loss",
            **{
                k: ("" if v["loss"] is None else f"{v['loss']:.4f}")
                for k, v in all_results.items()
            },
        })
    best = min(all_results.items(), key=lambda kv: kv[1]["wer"])
    print(json.dumps({"best": {"name": best[0], **best[1]}}))
    return all_results


if __name__ == "__main__":
    main()
