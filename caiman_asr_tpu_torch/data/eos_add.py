"""Segment manifest transcripts and insert EOS tokens (the port of
``caiman_asr_tpu/data/eos_add.py``; reference scripts/eos_add.py +
data/segment_manifest.py).

Run: python -m caiman_asr_tpu_torch.data.eos_add --data_dir d --manifests in.json \
       --output_dir o [--out_manifests in.eos.json] [--eos_token "<EOS>"]
       [--overwrite] [--append_only]

Default mode sentence-segments each transcript (wtpsplit SaT when
installed, rule-based splitter otherwise — see data/segment_manifest.py)
and adds one EOS per agreed sentence boundary plus an ``eos_count`` field;
``--append_only`` instead appends a single EOS at the end of every
transcript (this module's original behavior).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from caiman_asr_tpu_torch.data.segment_manifest import add_eos_to_manifest_avoid_empty
from caiman_asr_tpu_torch.utils.user_tokens import is_tag


def _append_only(entries, eos_token):
    for e in entries:
        t = e["transcript"].rstrip()
        if not t.endswith(eos_token):
            e["transcript"] = f"{t} {eos_token}"
    return entries


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Segment transcripts and insert an EOS token"
    )
    p.add_argument("--data_dir", default=".",
                   help="Directory containing the input manifests.")
    p.add_argument("--manifests", "--manifest", nargs="+", required=True,
                   help="Manifests to process (relative to --data_dir).")
    p.add_argument("--output_dir", default=None,
                   help="Where to save the modified manifests "
                        "(default: --data_dir).")
    p.add_argument("--out_manifests", "--output", nargs="+", default=None,
                   help="Output manifest names (default: *.eos.json).")
    p.add_argument("--overwrite", action="store_true",
                   help="Overwrite existing output files.")
    p.add_argument("--eos_token", default="<EOS>")
    p.add_argument("--no_cuda", action="store_true",
                   help="Segment on CPU (only relevant with wtpsplit).")
    p.add_argument("--append_only", action="store_true",
                   help="Skip segmentation; append one EOS per transcript.")
    args = p.parse_args(argv)

    if not is_tag(args.eos_token):
        raise SystemExit(f"EOS token must be in form '<tag>': {args.eos_token!r}")

    manifests = [Path(m) for m in args.manifests]
    if args.out_manifests is None:
        out_manifests = [m.with_suffix(".eos.json") for m in manifests]
    else:
        out_manifests = [Path(m) for m in args.out_manifests]
        if len(out_manifests) != len(manifests):
            raise SystemExit("--out_manifests must match --manifests in length")
    output_dir = Path(args.output_dir) if args.output_dir else Path(args.data_dir)

    for manifest, out_manifest in zip(manifests, out_manifests):
        ifile = Path(args.data_dir) / manifest
        ofile = output_dir / out_manifest
        if ofile.exists() and not args.overwrite:
            print(f"Skipping {ofile}, use --overwrite to overwrite.")
            continue
        if not ofile.parent.exists():
            print(f"Skipping {ofile}, the output directory does not exist.")
            continue

        with open(ifile) as fh:
            entries = json.load(fh)
        if args.append_only:
            out = _append_only(entries, args.eos_token)
        else:
            out = add_eos_to_manifest_avoid_empty(
                entries, args.eos_token, use_accel=not args.no_cuda
            )
        with open(ofile, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"wrote {ofile} ({len(out)} entries)")


if __name__ == "__main__":
    main()
