"""Sweep the n-gram shallow-fusion scale factor over validation (the port
of ``caiman_asr_tpu/lm/sweep_scale_factor.py``; reference:
lm/sweep_scale_factor.py): runs the beam decoder at several
``--ngram_scale_factor`` values and reports the best.

Run: python -m caiman_asr_tpu_torch.lm.sweep_scale_factor \
       --model_config ... --ckpt best.npz --val_manifests dev.json \
       --ngram_path DATA/ngram/ngram.arpa --scales 0.0 0.05 0.1 0.2 [--cpu]
"""

from __future__ import annotations

import json

from caiman_asr_tpu_torch.val import val_arg_parser, validate


def main(argv=None):
    parser = val_arg_parser()
    parser.add_argument("--scales", "--scale_factors", dest="scales",
                        type=float, nargs="+",
                        default=[0.0, 0.025, 0.05, 0.1, 0.2])
    args = parser.parse_args(argv)
    args.decoder = "beam"
    results = []
    for scale in args.scales:
        args.ngram_scale_factor = scale
        res = validate(args)
        results.append({"scale": scale, "wer": res.wer})
        print(f"scale={scale}: WER {res.wer:.2%}")
    best = min(results, key=lambda r: r["wer"])
    print(json.dumps({"results": results, "best": best}, indent=1))
    return results


if __name__ == "__main__":
    main()
