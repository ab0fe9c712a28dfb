"""How far the port's training run drifts from the JAX package's over many
steps, on ``synthetic_e2e``'s tone task, on the CPU.

Both packages' ``train.main`` start ``--fine_tune`` from one JAX-initialised
checkpoint (with the pruned loss's heads) under ``synthetic_e2e``'s flags,
with nothing random in the step: dropout 0 and dither 0 (the task's config
otherwise), fp32 unless ``--amp``. The batches are the same in both (the
samplers share the seed). The script prints each logged step's train loss
and gradient norm side by side, and for each window of 100 steps the
median and the largest relative loss difference and the mean signed one
(port − JAX over JAX): a fault in the port shows as a difference from the
first steps or as a sign that persists, rounding as a difference that starts
at ~1e-7 and grows without a sign, as it does between any two fp32
orderings of a chaotic training run.

Not a tier-1 test (minutes of CPU). Run from the repository root:

    JAX_PLATFORMS=cpu python tests/compare_training_drift.py --workdir /tmp/drift \\
        --steps 400 --pruned 4 [--amp]

``--pruned 0`` runs the dense loss, the baseline of the same drift.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _read_log(out: Path) -> dict:
    """{step: (loss, grad_norm)} of the train records under ``out``."""
    d = {}
    for f in sorted(out.glob("log_*.jsonl")):
        for line in f.read_text().splitlines():
            r = json.loads(line)
            if r.get("subset") == "train" and "loss" in r:
                d[r["step"][1]] = (r["loss"], r["grad_norm"])
    return d


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--pruned", type=int, default=4, metavar="S",
                   help="the pruned loss's band width; 0 for the dense loss")
    p.add_argument("--amp", action="store_true", help="bf16 compute (the task's default)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import jax

    from caiman_asr_tpu import train as jax_train
    from caiman_asr_tpu.args.train import train_arg_parser as jax_parser
    from caiman_asr_tpu.export.checkpointer import save_checkpoint as jax_save
    from caiman_asr_tpu.models.config import load_config as jax_load_config
    from caiman_asr_tpu.ops.pruned_loss import init_simple_params
    from caiman_asr_tpu.setup.builders import build_model as jax_build_model
    from caiman_asr_tpu.setup.builders import build_tokenizer as jax_build_tokenizer
    from caiman_asr_tpu_torch import synthetic_e2e as se
    from caiman_asr_tpu_torch import train as port_train
    from caiman_asr_tpu_torch.args.train import train_arg_parser

    root = Path(args.workdir)
    se.prepare(root, device="cpu")
    plain = root / "plain.yaml"
    plain.write_text((root / "cfg.yaml").read_text().replace(
        "dropout: 0.1", "dropout: 0.0").replace("dither: 0.00001", "dither: 0.0"))
    cfg = jax_load_config(plain).cfg
    model, _ = jax_build_model(cfg, jax_build_tokenizer(cfg))
    params = model.init(jax.random.PRNGKey(5))
    params.update(init_simple_params(jax.random.PRNGKey(6), cfg.rnnt.joint_n_hid,
                                     model.n_classes))
    params = jax.tree.map(np.asarray, params)
    jax_save(root / "init.npz", params, params, None, {"step": 0})

    def flags(out: Path) -> list:
        a = se.train_argv(root, plain, 3000, 2e-3, 1, log_frequency=1, pruned=args.pruned)
        a[a.index("--output_dir") + 1] = str(out)
        a[a.index("--training_steps") + 1] = str(args.steps)
        a += ["--fine_tune", "--ckpt", str(root / "init.npz"), "--dont_save_at_the_end"]
        return a + ([] if args.amp else ["--no_amp"])

    jax_train.main(jax_parser().parse_args(flags(root / "jax_out")))
    port_train.main(train_arg_parser().parse_args(flags(root / "port_out")), device="cpu")

    j, t = _read_log(root / "jax_out"), _read_log(root / "port_out")
    steps = sorted(set(j) & set(t))
    rel = {s: (t[s][0] - j[s][0]) / abs(j[s][0]) for s in steps}
    what = f"{'pruned S=' + str(args.pruned) if args.pruned else 'dense'}, " \
           f"{'bf16' if args.amp else 'fp32'}"
    print(f"\n{what}: step, JAX (loss, grad norm), port (loss, grad norm), relative loss "
          "difference")
    for s in steps:
        if s <= 10 or s % 10 == 0:
            print(f"{s:5d}  {j[s][0]:.6f} {j[s][1]:.4f}  {t[s][0]:.6f} {t[s][1]:.4f}  "
                  f"{rel[s]:+.3g}")
    print(f"\n{what}: window, median |relative loss difference|, largest, mean signed")
    for lo in range(1, steps[-1] + 1, 100):
        w = np.array([rel[s] for s in steps if lo <= s < lo + 100])
        if w.size:
            print(f"steps {lo}-{lo + w.size - 1}: {np.median(np.abs(w)):.3g} "
                  f"{np.abs(w).max():.3g} {w.mean():+.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
