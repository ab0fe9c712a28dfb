"""The training lifecycle over two processes: the port-side counterpart of
``__graft_entry__.py:273-396`` (``_dryrun_lifecycle``).

Two gloo ranks on the CPU run ``train.main --multihost`` at that check's
widths (16 input features, an encoder of 1 + 2 layers of 32 with stack-time
2, a 2-layer predictor of 16, a joint of 32; the workspace tokenizer's 49
classes where it has 64) with A=2, random state passing whose gates fire
from step 2 (``--rsp_seq_len_freq 1 1 --rsp_delay 2``) and gradient noise
from step 1, its first allowed step. One run takes 6 steps uninterrupted.
The other takes 3, then rank 0 receives SIGTERM: both ranks finish step 3 and save
``last`` through the trainer's preemption path, and the processes exit
(teardown); a new launch resumes it with ``--resume`` and takes 3 more.
Steps 4-6 must equal the uninterrupted run's in loss and gradient norm to
the bit, and both runs end in the same parameters, EMA and moments.

The two-rank tests beside it resume a run by ``--resume`` alone
(tests/test_torch_train_multihost.py::test_two_rank_resume_is_bit_exact)
and stop one on SIGTERM without resuming it
(``test_sigterm_to_one_rank_stops_both_after_the_same_step``); this one
joins the two, through the signal.
"""

import json
import os
import subprocess
import sys

import numpy as np

from tests.test_torch_train_cli import (  # noqa: F401 (fixtures)
    MINI_CONFIG, REPO, augmented_args, read_log, workspace,
)
from tests.test_torch_train_multihost import assert_ranks_bit_equal

RANK_TIMEOUT = 300
STOP = 3
STEPS = 6

# a rank: train.main with its --host_id; with "_sigterm_after", rank 0 sends
# itself SIGTERM once that many steps are done
RANK_PROG = """
import json, os, signal, sys
from argparse import Namespace
class _NoJax:  # neither JAX nor the JAX package imports in a rank
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "caiman_asr_tpu"):
            raise ImportError(f"{{name}} in a rank")
sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, {repo!r})
import numpy as np
import caiman_asr_tpu_torch.training.step as step_mod
from caiman_asr_tpu_torch import train
from caiman_asr_tpu_torch.training.tree import tree_items
spec, rank = json.loads(open(sys.argv[1]).read()), int(sys.argv[2])
state_out = spec.pop("_state_out")
stop = spec.pop("_sigterm_after")
if stop and rank == 0:
    make = step_mod.make_train_step
    def counted(*a, **k):
        fn, calls = make(*a, **k), [0]
        def step(*aa, **kk):
            out = fn(*aa, **kk)
            calls[0] += 1
            if calls[0] == stop:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return step
    step_mod.make_train_step = counted
state, best = train.main(Namespace(**spec, host_id=rank), device="cpu")
leaves = {{}}
for name, tree in (("params", state.params), ("ema", state.ema_params),
                   ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
    leaves.update({{name + "/" + "/".join(p): t.detach().numpy() for p, t in tree_items(tree)}})
np.savez(state_out + f"{{rank}}.npz", **leaves)
print("RANK_DONE", rank, state.step, flush=True)
"""


def lifecycle_config(root):
    """``__graft_entry__.py:300-307``'s widths on the workspace's audio:
    16 mel bins, no stacking (16 input features), dropout off, gradient
    noise from step 1 (its first allowed step)."""
    text = MINI_CONFIG.format(tok=root / "tok.json", sampling=0.0, dither=0.0, dropout=0.0,
                              train_extra="")
    for old, new in (("frame_stacking: 3", "frame_stacking: 1"),
                     ("frame_subsampling: 3", "frame_subsampling: 1"),
                     ("in_feats: 48", "in_feats: 16"), ("enc_n_hid: 16", "enc_n_hid: 32"),
                     ("enc_post_rnn_layers: 1", "enc_post_rnn_layers: 2"),
                     ("pred_rnn_layers: 1", "pred_rnn_layers: 2"),
                     ("joint_n_hid: 16", "joint_n_hid: 32"),
                     ("noise_level: 0.0", "noise_level: 0.02\n  decay_const: 0.55\n"
                                          "  start_step: 1")):
        assert old in text, old
        text = text.replace(old, new)
    path = root / "lifecycle.yaml"
    path.write_text(text)
    return path


def start_ranks(args, tmp_path, name, sigterm_after=0):
    """Launch the two ranks of one run; returns the processes."""
    spec = dict(vars(args), multihost=True, num_hosts=2,
                coordinator_address=f"file://{tmp_path / (name + '_store')}",
                _state_out=str(tmp_path / f"{name}_state"), _sigterm_after=sigterm_after)
    spec.pop("host_id", None)
    spec_path = tmp_path / f"{name}.json"
    spec_path.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    # one intra-op thread a rank: two runs are held equal to the bit, and
    # with two, the first multithreaded call of a CPU kernel in a process
    # can sum part of its output in another order under load (a race in
    # the library's first call, not in the port)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    prog = RANK_PROG.format(repo=str(REPO))
    return [subprocess.Popen([sys.executable, "-u", "-c", prog, str(spec_path), str(r)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=REPO, env=env)
            for r in range(2)]


def finish_ranks(procs, tmp_path, name):
    """Wait for a run's ranks; returns their logs and final states."""
    logs = []
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    states = []
    for r in range(2):
        with np.load(tmp_path / f"{name}_state{r}.npz") as z:
            states.append({k: z[k] for k in z.files})
    return logs, states


def test_preempt_teardown_resume_bit_matches_the_uninterrupted_run(workspace,  # noqa: F811
                                                                     tmp_path):
    cfg = lifecycle_config(workspace)
    kw = dict(model_config=str(cfg), global_batch_size=4, grad_accumulation_batches=2,
              training_steps=STEPS, rsp_seq_len_freq=[1, 1], rsp_delay=2, no_amp=True,
              noise_dataset=None, prob_background_noise=0.0, val_frequency=1000,
              save_frequency=1000, prediction_frequency=1000)
    ctl, intr = tmp_path / "ctl", tmp_path / "intr"
    # the uninterrupted run and the interrupted one's first launch side by side
    ctl_procs = start_ranks(augmented_args(workspace, ctl, **kw), tmp_path, "ctl")
    first_procs = start_ranks(augmented_args(workspace, intr, **kw), tmp_path, "first",
                              sigterm_after=STOP)
    logs, _ = finish_ranks(first_procs, tmp_path, "first")
    _, want_states = finish_ranks(ctl_procs, tmp_path, "ctl")
    assert "signal" in logs[0] and "signal" not in logs[1]
    for r, log in enumerate(logs):
        assert f"preempted at step {STOP}; saving last checkpoint" in log, log[-2000:]
        assert f"RANK_DONE {r} {STOP}" in log
    logs, got_states = finish_ranks(start_ranks(augmented_args(workspace, intr, resume=True,
                                                               **kw), tmp_path, "resumed"),
                                    tmp_path, "resumed")
    assert all("Restored carried RSP state" in log for log in logs)
    want, _ = read_log(ctl)
    got, _ = read_log(intr)
    assert sorted(want) == list(range(1, STEPS + 1))
    assert sorted(got) == list(range(1, STEPS + 1))
    for s in range(1, STEPS + 1):
        assert got[s] == want[s], (s, got[s], want[s])
        assert np.isfinite(want[s]).all()
    assert_ranks_bit_equal(got_states)
    for r in range(2):
        assert got_states[r].keys() == want_states[r].keys()
        unequal = [k for k in want_states[r]
                   if not np.array_equal(want_states[r][k], got_states[r][k])]
        assert not unequal, (r, unequal[:8])
