"""The port's training CLI over two processes (``train.main`` with
``--multihost``, gloo on the CPU) against the JAX package's ``train.main``
in one process on the same global batches, and the two-rank run's own
resume and preemption.

The workspace, the parity settings and the tolerances are
``tests/test_torch_train_cli.py``'s: fp32, nothing random, fine-tuning
from one JAX-initialised checkpoint, RSP and the packed joint on, A=2, 4
steps, validation and checkpoints every 2. Each rank takes microbatches
of 2 (``--global_batch_size 4`` a process), JAX one of 4: the sampler's
global batches are the same and rank r takes ``batch[r::2]`` of each.
Held: each step's loss rtol 1e-5 and gradient norm rtol 1e-4 against
JAX's; the step-N parameters, EMA and moments atol 2e-6 / rtol 1e-4; the
dev loss rtol 1e-5; the dev WER and each file's hypothesis identical; the
two ranks' final states equal to the bit. JAX and the one-process port
resume the two-rank checkpoint; the two-rank 2 + 2 resumed run equals the
4-step two-rank run to the bit (with the run's randomness on); a SIGTERM to
one rank stops both after the same step.

Ranks are subprocesses joined through a ``file://`` store and import no
JAX.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from caiman_asr_tpu.args.train import train_arg_parser as jax_train_arg_parser
from caiman_asr_tpu.export.checkpointer import load_checkpoint as jax_load_checkpoint
from caiman_asr_tpu_torch.args.train import train_arg_parser
from caiman_asr_tpu_torch.export.checkpointer import flatten_named, load_checkpoint
from tests.test_torch_train_cli import (  # noqa: F401 (fixtures)
    REPO, VAL_LOSS_RTOL, _jax_main, _port_main, assert_checkpoints_close,
    assert_steps_close, augmented_args, packing, parity_args, read_log, workspace,
)

RANK_TIMEOUT = 240

# a rank: train.main on the spec's flags with its own --host_id, then its
# final state written beside the run for the bit-equality check
RANK_PROG = """
import json, sys
from argparse import Namespace
class _NoJax:  # neither JAX nor the JAX package imports in a rank
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "caiman_asr_tpu"):
            raise ImportError(f"{{name}} in a rank")
sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, {repo!r})
import numpy as np
import caiman_asr_tpu_torch.training.pack as pack
from caiman_asr_tpu_torch import train
from caiman_asr_tpu_torch.training.tree import tree_items
spec, rank = json.loads(open(sys.argv[1]).read()), int(sys.argv[2])
pack.PACK_QUANTUM = spec.pop("_pack_quantum")
state_out = spec.pop("_state_out")
state, best = train.main(Namespace(**spec, host_id=rank), device="cpu")
leaves = {{}}
for name, tree in (("params", state.params), ("ema", state.ema_params),
                   ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
    leaves.update({{name + "/" + "/".join(p): t.detach().numpy() for p, t in tree_items(tree)}})
np.savez(state_out + f"{{rank}}.npz", **leaves)
print("RANK_DONE", rank, state.step, flush=True)
"""


def start_ranks(args, tmp_path, world: int = 2, name: str = "ranks"):
    """Launch ``world`` ranks of train.main on ``args`` (a Namespace, the
    multihost flags added); returns the processes and the state prefix."""
    spec = dict(vars(args), multihost=True, num_hosts=world,
                coordinator_address=f"file://{tmp_path / (name + '_store')}",
                _pack_quantum=16, _state_out=str(tmp_path / f"{name}_state"))
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
    procs = [subprocess.Popen([sys.executable, "-u", "-c", prog, str(spec_path), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=env)
             for r in range(world)]
    return procs, tmp_path / f"{name}_state"


def finish_ranks(procs, prefix):
    """Wait for launched ranks; returns (their outputs, each rank's final
    state {name: array})."""
    logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    states = []
    for r in range(len(procs)):
        with np.load(f"{prefix}{r}.npz") as z:
            states.append({k: z[k] for k in z.files})
    return logs, states


def run_ranks(args, tmp_path, world: int = 2, name: str = "ranks"):
    return finish_ranks(*start_ranks(args, tmp_path, world, name))


def assert_ranks_bit_equal(states):
    for other in states[1:]:
        assert other.keys() == states[0].keys()
        unequal = [k for k in states[0] if not np.array_equal(states[0][k], other[k])]
        assert not unequal, unequal[:8]


def two_rank_args(root, out, **kw):
    """The parity settings for a rank: microbatches of 2 (4 over A=2)."""
    return parity_args(train_arg_parser, root, out, **{**dict(global_batch_size=4,
                                                              dump_preds=True), **kw})


def one_process_args(parser, root, out, **kw):
    """The same global batches in one process: microbatches of 4."""
    return parity_args(parser, root, out, **{**dict(global_batch_size=8, val_batch_size=8,
                                                    dump_preds=True), **kw})


@pytest.fixture(scope="module")
def parity_runs(workspace, packing, tmp_path_factory):
    """The two ranks, and JAX in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("two_rank")
    out, jax_out = tmp / "out", tmp_path_factory.mktemp("jax_out8")
    ranks = start_ranks(two_rank_args(workspace, out), tmp)
    _jax_main(one_process_args(jax_train_arg_parser, workspace, jax_out))
    logs, states = finish_ranks(*ranks)
    return out, logs, states, jax_out


@pytest.fixture(scope="module")
def two_rank_run(parity_runs):
    return parity_runs[:3]


@pytest.fixture(scope="module")
def jax_run8(parity_runs):
    return parity_runs[3]


def preds(out, step):
    """{file: hypothesis} and the WER of a run's predictions at ``step``."""
    p = json.loads((out / "preds" / f"preds_step{step}.json").read_text())
    return {x["fname"]: x["hyp"] for x in p["predictions"]}, p["wer"]


def test_two_ranks_match_jax_in_one_process(two_rank_run, jax_run8):
    out, logs, _ = two_rank_run
    got, got_dev = read_log(out)
    want, want_dev = read_log(jax_run8)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    assert_steps_close(got, want, [1, 2, 3, 4])
    for name in ("step2.npz", "step4.npz", "last.npz", "best.npz"):
        assert_checkpoints_close(out / "ckpts" / name, jax_run8 / "ckpts" / name)
    assert "backend gloo (the CPU)" in logs[0] and "rank 1 of 2" in logs[1]


def test_the_checkpoint_holds_every_ranks_streams(two_rank_run, jax_run8):
    """Rank 0 alone writes: one log, one set of checkpoints; their meta is
    JAX's with each rank's host random streams beside it."""
    out, _, _ = two_rank_run
    assert len(list(out.glob("log_*.jsonl"))) == 1
    assert len(list(out.glob("training_args_*.json"))) == 1
    _, _, _, got_meta = load_checkpoint(out / "ckpts" / "last.npz")
    _, _, _, want_meta = jax_load_checkpoint(jax_run8 / "ckpts" / "last.npz")
    streams = got_meta.pop("_host_rng")
    assert len(streams) == 2 and all(isinstance(s, list) and s for s in streams)
    assert streams[0] != streams[1]  # each rank's own, seeded (seed, rank)
    assert got_meta.keys() == want_meta.keys()
    np.testing.assert_allclose(got_meta.pop("best_wer"), want_meta.pop("best_wer"), rtol=1e-12)
    assert got_meta == want_meta


def test_the_ranks_end_equal_to_the_bit(two_rank_run):
    _, _, states = two_rank_run
    assert len(states[0]) > 4
    assert_ranks_bit_equal(states)


def test_dev_loss_wer_and_hypotheses_match_jax(two_rank_run, jax_run8):
    """Each rank decodes its shard of the dev set; the result gathered is
    JAX's over the whole set."""
    out, _, _ = two_rank_run
    _, got_dev = read_log(out)
    _, want_dev = read_log(jax_run8)
    assert sorted(got_dev) == sorted(want_dev) == [2, 4]
    for s in got_dev:
        np.testing.assert_allclose(got_dev[s], want_dev[s], rtol=VAL_LOSS_RTOL)
        (got_h, got_wer), (want_h, want_wer) = preds(out, s), preds(jax_run8, s)
        assert len(got_h) == 8 and got_h == want_h
        assert got_wer == want_wer


def test_jax_resumes_the_two_rank_checkpoint(two_rank_run, workspace, packing, tmp_path):
    """JAX in one process from the two-rank step-2 checkpoint (its carried
    RSP state in the global batch's row order) takes steps 3 and 4 as the
    two ranks did."""
    out, _, _ = two_rank_run
    _jax_main(one_process_args(jax_train_arg_parser, workspace, tmp_path, fine_tune=False,
                               resume=True, ckpt=str(out / "ckpts" / "step2.npz")))
    got, _ = read_log(tmp_path)
    want, _ = read_log(out)
    assert sorted(got) == [3, 4]
    assert_steps_close(got, want, [3, 4])


def test_the_one_process_port_resumes_the_two_rank_checkpoint(two_rank_run, workspace,
                                                              packing, tmp_path, capsys):
    out, _, _ = two_rank_run
    _port_main(one_process_args(train_arg_parser, workspace, tmp_path, fine_tune=False,
                                resume=True, ckpt=str(out / "ckpts" / "step2.npz")))
    got, _ = read_log(tmp_path)
    want, _ = read_log(out)
    assert sorted(got) == [3, 4]
    assert_steps_close(got, want, [3, 4])
    printed = capsys.readouterr().out
    assert "Restored carried RSP state" in printed
    assert "saved by 2 process(es), 1 now" in printed
    assert_checkpoints_close(tmp_path / "ckpts" / "last.npz", out / "ckpts" / "last.npz")


def test_two_rank_resume_is_bit_exact(workspace, tmp_path):
    """With dropout, SpecAugment, dither, speed perturbation, background
    noise and subword sampling on (bf16): 4 steps against 2, then
    ``--resume`` to 4, both over two ranks; each rank restores its own host
    streams and carried rows."""
    kw = dict(global_batch_size=4, training_steps=4)
    a, b = tmp_path / "ctl", tmp_path / "intr"
    ctl = start_ranks(augmented_args(workspace, a, **kw), tmp_path, name="ctl")
    first = start_ranks(augmented_args(workspace, b, **dict(kw, training_steps=2)), tmp_path,
                        name="first")
    _, want_states = finish_ranks(*ctl)
    finish_ranks(*first)
    logs, got_states = run_ranks(augmented_args(workspace, b, resume=True, **kw), tmp_path,
                                 name="resumed")
    assert "Restored carried RSP state" in logs[1]
    want, _ = read_log(a)
    got, _ = read_log(b)
    assert sorted(want) == [1, 2, 3, 4]
    for s in (3, 4):
        assert got[s] == want[s], (s, got[s], want[s])
    for r in range(2):
        assert got_states[r].keys() == want_states[r].keys()
        unequal = [k for k in want_states[r]
                   if not np.array_equal(want_states[r][k], got_states[r][k])]
        assert not unequal, (r, unequal[:8])
    ca, cb = (flatten_named(load_checkpoint(o / "ckpts" / "last.npz")[1]) for o in (a, b))
    assert all(np.array_equal(ca[k], cb[k]) for k in ca)


def test_sigterm_to_one_rank_stops_both_after_the_same_step(workspace, tmp_path):
    """SIGTERM to rank 1 alone: both ranks finish the same step, rank 0
    saves ``last`` there, both exit 0."""
    out = tmp_path / "out"
    args = augmented_args(workspace, out, global_batch_size=4, training_steps=500,
                          val_frequency=1000, save_frequency=1000)
    procs, _ = start_ranks(args, tmp_path)
    lines, deadline = [], time.time() + 120
    while time.time() < deadline:
        line = procs[0].stdout.readline()
        if not line:
            break
        lines.append(line)
        if "[train] step" in line:
            procs[1].send_signal(signal.SIGTERM)
            break
    assert lines and "[train] step" in lines[-1], "".join(lines[-20:])
    tails = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [t[-2000:] for t in tails]
    assert "signal" in tails[1] and "signal" not in tails[0]
    stopped = [int(t.split("preempted at step ")[1].split(";")[0]) for t in tails]
    _, _, _, meta = load_checkpoint(out / "ckpts" / "last.npz")
    assert stopped[0] == stopped[1] == int(meta["step"])
    assert 0 < stopped[0] < 500
    assert [f"RANK_DONE {r} {stopped[0]}" in t for r, t in enumerate(tails)] == [True, True]
