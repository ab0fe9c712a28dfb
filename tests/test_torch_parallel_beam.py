"""The port's beam over worker processes (caiman_asr_tpu_torch/decoding/
parallel.py through ``val.py --beam_parallel_procs``) against the JAX
package's (caiman_asr_tpu/decoding/parallel.py, caiman_asr_tpu/val.py), on
the workspace of tests/test_torch_val.py, two workers each.

- ``val.validate --decoder beam --beam_parallel_procs 2`` gives JAX's
  hypotheses and WER under the same flags, and the port's one-process host
  beam's under the kwargs that JAX forwards;
- the reference's two traits are pinned: the temperature 1.0 becomes 1.4,
  and no n-gram (nor keywords) reaches the workers, even with
  ``--ngram_path``;
- each worker starts with the cards hidden, runs on the CPU, never
  initialises CUDA, and takes its share of the host's threads; the pool is
  closed when validation ends.

The two packages validate once for the module (the worker pools' start-up
is most of a test's time); the port's workers are read just before its
pool closes.
"""

import os
from unittest import mock

import pytest

from caiman_asr_tpu_torch.decoding.parallel import ParallelDecoder
from caiman_asr_tpu_torch.val import parallel_decoder_kwargs, val_arg_parser, validate
from tests.test_torch_val import check_same, run_both, workspace  # noqa: F401

PAR = ["--decoder", "beam", "--beam_width", "3", "--beam_parallel_procs", "2",
       "--beam_min_decode_batch_size_per_proc", "1"]


@pytest.fixture(scope="module")
def arpa(workspace):  # noqa: F811
    """A 3-gram over the workspace's transcripts, from the port's trainer."""
    from caiman_asr_tpu_torch.lm.train_ngram import main as ngram_main

    root, _ = workspace
    ngram_main(["--manifests", "manifest.json", "--dataset_dir", str(root),
                "--tokenizer_model", str(root / "tok.json"), "--order", "3",
                "--output_dir", str(root / "ngram")])
    return root / "ngram" / "ngram.arpa"


@pytest.fixture(scope="module")
def parallel_run(workspace, arpa, tmp_path_factory):  # noqa: F811
    """Both packages' ``validate`` with --beam_parallel_procs 2 and an
    --ngram_path; with the port's ParallelDecoder and its workers' states,
    read as validation closes it."""
    seen = []
    close = ParallelDecoder.close

    def read_then_close(self):
        if not seen:
            seen.append((self, self.worker_states()))
        close(self)

    tmp = tmp_path_factory.mktemp("parallel")
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    with mock.patch.object(ParallelDecoder, "close", read_then_close):
        out = run_both(workspace, tmp, PAR + ["--ngram_path", str(arpa),
                                              "--ngram_scale_factor", "0.5"])
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == env  # the parent's own is kept
    return out, seen, tmp


def test_parallel_beam_matches_jax_and_one_process(workspace, parallel_run):  # noqa: F811
    """With --ngram_path too: the workers drop it, in both packages."""
    root, configs = workspace
    out, _, tmp_path = parallel_run
    got = check_same(out)
    assert any(got.hyps)
    one = validate(val_arg_parser().parse_args([
        "--model_config", str(configs["mini"]), "--ckpt", str(root / "ckpt.npz"),
        "--dataset_dir", str(root), "--val_manifests", "manifest.json", "--cpu",
        "--decoder", "beam", "--beam_width", "3", "--output_dir", str(tmp_path / "one")]))
    assert one.hyps == got.hyps and one.wer == got.wer


def _args(*flags):
    return val_arg_parser().parse_args(["--decoder", "beam", *flags])


def test_worker_kwargs_are_the_references():
    """JAX's val.py:142-150: width, thresholds and temperature (1.0 -> 1.4)."""
    kw = parallel_decoder_kwargs(_args("--beam_width", "5", "--ngram_path", "x.arpa",
                                       "--keyword_boost_path", "k.txt"))
    assert kw == dict(beam_width=5, temperature=1.4, beam_prune_score_thresh=0.4,
                      beam_prune_topk_thresh=1.5)
    assert parallel_decoder_kwargs(_args("--temperature", "2.0"))["temperature"] == 2.0
    assert parallel_decoder_kwargs(_args("--temperature", "1.0"))["temperature"] == 1.4


def test_workers_run_on_the_cpu_and_close(parallel_run):
    import torch

    _, seen, _ = parallel_run
    assert len(seen) == 1
    dec, states = seen[0]
    assert dec.nprocs == 2 and len({s["pid"] for s in states}) <= 2
    for s in states:
        assert s["cuda_visible_devices"] == ""
        assert s["device"] == "cpu" and not s["cuda_initialized"]
        assert s["temperature"] == 1.4 and not s["ngram_lm"] and not s["keywords"]
        assert s["threads"] == max(1, (os.cpu_count() or 1) // 2)
    assert not torch.cuda.is_initialized()
    with pytest.raises(RuntimeError):  # the pool is shut down
        dec.worker_states()
