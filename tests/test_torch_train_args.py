"""The port's training flags (``caiman_asr_tpu_torch/args/train.py``)
against the JAX package's: every flag and default, parsed flag sets, and
``resolve_train_dataset_yaml``'s results and errors (as
``tests/test_reference_flags.py`` holds the JAX function)."""

from argparse import Namespace

import pytest

from caiman_asr_tpu.args.train import resolve_train_dataset_yaml as jax_resolve
from caiman_asr_tpu.args.train import train_arg_parser as jax_parser
from caiman_asr_tpu_torch.args.train import resolve_train_dataset_yaml, train_arg_parser


def _flags(parser):
    """{option string: (dest, default, nargs, type, choices, action class)}."""
    return {opt: (a.dest, a.default, a.nargs, a.type, a.choices, type(a).__name__)
            for a in parser._actions for opt in a.option_strings}


def test_defaults_equal_jax():
    assert vars(train_arg_parser().parse_args([])) == vars(jax_parser().parse_args([]))


def test_every_flag_equals_jax():
    assert _flags(train_arg_parser()) == _flags(jax_parser())


@pytest.mark.parametrize("argv", [
    ["--training_steps", "7", "--global_batch_size", "32", "--grad_accumulation_batches", "2",
     "--no_amp", "--resume", "--ckpt", "x.npz"],
    ["--learning_rate", "1e-3", "--min_learning_rate", "1e-5", "--fine_tune",
     "--allow_partial_checkpoint", "--hidden_hidden_bias_scaled", "0.5"],
    ["--delay_penalty", "linear_schedule", "--dp_toggle_step", "9", "--star_penalty", "0.3",
     "--eos_penalty", "0.1", "--norm_use_global_stats", "--norm_starting_ratio", "0.25"],
    ["--rsp_seq_len_freq", "1", "2", "3", "--rsp_delay", "0", "--noise_dataset", "noise",
     "--prob_background_noise", "0.5", "--noise_delay_steps", "0", "--num_buckets", "0"],
    ["--train_manifests", "a.json", "b.json", "--train_manifests_ratios", "1", "3",
     "--canary_exponent", "0.5", "--log_layer_stats", "--no_lattice_packing",
     "--max_duration", "12.5", "--decoder", "beam", "--beam_width", "8"],
])
def test_flag_sets_parse_as_in_jax(argv):
    assert vars(train_arg_parser().parse_args(argv)) == vars(jax_parser().parse_args(argv))


def _args(path, **kw):
    return Namespace(**{**dict(train_dataset_yaml=str(path), train_manifests=[],
                               train_manifest_ratios=None,
                               relative_train_manifest_ratios=None,
                               canary_manifest_exponent=None), **kw})


def test_dataset_yaml_resolves_as_in_jax(tmp_path):
    y = tmp_path / "ds.yaml"
    y.write_text("datasets:\n"
                 "  clean:\n    manifest: clean.json\n    weight: 1.0\n"
                 "  noisy:\n    manifest: noisy.json\n    weight: 2.5\n"
                 "  extra:\n    manifest: extra.json\n    note: purged\n")
    got, want = _args(y), _args(y)
    resolve_train_dataset_yaml(got)
    jax_resolve(want)
    assert vars(got) == vars(want)
    assert got.train_manifests == ["clean.json", "noisy.json", "extra.json"]
    assert got.relative_train_manifest_ratios == [1.0, 2.5, 1.0]


@pytest.mark.parametrize("text, kw, error, match", [
    ("datasets:\n  a:\n    manifest: a.json\n", dict(train_manifests=["x.json"]), SystemExit,
     None),
    ("datasets:\n  a:\n    manifest: a.json\n", dict(canary_manifest_exponent=0.5),
     SystemExit, None),
    ("datasets:\n  a:\n    weight: 1.0\n", {}, ValueError, "manifest"),
    ("datasets:\n  a:\n    manifest: a.json\n    weight: -1\n", {}, ValueError, "weight"),
    ("datasets:\n  a:\n    manifest: 3\n", {}, ValueError, "string"),
    ("other: 1\n", {}, ValueError, "datasets"),
    ("datasets: {}\n", {}, ValueError, "No valid"),
])
def test_dataset_yaml_errors_as_in_jax(tmp_path, text, kw, error, match):
    y = tmp_path / "ds.yaml"
    y.write_text(text)
    for resolve in (resolve_train_dataset_yaml, jax_resolve):
        with pytest.raises(error, match=match):
            resolve(_args(y, **kw))


def test_no_dataset_yaml_changes_nothing():
    args = _args(None, train_dataset_yaml=None, train_manifests=["m.json"])
    before = dict(vars(args))
    resolve_train_dataset_yaml(args)
    assert vars(args) == before


@pytest.mark.parametrize("max_duration", [None, 12.5])
def test_max_duration_reaches_the_train_pipeline_as_in_jax(max_duration):
    """``--max_duration`` through ``load_config`` (JAX ``train.py:124``)."""
    from caiman_asr_tpu.models.config import load_config as jax_load_config
    from caiman_asr_tpu_torch.models.config import load_config

    for path in ("configs/base-8703sp.yaml", "configs/testing-1023sp.yaml"):
        got = load_config(path, max_duration)
        want = jax_load_config(path, max_duration).cfg
        assert got.input_train.dataset.max_duration == want.input_train.dataset.max_duration
        assert got.input_val.dataset.max_duration == want.input_val.dataset.max_duration
    if max_duration is not None:
        assert got.input_train.dataset.max_duration == max_duration
