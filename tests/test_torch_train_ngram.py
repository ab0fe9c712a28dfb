"""The port's n-gram tools against the JAX package's: ``lm/train_ngram.py``
(counts, the interpolated Witten-Bell estimate, the ARPA writer, ``main``
over manifests and over ``--read_from_tar`` shards) and
``lm/sweep_scale_factor.py``, on the workspace of tests/test_torch_val.py.

- the ARPA written from the same sentences is byte-equal to JAX's, and the
  ``ngram.binary`` npz beside it loads to the same model;
- the sweep gives one WER per scale, equal to JAX's, and its scale 0.0
  equals a beam run without the LM;
- ``val.py --ngram_path`` on a kenlm binary decodes as on its ARPA, with the
  fast beam's device tables and with the host beam's scorer.
Also mirrors tests/lm/test_train_ngram.py.
"""

import io
import json
import tarfile

import numpy as np
import pytest

from caiman_asr_tpu.lm import sweep_scale_factor as jax_sweep
from caiman_asr_tpu.lm import train_ngram as jtn
from caiman_asr_tpu.lm.ngram import NGramLM as JaxNGramLM
from caiman_asr_tpu_torch.lm import sweep_scale_factor, train_ngram
from caiman_asr_tpu_torch.lm.kenlm_binary import write_kenlm_binary
from caiman_asr_tpu_torch.lm.ngram import NGramLM
from caiman_asr_tpu_torch.val import val_arg_parser, validate
from tests.lm.test_train_ngram import CORPUS
from tests.test_torch_val import workspace  # noqa: F401


def _random_sentences(seed, n=200):
    rng = np.random.default_rng(seed)
    words = [f"▁p{i}" for i in range(20)] + ["x", "y", "'"]
    return [[words[j] for j in rng.integers(0, len(words), rng.integers(1, 12))]
            for _ in range(n)]


@pytest.mark.parametrize("order", [2, 3, 4])
def test_counts_and_estimates_equal_jax(order):
    sents = _random_sentences(order)
    counts, jcounts = train_ngram.count_ngrams(sents, order), jtn.count_ngrams(sents, order)
    assert counts == jcounts
    assert train_ngram.witten_bell(counts, order) == jtn.witten_bell(jcounts, order)


@pytest.mark.parametrize("sentences", ["corpus", "random"])
def test_arpa_byte_equal(sentences, tmp_path):
    sents = CORPUS if sentences == "corpus" else _random_sentences(9)
    got = train_ngram.train_ngram_from_sentences(sents, 3, tmp_path / "port")
    want = jtn.train_ngram_from_sentences(sents, 3, tmp_path / "jax")
    assert got.read_bytes() == want.read_bytes()
    a, b = NGramLM.load(tmp_path / "port" / "ngram.binary"), JaxNGramLM.load(
        tmp_path / "jax" / "ngram.binary")
    assert a.probs == b.probs and a.backoffs == b.backoffs and a.order == b.order


def test_counts():
    counts = train_ngram.count_ngrams([["a", "b"]], 2)
    assert counts[1][("a",)] == 1 and counts[2][("<s>", "a")] == 1
    assert counts[2][("b", "</s>")] == 1


def test_arpa_ranking(tmp_path):
    lm = NGramLM.load(train_ngram.train_ngram_from_sentences(CORPUS, 3, tmp_path))
    assert lm.score("cat", ("the",))[0] > lm.score("rug", ("the",))[0]


def _write_tar(root, name, texts):
    with tarfile.open(root / name, "w") as tf:
        for i, text in enumerate(texts):
            for suffix, data in ((".txt", text.encode()), (".flac", b"\0" * 16)):
                info = tarfile.TarInfo(f"utt{i:03d}{suffix}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_main_over_manifests_and_tar_equals_jax(workspace, tmp_path):  # noqa: F811
    root, _ = workspace
    texts = [e["transcript"] for e in json.loads((root / "manifest.json").read_text())]
    _write_tar(tmp_path, "shard0.tar", texts[:5])
    _write_tar(tmp_path, "shard1.tar", texts[5:])
    tok = str(root / "tok.json")
    for name, flags in (("manifests", ["--manifests", "manifest.json", "--dataset_dir",
                                        str(root)]),
                        ("tar", ["--read_from_tar", "--tar_files", "shard0.tar", "shard1.tar",
                                 "--dataset_dir", str(tmp_path)])):
        argv = flags + ["--tokenizer_model", tok, "--order", "3"]
        train_ngram.main(argv + ["--output_dir", str(tmp_path / name / "port")])
        jtn.main(argv + ["--output_dir", str(tmp_path / name / "jax")])
        got = (tmp_path / name / "port" / "ngram.arpa").read_bytes()
        assert got == (tmp_path / name / "jax" / "ngram.arpa").read_bytes()
    assert ((tmp_path / "tar" / "port" / "ngram.arpa").read_bytes()
            == (tmp_path / "manifests" / "port" / "ngram.arpa").read_bytes())
    with pytest.raises(SystemExit):
        train_ngram.main(["--tokenizer_model", tok, "--output_dir", str(tmp_path / "none")])


@pytest.fixture(scope="module")
def lm_files(workspace):  # noqa: F811
    root, _ = workspace
    out = root / "sweep_ngram"
    train_ngram.main(["--manifests", "manifest.json", "--dataset_dir", str(root),
                      "--tokenizer_model", str(root / "tok.json"), "--order", "3",
                      "--output_dir", str(out)])
    write_kenlm_binary(NGramLM.load(out / "ngram.arpa"), out / "kenlm.binary")
    return out / "ngram.arpa", out / "kenlm.binary"


def _base(workspace, out):  # noqa: F811
    root, configs = workspace
    return ["--model_config", str(configs["mini"]), "--ckpt", str(root / "ckpt.npz"),
            "--dataset_dir", str(root), "--val_manifests", "manifest.json",
            "--beam_width", "3", "--output_dir", str(out)]


def test_sweep_equals_jax(workspace, lm_files, tmp_path):  # noqa: F811
    arpa, _ = lm_files
    argv = _base(workspace, tmp_path / "sweep") + ["--ngram_path", str(arpa),
                                                   "--scales", "0.0", "0.8"]
    got = sweep_scale_factor.main(argv + ["--cpu"])
    want = jax_sweep.main(argv)
    assert [r["scale"] for r in got] == [0.0, 0.8]
    assert [r["wer"] for r in got] == [r["wer"] for r in want]
    no_lm = validate(val_arg_parser().parse_args(
        _base(workspace, tmp_path / "no_lm") + ["--decoder", "beam", "--cpu"]))
    assert got[0]["wer"] == no_lm.wer


@pytest.mark.parametrize("decoder", ["fast_beam", "beam"])
def test_val_with_a_kenlm_binary_equals_its_arpa(workspace, lm_files, decoder,  # noqa: F811
                                                 tmp_path):
    results = []
    for path in lm_files:
        args = val_arg_parser().parse_args(
            _base(workspace, tmp_path / path.suffix[1:]) + [
                "--decoder", decoder, "--ngram_path", str(path), "--ngram_scale_factor", "0.8",
                "--cpu"])
        results.append(validate(args))
    assert results[0].hyps == results[1].hyps and results[0].wer == results[1].wer
    assert any(results[0].hyps)


def test_compare_decoders_equals_jax(workspace, tmp_path):  # noqa: F811
    """synthetic_e2e's decoder table on a workdir laid out as ``run`` leaves
    it (the workspace's model as the best checkpoint): each WER equal to
    JAX's val.validate under the JAX script's argv (scripts/synthetic_e2e.py:
    195-225), with the 3-gram the JAX trainer writes from the same
    transcripts."""
    import shutil

    from caiman_asr_tpu.val import val_arg_parser as jax_val_arg_parser
    from caiman_asr_tpu.val import validate as jax_validate
    from caiman_asr_tpu_torch import synthetic_e2e
    from caiman_asr_tpu_torch.data.generate_mel_stats import main as mel_main

    root, configs = workspace
    work = tmp_path / "e2e"
    (work / "out" / "ckpts").mkdir(parents=True)
    for src, dst in ((root / "manifest.json", "train.json"), (root / "manifest.json", "dev.json"),
                     (configs["mini"], "cfg.yaml"), (root / "tok.json", "tok.json"),
                     (root / "ckpt.npz", "out/ckpts/best.npz")):
        shutil.copy(src, work / dst)
    for f in root.glob("utt*.wav"):
        shutil.copy(f, work / f.name)
    mel_main(["--model_config", str(work / "cfg.yaml"), "--dataset_dir", str(work),
              "--manifests", "train.json", "--output_path", str(work / "mel_stats.npz")],
             device="cpu")
    got = synthetic_e2e.compare_decoders(work, device="cpu")
    assert list(got["wer"]) == [name for name, _ in synthetic_e2e.COMPARE]
    jtn.main(["--manifests", "train.json", "--dataset_dir", str(work), "--tokenizer_model",
              str(work / "tok.json"), "--order", "3", "--output_dir", str(tmp_path / "jax_lm")])
    assert ((tmp_path / "jax_lm" / "ngram.arpa").read_bytes()
            == (work / "ngram" / "ngram.arpa").read_bytes())
    for name, extra in synthetic_e2e.COMPARE:
        va = jax_val_arg_parser().parse_args([
            "--model_config", str(work / "cfg.yaml"), "--dataset_dir", str(work),
            "--val_manifests", "dev.json", "--output_dir", str(tmp_path / f"jax_{name}"),
            "--ckpt", str(work / "out" / "ckpts" / "best.npz"),
            "--mel_stats_path", str(work / "mel_stats.npz"),
        ] + [a.format(lm=str(tmp_path / "jax_lm" / "ngram.arpa")) for a in extra])
        assert got["wer"][name] == jax_validate(va).wer, name
    # --pruned S trains on the pruned loss, as the JAX script's flag does
    argv = synthetic_e2e.train_argv(work, work / "cfg.yaml", 100, 2e-3, 1, pruned=4)
    assert argv[argv.index("--pruned_loss_range") + 1] == "4"
    assert "--pruned_loss_range" not in synthetic_e2e.train_argv(work, work / "cfg.yaml", 100,
                                                                 2e-3, 1)
