"""The port's tokenizer (``data/tokenizer.py``) against the JAX package's: a
SentencePiece model written by the JAX package loads to the same pieces,
from a file or from its bytes, and ``tokenize``, ``detokenize`` and
``id_to_piece`` agree, with and without sampling; the trainer gives the same
piece table, and the ``.model`` and JSON writers the same bytes, as do the
``spm_train`` CLIs."""

import json

import numpy as np
import pytest

from caiman_asr_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from caiman_asr_tpu.data.tokenizer import save_sentencepiece_model, train_tokenizer
from caiman_asr_tpu_torch.data.tokenizer import (
    Tokenizer,
    load_sentencepiece_model,
    parse_sentencepiece_model,
)

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "streaming speech recognition on a graphics card",
    "a recurrent neural network transducer emits tokens frame by frame",
    "the lazy dog sleeps while the quick fox runs",
    "über naïve café résumé",
] * 3
SENTENCES = ["the quick dog", "recognition of speech", "zebra xylophone", "café fox", ""]


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("spm") / "tok.model"
    save_sentencepiece_model(path, train_tokenizer(CORPUS, vocab_size=60))
    return path


def test_pieces_load_the_same(model_file):
    from caiman_asr_tpu.data.tokenizer import load_sentencepiece_model as jax_load

    want = jax_load(model_file)
    assert load_sentencepiece_model(model_file) == want
    assert parse_sentencepiece_model(model_file.read_bytes()) == want
    assert len(want) == 60


@pytest.mark.parametrize("source", ["file", "bytes", "json"])
def test_tokenizer_agrees(model_file, tmp_path, source):
    want = JaxTokenizer(["a"], model_file)
    if source == "file":
        got = Tokenizer(["a"], model_file)
    elif source == "bytes":
        got = Tokenizer(["a"], model_file.read_bytes())
    else:
        path = tmp_path / "tok.json"
        path.write_text(json.dumps({"pieces": load_sentencepiece_model(model_file)}))
        got = Tokenizer(["a"], path)
    assert got.num_labels == want.num_labels
    assert [got.id_to_piece(i) for i in range(got.num_labels)] == [
        want.id_to_piece(i) for i in range(want.num_labels)]
    for s in SENTENCES:
        ids = got.tokenize(s)
        assert ids == want.tokenize(s)
        assert got.detokenize(ids) == want.detokenize(ids)
    assert got.detokenize(3) == want.detokenize(3)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, got.num_labels, size=40).tolist()
    assert got.detokenize(ids) == want.detokenize(ids)


def test_sampling_agrees(model_file):
    got = Tokenizer(["a"], model_file, sampling=0.5, seed=3)
    want = JaxTokenizer(["a"], model_file, sampling=0.5, seed=3)
    for s in SENTENCES * 4:
        assert got.tokenize(s) == want.tokenize(s)


TRAIN_CORPORA = {
    "sentences": CORPUS,
    "repeats": ["alpha bravo charlie", "delta echo", "alpha alpha delta", "kilo lima"] * 5,
    "characters": ["a b c ab abc", "ba cab"] * 4,
}


@pytest.mark.parametrize("corpus", sorted(TRAIN_CORPORA))
@pytest.mark.parametrize("vocab_size, user_symbols", [(20, ()), (64, ("<EOS>",)), (200, ())])
def test_trainer_and_writers_match_jax(corpus, vocab_size, user_symbols, tmp_path):
    from caiman_asr_tpu.data import tokenizer as jax_tok
    from caiman_asr_tpu_torch.data import tokenizer as tok

    texts = TRAIN_CORPORA[corpus]
    got = tok.train_tokenizer(texts, vocab_size=vocab_size, user_symbols=user_symbols)
    want = jax_tok.train_tokenizer(texts, vocab_size=vocab_size, user_symbols=user_symbols)
    assert got == want
    for name, mod in (("port", tok), ("jax", jax_tok)):
        mod.save_sentencepiece_model(tmp_path / f"{name}.model", got)
        mod.save_tokenizer_json(tmp_path / f"{name}.json", got)
    for ext in ("model", "json"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()


def test_spm_train_writes_what_jax_writes(tmp_path):
    from caiman_asr_tpu.data.spm_train import main as jax_main
    from caiman_asr_tpu_torch.data.spm_train import main

    entries = [{"transcript": t.upper() + "!", "files": [{"fname": f"u{i}.wav",
                                                         "duration": 1.0}],
                "original_duration": 1.0} for i, t in enumerate(CORPUS)]
    (tmp_path / "m.json").write_text(json.dumps(entries))
    for name, fn in (("port", main), ("jax", jax_main)):
        fn(["--manifests", "m.json", "--dataset_dir", str(tmp_path), "--vocab_size", "40",
            "--output_prefix", str(tmp_path / name)])
    for ext in ("model", "json"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    # the webdataset source reads shards now (tests/test_torch_data_tools.py);
    # a missing shard raises in both packages
    for fn in (main, jax_main):
        with pytest.raises(FileNotFoundError):
            fn(["--read_from_tar", "--tar_files", "x.tar", "--dataset_dir", str(tmp_path),
                "--output_prefix", str(tmp_path / "t")])
