"""The port's tokenizer (the reading half of ``data/tokenizer.py``) against
the JAX package's: a SentencePiece model written by the JAX package loads to
the same pieces, from a file or from its bytes, and ``tokenize``,
``detokenize`` and ``id_to_piece`` agree, with and without sampling."""

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
