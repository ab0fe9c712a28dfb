"""The port's user-token and <unk> helpers (``caiman_asr_tpu_torch/utils/
user_tokens.py``, ``data/unk_handling.py``) and the training parts of its
config loader (``models/config.py``: ``spec_augment``,
``grad_noise_scheduler``, ``user_tokens``) against the JAX package's."""

from pathlib import Path

import pytest

from caiman_asr_tpu.data import unk_handling as junk
from caiman_asr_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from caiman_asr_tpu.data.tokenizer import save_tokenizer_json, train_tokenizer
from caiman_asr_tpu.models.config import load_config as jax_load_config
from caiman_asr_tpu.utils import user_tokens as jut
from caiman_asr_tpu_torch.data import unk_handling as tunk
from caiman_asr_tpu_torch.data.tokenizer import Tokenizer
from caiman_asr_tpu_torch.models.config import load_config
from caiman_asr_tpu_torch.utils import user_tokens as tut

REPO = Path(__file__).resolve().parents[1]
LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
TEXTS = ["the cat sat", "a dog barks <EOS>", "hello world <EOS>"]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = tmp_path_factory.mktemp("ut") / "t.json"
    pieces = train_tokenizer([t.replace(" <EOS>", "") for t in TEXTS] * 4, vocab_size=40,
                             user_symbols=["<EOS>"])
    save_tokenizer_json(path, pieces)
    return Tokenizer(LABELS, path), JaxTokenizer(LABELS, path)


def test_tags_and_token_tables_match_jax():
    for s in ("<EOS>", "<star>", "EOS", "<a b>", "<<x>>", "<>", "<x>y"):
        assert tut.is_tag(s) == jut.is_tag(s)
    for table in ({"eos": "<EOS>", "star": None}, {}, None, {"eos": "<EOS>", "star": "<*>"}):
        assert tut.get_all_user_tokens(table) == jut.get_all_user_tokens(table)
    for mod in (tut, jut):
        with pytest.raises(ValueError):
            mod.get_all_user_tokens({"eos": "plain"})


def test_user_token_ids_match_jax(tokenizers):
    """The ids the train step takes as eos_idx / star_idx, as the JAX
    trainer resolves them (``train.py:246-257``)."""
    port, jax_tok = tokenizers
    table = {"eos": "<EOS>"}
    idx = tut.get_user_token("eos", table, port)
    assert idx == jut.get_user_token("eos", table, jax_tok)
    assert isinstance(idx, int) and port.id_to_piece(idx).lstrip("▁") == "<EOS>"
    assert tut.get_user_token("star", table, port) is None
    assert tut.get_user_token("eos", table) == "<EOS>"
    assert tut.user_token_idx("eos", table, port) == idx
    assert tut.user_token_idx("star", table, port) == -1
    # a tag that is no single piece: the JAX package raises, the trainer disables it
    bad = {"star": "<star>"}
    for mod, tok in ((tut, port), (jut, jax_tok)):
        with pytest.raises(ValueError):
            mod.get_user_token("star", bad, tok)
    assert tut.user_token_idx("star", bad, port) == -1


def test_unk_handling_matches_jax():
    for tmod in (tunk, junk):
        tmod.check_tokenized_transcript([1, 2], "ok", tmod.UnkHandling.FAIL)
        with pytest.raises(ValueError):
            tmod.check_tokenized_transcript([1, 0], "bad", tmod.UnkHandling.FAIL)
    with pytest.warns(UserWarning):
        tunk.check_tokenized_transcript([0], "warned-once in the port", tunk.UnkHandling.WARN)
    for transcripts in ([[1], [0], [2]], [[0]], []):
        for mode in ("WARN", "FAIL"):
            assert (tunk.maybe_filter_transcripts(transcripts, tunk.UnkHandling(mode))
                    == junk.maybe_filter_transcripts(transcripts, junk.UnkHandling(mode)))


@pytest.mark.parametrize("name", ["base-8703sp.yaml", "large-17407sp.yaml",
                                  "testing-1023sp.yaml"])
def test_training_config_matches_jax(name):
    got, want = load_config(REPO / "configs" / name), jax_load_config(REPO / "configs" / name).cfg
    assert got.user_tokens == want.user_tokens
    assert vars(got.grad_noise) == vars(want.grad_noise)
    for part in ("input_train", "input_val"):
        g, w = getattr(got, part).specaugment, getattr(want, part).specaugment
        assert (g is None) == (w is None)
        if g is not None:
            assert vars(g) == vars(w)
    if name == "base-8703sp.yaml":
        assert got.input_train.specaugment.time_masks == 10
        assert got.input_val.specaugment is None
        assert got.user_tokens == {"eos": "<EOS>"}
        assert got.grad_noise.noise_level == 0.0
