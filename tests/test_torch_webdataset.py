"""The port's webdataset reader, loader and shard writer
(``caiman_asr_tpu_torch/data/webdataset.py``, ``data/make_webdataset.py``)
against the JAX package's (``caiman_asr_tpu/data/webdataset.py``,
``data/make_webdataset.py``), and training on tar shards.

Shards of WAV and FLAC utterances, written by either package's writer, and
zip shards of the same members: the port's samples (keys, transcripts and
decoded audio, equal to the bit), in the order of the seeded shuffle
buffer, and its batches equal JAX's, with the filters and a resume offset;
three ranks together read JAX's samples exactly once. ``train.main`` on tar
shards in one process takes JAX's steps (the tolerances of
``tests/test_torch_train_cli.py``), and two ranks on tar shards resume to
the bit.
"""

import importlib.util
import io
import tarfile
import wave
import zipfile
from pathlib import Path

import numpy as np
import pytest

from caiman_asr_tpu.args.train import train_arg_parser as jax_train_arg_parser
from caiman_asr_tpu.data import make_webdataset as jax_make
from caiman_asr_tpu.data import webdataset as jax_wds
from caiman_asr_tpu.data.manifest import load_manifests as jax_load_manifests
from caiman_asr_tpu.data.text.normalize import NormalizeConfig as JaxNormalizeConfig
from caiman_asr_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from caiman_asr_tpu_torch.args.train import train_arg_parser
from caiman_asr_tpu_torch.data import make_webdataset, webdataset
from caiman_asr_tpu_torch.data.manifest import load_manifests
from caiman_asr_tpu_torch.data.text.normalize import NormalizeConfig
from caiman_asr_tpu_torch.data.tokenizer import Tokenizer
from caiman_asr_tpu_torch.export.checkpointer import flatten_named, load_checkpoint
from tests.test_torch_train_cli import (  # noqa: F401 (fixtures)
    _jax_main, _port_main, assert_checkpoints_close, assert_steps_close, augmented_args,
    packing, parity_args, read_log, workspace,
)
from tests.test_torch_train_multihost import finish_ranks, run_ranks, start_ranks

_spec = importlib.util.spec_from_file_location(
    "native_tests", Path(__file__).parent / "native" / "test_native.py")
_native_tests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_native_tests)
encode_flac_verbatim = _native_tests.encode_flac_verbatim

TEXTS = ["the cat sat", "a dog barks at night", "she sells sea shells by the shore",
         "hello world", "testing one two three", "over the lazy dog", "quick brown fox",
         "long speech here", "more words to read", "the end of it", "x", "y z"]


def _wav_bytes(x: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Twelve utterances, WAV and FLAC alternately (one at 8 kHz, one long),
    a manifest of them, shards from each package's writer (5 a shard) and
    zip copies of the JAX shards."""
    root = tmp_path_factory.mktemp("wds")
    rng = np.random.default_rng(0)
    entries = []
    for i, text in enumerate(TEXTS):
        sr = 8000 if i == 3 else 16000
        dur = 3.5 if i == 5 else 0.3 + 0.05 * i
        x = rng.normal(size=int(sr * dur)) * 3000
        name = f"u{i:02d}." + ("flac" if i % 2 else "wav")
        (root / name).write_bytes(encode_flac_verbatim(x, sr) if i % 2 else _wav_bytes(x, sr))
        entries.append({"transcript": text, "files": [{"fname": name, "duration": dur}],
                        "original_duration": dur})
    import json

    (root / "manifest.json").write_text(json.dumps(entries))
    shards = {
        "jax": jax_make.write_shards(jax_load_manifests([root / "manifest.json"]),
                                     root / "jax_shards", samples_per_shard=5),
        "port": make_webdataset.write_shards(load_manifests([root / "manifest.json"]),
                                             root / "port_shards", samples_per_shard=5),
    }
    zips = []
    for p in shards["jax"]:
        z = root / "zips" / (p.stem + ".tar")  # the container is sniffed, not the suffix
        z.parent.mkdir(exist_ok=True)
        with tarfile.open(p) as t, zipfile.ZipFile(z, "w") as out:
            for m in t:
                out.writestr(m.name, t.extractfile(m).read())
        zips.append(z)
    shards["zip"] = zips
    return root, shards


def members(paths):
    out = []
    for p in paths:
        with tarfile.open(p) as t:
            out += [(m.name, t.extractfile(m).read()) for m in t]
    return out


def test_the_writer_matches_jax(corpus):
    root, shards = corpus
    assert [p.name for p in shards["port"]] == [p.name for p in shards["jax"]] == [
        "shard-000000.tar", "shard-000001.tar", "shard-000002.tar"]
    got, want = members(shards["port"]), members(shards["jax"])
    assert [n for n, _ in got] == [n for n, _ in want]
    assert got == want
    assert [p.read_bytes() for p in shards["port"]] == [p.read_bytes() for p in shards["jax"]]


def test_the_writers_cli(corpus, tmp_path):
    root, shards = corpus
    paths = make_webdataset.main(["--manifests", "manifest.json", "--dataset_dir", str(root),
                                  "--output_dir", str(tmp_path), "--samples_per_shard", "5"])
    assert members(paths) == members(shards["jax"])


def _samples(reader, epoch):
    return [(k, t, a) for a, t, k in reader.shuffled(epoch)]


def assert_samples_equal(got, want):
    assert [(k, t) for k, t, _ in got] == [(k, t) for k, t, _ in want]
    for (k, _, a), (_, _, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("source", ["jax", "port", "zip"])
@pytest.mark.parametrize("shard_id, num_shards", [(0, 1), (0, 3), (1, 3), (2, 3)])
def test_the_reader_matches_jax(corpus, source, shard_id, num_shards):
    """Samples, their order through the shuffle buffer (smaller than the
    shard, and larger), the filters, and the sharding."""
    _, shards = corpus
    for kw in (dict(shuffle_buffer=4, seed=3), dict(shuffle_buffer=64, seed=0,
                                                    max_duration=2.0, max_transcript_len=20)):
        got = webdataset.WebDatasetReader(shards[source], 16000, shard_id=shard_id,
                                          num_shards=num_shards, **kw)
        want = jax_wds.WebDatasetReader(shards[source], 16000, shard_id=shard_id,
                                        num_shards=num_shards, **kw)
        for epoch in (0, 1):
            assert_samples_equal(_samples(got, epoch), _samples(want, epoch))


def test_three_ranks_read_every_sample_once(corpus):
    _, shards = corpus
    want = _samples(jax_wds.WebDatasetReader(shards["jax"], 16000, shuffle_buffer=1), 0)
    parts = [_samples(webdataset.WebDatasetReader(shards["port"], 16000, shuffle_buffer=1,
                                                  shard_id=r, num_shards=3), 0)
             for r in range(3)]
    keys = sorted(k for part in parts for k, _, _ in part)
    assert keys == sorted(k for k, _, _ in want) and len(keys) == len(TEXTS)
    by_key = {k: a for k, _, a in want}
    assert all(np.array_equal(a, by_key[k]) for part in parts for k, _, a in part)
    assert [len(p) for p in parts] == [4, 4, 4]


def test_the_reader_refuses_a_missing_shard_and_has_no_length(corpus, tmp_path):
    _, shards = corpus
    with pytest.raises(FileNotFoundError):
        webdataset.WebDatasetReader([tmp_path / "none.tar"])
    with pytest.raises(webdataset.LengthUnknownError):
        len(webdataset.WebDatasetReader(shards["jax"]))


@pytest.fixture(scope="module")
def tokenizers(workspace):
    cfg = dict(labels=list(" abcdefghijklmnopqrstuvwxyz'"), sentpiece_model=workspace / "tok.json")
    return Tokenizer(**cfg, sampling=0.3, seed=5), JaxTokenizer(**cfg, sampling=0.0)


@pytest.mark.parametrize("drop_last, resume_step", [(True, 0), (False, 0), (False, 1),
                                                    (True, 2)])
def test_the_loader_matches_jax(corpus, tokenizers, drop_last, resume_step):
    """Batches of 3 (padded shapes, tokens, lengths, transcripts, keys);
    without subword sampling both tokenise alike. The port's batches carry
    the tokenizer's stream after each."""
    _, shards = corpus
    port_tok, jax_tok = tokenizers
    sampling, port_tok.sampling = port_tok.sampling, 0.0
    try:
        got = list(webdataset.WebDatasetLoader(
            webdataset.WebDatasetReader(shards["port"], 16000, shuffle_buffer=4, seed=1),
            port_tok, 3, normalize_config=NormalizeConfig(), drop_last=drop_last
        ).epoch(1, resume_step=resume_step))
    finally:
        port_tok.sampling = sampling
    want = list(jax_wds.WebDatasetLoader(
        jax_wds.WebDatasetReader(shards["jax"], 16000, shuffle_buffer=4, seed=1), jax_tok, 3,
        normalize_config=JaxNormalizeConfig(), drop_last=drop_last
    ).epoch(1, resume_step=resume_step))
    assert len(got) == len(want) == 4 - resume_step
    for g, w in zip(got, want):
        for k in ("audio", "audio_lens", "tokens", "token_lens"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k), err_msg=k)
        assert g.transcripts == w.transcripts and g.fnames == w.fnames
        assert isinstance(g.host_rng, list) and len(g.host_rng) == 1


def test_the_loaders_host_stream_restores(corpus, tokenizers):
    """With subword sampling on, the batches after a restored stream are
    those of the run that saved it."""
    _, shards = corpus
    port_tok, _ = tokenizers
    loader = webdataset.WebDatasetLoader(
        webdataset.WebDatasetReader(shards["port"], 16000, shuffle_buffer=4), port_tok, 3,
        drop_last=True)
    first = list(loader.epoch(0))
    loader.set_host_rng_state(first[1].host_rng)
    again = list(loader.epoch(0, resume_step=2))
    assert [b.tokens.tolist() for b in again] == [b.tokens.tolist() for b in first[2:]]
    with pytest.raises(ValueError):
        loader.set_host_rng_state([])


def test_read_shard_transcripts_matches_jax(corpus):
    _, shards = corpus
    for source in ("port", "zip"):
        got = webdataset.read_shard_transcripts(shards[source])
        assert got == jax_wds.read_shard_transcripts(shards[source]) == TEXTS


def test_the_builder_shards_the_tar_reader_by_rank(corpus, workspace, monkeypatch):
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.parallel import mesh
    from caiman_asr_tpu_torch.setup.builders import build_data_source_loader

    root, shards = corpus
    args = train_arg_parser().parse_args(
        ["--read_from_tar", "--dataset_dir", str(root), "--train_tar_files",
         *[str(p.relative_to(root)) for p in shards["port"]]])
    cfg = load_config(workspace / "plain.yaml")
    tok = Tokenizer(labels=list(cfg.tokenizer.labels), sentpiece_model=workspace / "tok.json")
    monkeypatch.setattr(mesh, "rank", lambda: 2)
    monkeypatch.setattr(mesh, "world", lambda: 3)
    loader = build_data_source_loader(args, cfg, tok, 2, train=True, seed=4)
    assert isinstance(loader, webdataset.WebDatasetLoader) and loader.drop_last
    r = loader.reader
    assert (r.shard_id, r.num_shards, r.seed, r.max_duration) == (2, 3, 4, 20.0)
    assert r.tars == [root / p.relative_to(root) for p in shards["port"]]


def tar_args(parser, root, out, shards, **kw):
    return parity_args(parser, root, out, read_from_tar=True,
                       train_tar_files=[str(p) for p in shards],
                       val_tar_files=[str(p) for p in shards], **kw)


@pytest.fixture(scope="module")
def workspace_shards(workspace):
    return make_webdataset.write_shards(load_manifests([workspace / "manifest.json"]),
                                        workspace / "shards", samples_per_shard=3)


def test_training_on_tar_shards_matches_jax(workspace, workspace_shards, packing, tmp_path):
    """One process: the port's train.main with --read_from_tar takes JAX's
    4 steps and validations on the same shards."""
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    _jax_main(tar_args(jax_train_arg_parser, workspace, jax_out, workspace_shards))
    _port_main(tar_args(train_arg_parser, workspace, port_out, workspace_shards))
    got, got_dev = read_log(port_out)
    want, want_dev = read_log(jax_out)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    assert_steps_close(got, want, [1, 2, 3, 4])
    assert sorted(got_dev) == sorted(want_dev) == [2, 4]
    for s in got_dev:
        np.testing.assert_allclose(got_dev[s], want_dev[s], rtol=1e-5)
    assert_checkpoints_close(port_out / "ckpts" / "last.npz", jax_out / "ckpts" / "last.npz")
    _, _, _, meta = load_checkpoint(port_out / "ckpts" / "last.npz")
    assert meta["_data_position"] == [1, 4]  # epoch 1 of 4 microbatches, all taken


def test_two_ranks_on_tar_shards_resume_to_the_bit(workspace, workspace_shards, tmp_path):
    """Two ranks, each reading every other sample pair, with the run's
    randomness on (subword sampling, dropout, SpecAugment, dither): 4 steps
    against 2, then --resume to 4; the checkpoint records where the stream
    stands."""
    kw = dict(read_from_tar=True, train_tar_files=[str(p) for p in workspace_shards],
              global_batch_size=4, training_steps=4, val_frequency=2,
              val_tar_files=[str(p) for p in workspace_shards])
    a, b = tmp_path / "ctl", tmp_path / "intr"
    ctl = start_ranks(augmented_args(workspace, a, **kw), tmp_path, name="ctl")
    first = start_ranks(augmented_args(workspace, b, **dict(kw, training_steps=2)), tmp_path,
                        name="first")
    _, want_states = finish_ranks(*ctl)
    finish_ranks(*first)
    _, _, _, meta = load_checkpoint(b / "ckpts" / "last.npz")
    assert meta["_data_position"] == [1, 2] and len(meta["_host_rng"]) == 2
    _, got_states = run_ranks(augmented_args(workspace, b, resume=True, **kw), tmp_path,
                              name="resumed")
    want, want_dev = read_log(a)
    got, got_dev = read_log(b)
    assert sorted(want) == [1, 2, 3, 4] and sorted(want_dev) == [2, 4]
    for s in (3, 4):
        assert got[s] == want[s], (s, got[s], want[s])
    assert got_dev[4] == want_dev[4]
    for r in range(2):
        assert all(np.array_equal(want_states[r][k], got_states[r][k]) for k in want_states[r])
    ca, cb = (flatten_named(load_checkpoint(o / "ckpts" / "last.npz")[0]) for o in (a, b))
    assert all(np.array_equal(ca[k], cb[k]) for k in ca)
