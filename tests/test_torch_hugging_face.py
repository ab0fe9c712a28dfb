"""The port's HuggingFace loader (``caiman_asr_tpu_torch/data/hugging_face.py``)
against the JAX package's, on local datasets only (a directory holding
``validation.jsonl`` rows with an ``{array, sampling_rate}`` audio column,
read offline): the reader's samples and the loader's batches; ``val.py
--use_hugging_face`` on the workspace of ``tests/test_torch_val.py``; and
``train.main --use_hugging_face``, which trains from the manifests and
validates from the dataset, on the workspace of
``tests/test_torch_train_cli.py`` (fixtures imported).

``datasets`` is installed here but not on the card's machine:
``pytest.importorskip`` guards every test.

Tolerances: samples and batches equal to the bit; validation's hypotheses
and WER identical; losses rtol 1e-5 and gradient norms rtol 1e-4, as the
two imported files hold them.
"""

import json
import wave

import numpy as np
import pytest

from tests.test_torch_train_cli import (  # noqa: F401  (fixtures)
    GRAD_NORM_RTOL,
    LOSS_RTOL,
    _jax_main,
    _port_main,
    parity_args,
    read_log,
)
from tests.test_torch_train_cli import workspace as train_workspace  # noqa: F401
from tests.test_torch_val import run_both, workspace  # noqa: F401

pytest.importorskip("datasets")


def write_hf_dataset(root, entries, out, every_other_8k=False):
    """The manifest's utterances as a local HuggingFace dataset: ``out``
    holding validation.jsonl, the audio inline (every other row at 8 kHz
    when asked: a resample on reading)."""
    from scipy.signal import resample_poly

    out.mkdir(exist_ok=True)
    rows = []
    for i, e in enumerate(entries):
        with wave.open(str(root / e["files"][0]["fname"])) as w:
            x = np.frombuffer(w.readframes(w.getnframes()), np.int16) / 32768.0
        sr = 16000
        if every_other_8k and i % 2:
            x, sr = resample_poly(x, 1, 2), 8000
        rows.append({"audio": {"array": x.tolist(), "sampling_rate": sr},
                     "text": e["transcript"], "id": f"hf{i}"})
    (out / "validation.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    return out


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


@pytest.mark.parametrize("batch_size", [3, 8])
def test_reader_and_loader_batches_equal_jax(workspace, tmp_path, batch_size):  # noqa: F811
    from caiman_asr_tpu.data.hugging_face import HuggingFaceLoader as JaxLoader
    from caiman_asr_tpu.data.hugging_face import HuggingFaceReader as JaxReader
    from caiman_asr_tpu.data.tokenizer import Tokenizer as JaxTokenizer
    from caiman_asr_tpu_torch.data.hugging_face import HuggingFaceLoader, HuggingFaceReader
    from caiman_asr_tpu_torch.data.tokenizer import Tokenizer

    root, _ = workspace
    entries = json.loads((root / "manifest.json").read_text())
    ds = write_hf_dataset(root, entries, tmp_path / "ds", every_other_8k=True)
    labels = list(" abcdefghijklmnopqrstuvwxyz'")
    for shard in ((0, 1), (1, 2)):
        kw = dict(split="validation", shard_id=shard[0], num_shards=shard[1])
        got, want = list(HuggingFaceReader(str(ds), **kw)), list(JaxReader(str(ds), **kw))
        assert len(got) == len(want) == len(entries[shard[0]::shard[1]])
        for (a, t, k), (b, u, m) in zip(got, want):
            assert (t, k) == (u, m) and a.dtype == b.dtype and np.array_equal(a, b)
    loader = HuggingFaceLoader(HuggingFaceReader(str(ds), split="validation"),
                               Tokenizer(labels, root / "tok.json"), batch_size)
    jloader = JaxLoader(JaxReader(str(ds), split="validation"),
                        JaxTokenizer(labels, root / "tok.json"), batch_size)
    for resume in (0, 1):
        got, want = list(loader.epoch(0, resume)), list(jloader.epoch(0, resume))
        assert len(got) == len(want) == -(-len(entries) // batch_size) - resume
        for g, w in zip(got, want):
            for f in ("audio", "audio_lens", "tokens", "token_lens"):
                assert np.array_equal(getattr(g, f), getattr(w, f)), f
            assert (g.transcripts, g.fnames) == (w.transcripts, w.fnames)


def test_val_from_hugging_face_equals_jax(workspace, tmp_path):  # noqa: F811
    """val.py --use_hugging_face --hf_val_dataset <local dir> in both
    packages: the hypotheses, WER and loss of the manifest's utterances."""
    root, _ = workspace
    entries = json.loads((root / "manifest.json").read_text())
    ds = write_hf_dataset(root, entries, tmp_path / "ds")
    out = run_both(workspace, tmp_path, ["--use_hugging_face", "--hf_val_dataset", str(ds),
                                         "--hf_val_split", "validation", "--calc_loss",
                                         "--val_batch_size", "3"])
    (want, _), (got, _) = out["jax"], out["port"]
    assert got.fnames == want.fnames == [f"hf{i}" for i in range(len(entries))]
    assert (got.hyps, got.refs, got.wer) == (want.hyps, want.refs, want.wer)
    assert any(got.hyps)
    np.testing.assert_allclose(got.loss, want.loss, rtol=LOSS_RTOL)


def test_train_validates_from_hugging_face_as_jax(train_workspace, tmp_path):  # noqa: F811
    """train.main --use_hugging_face trains from the manifests and validates
    from a local dataset, as JAX's train.main does: the same steps, and the
    same dev loss and WER at each validation."""
    from caiman_asr_tpu.args.train import train_arg_parser as jax_parser
    from caiman_asr_tpu_torch.args.train import train_arg_parser

    root = train_workspace
    entries = json.loads((root / "manifest.json").read_text())
    ds = write_hf_dataset(root, entries[:6], tmp_path / "ds")
    kw = dict(use_hugging_face=True, hugging_face_val_dataset=str(ds),
              hugging_face_val_split="validation", val_manifests=[], training_steps=2,
              val_frequency=1, save_frequency=2)
    outs = {}
    for name, parser, fn in (("jax", jax_parser, _jax_main), ("port", train_arg_parser,
                                                              _port_main)):
        outs[name] = tmp_path / name
        fn(parity_args(parser, root, outs[name], **kw))
    (got, got_dev), (want, want_dev) = read_log(outs["port"]), read_log(outs["jax"])
    assert sorted(got) == sorted(want) == [1, 2]
    for s in want:
        np.testing.assert_allclose(got[s][0], want[s][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[s][1], want[s][1], rtol=GRAD_NORM_RTOL)
    assert sorted(got_dev) == sorted(want_dev) and len(want_dev) >= 2
    for s in want_dev:
        np.testing.assert_allclose(got_dev[s], want_dev[s], rtol=LOSS_RTOL)
    wers = {}
    for name, out in outs.items():
        recs = [json.loads(line) for f in sorted(out.glob("log_*.jsonl"))
                for line in f.read_text().splitlines()]
        wers[name] = [(r["step"], r.get("wer")) for r in recs if r.get("subset") == "dev_ema"]
    assert wers["port"] == wers["jax"]
