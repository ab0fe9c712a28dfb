"""The port's data tools against the JAX package's, each run as its CLI on the
same synthetic files: ``data/make_datasets/io.py`` (the local parts),
``librispeech.py`` on an extracted tree shaped like LibriSpeech (FLAC from a
verbatim encoder), ``hf_to_json.py`` on a local HuggingFace dataset,
``segment_manifest.py`` / ``eos_add.py``, ``mean_json_duration.py``, and
``--read_from_tar`` in ``spm_train`` and ``generate_mel_stats``.

Tolerances: every file written equals JAX's byte for byte; numbers read
from headers are equal; the mel statistics within 1e-5 relative, as
``tests/test_torch_mel_stats.py`` holds them (the two log-mel front ends
round their fp32 products differently).
"""

import json
import shutil
import tarfile
import wave

import numpy as np
import pytest

from tests.native.test_native import encode_flac_verbatim

MEL_RTOL = 1e-5
TEXTS = ["The cat sat on the mat. It was happy!", "a dog barks at night",
         "Is it raining? yes. no", "hello world how are you. fine thanks",
         "   ", "Mr. Smith went home... then slept"]


def write_wav(path, pcm, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())


def tone(i, n):
    """A tone over a noise floor, as 16-bit PCM."""
    t = np.arange(n) / 16000
    noise = np.random.default_rng(i).normal(size=n) * 1600
    return (8000 * np.sin(2 * np.pi * (150 + 60 * i) * t) + noise).astype(np.int16)


@pytest.fixture(scope="module")
def libri(tmp_path_factory):
    """<root>/LibriSpeech/dev-clean/<speaker>/<chapter>/ with FLAC files and
    ``*.trans.txt`` transcripts (one utterance listed without audio)."""
    root = tmp_path_factory.mktemp("libri")
    for spk, chap, n in ((84, 121123, 3), (174, 50561, 2)):
        d = root / "LibriSpeech" / "dev-clean" / str(spk) / str(chap)
        d.mkdir(parents=True)
        lines = []
        for u in range(n):
            utt = f"{spk}-{chap}-{u:04d}"
            (d / f"{utt}.flac").write_bytes(encode_flac_verbatim(tone(u, 1600 + 400 * u)))
            lines.append(f"{utt} {TEXTS[u].upper()}")
        lines.append(f"{spk}-{chap}-9999 NO AUDIO HERE")
        (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    return root


def test_io_matches_jax(libri, tmp_path):
    import hashlib

    from caiman_asr_tpu.data.make_datasets import io as jio
    from caiman_asr_tpu_torch.data.make_datasets import io

    flac = next(libri.rglob("84-121123-0000.flac"))
    assert io.flac_info(flac) == jio.flac_info(flac)
    assert io.flac_info(flac)["total_samples"] == 1600
    write_wav(tmp_path / "a.wav", tone(0, 4000))
    for f in (flac, tmp_path / "a.wav"):
        assert io.audio_duration(f) == jio.audio_duration(f)
    with pytest.raises(ValueError):
        io.audio_duration(tmp_path / "x.mp3")
    with pytest.raises(ValueError, match="not a FLAC"):
        io.flac_info(tmp_path / "a.wav")
    md5 = hashlib.md5(flac.read_bytes()).hexdigest()
    assert io.md5_checksum(flac, md5) and not io.md5_checksum(flac, "0" * 32)
    with tarfile.open(tmp_path / "a.tar.gz", "w:gz") as tar:
        tar.add(tmp_path / "a.wav", arcname="d/a.wav")
    io.extract_tar(tmp_path / "a.tar.gz", tmp_path / "out")
    assert (tmp_path / "out" / "d" / "a.wav").read_bytes() == (tmp_path / "a.wav").read_bytes()


@pytest.mark.parametrize("extra", [[], ["--convert_to_wav"], ["--use_absolute_path"],
                                   ["--skip_prepare_manifests"]],
                         ids=["flac", "wav", "absolute", "skip"])
def test_librispeech_manifest_equals_jax(libri, tmp_path, extra):
    from caiman_asr_tpu.data.make_datasets import librispeech as jls
    from caiman_asr_tpu_torch.data.make_datasets import librispeech as ls

    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name  # the same path length: absolute paths differ by name
        shutil.copytree(libri, dirs[name])
    argv = ["--subsets", "dev-clean", "--skip_download_data", "--num_jobs", "2", *extra]
    jls.main(["--data_dir", str(dirs["jax"]), *argv])
    ls.main(["--data_dir", str(dirs["port"]), *argv])
    suffix = "wav" if "--convert_to_wav" in extra else "flac"
    files = {n: d / f"librispeech-dev-clean-{suffix}.json" for n, d in dirs.items()}
    if "--skip_prepare_manifests" in extra:
        assert not files["jax"].exists() and not files["port"].exists()
        return
    got = files["port"].read_text()
    want = files["jax"].read_text()
    if "--use_absolute_path" in extra:
        want = want.replace(str(dirs["jax"]), str(dirs["port"]))
    assert got == want
    entries = json.loads(got)
    assert len(entries) == 5 and entries[0]["transcript"] == TEXTS[0].lower()
    if suffix == "wav":
        for wav in dirs["jax"].rglob("*.wav"):
            port_wav = dirs["port"] / wav.relative_to(dirs["jax"])
            assert port_wav.read_bytes() == wav.read_bytes()


def test_librispeech_extracts_a_local_archive_and_downloads_nothing(libri, tmp_path):
    from caiman_asr_tpu_torch.data.make_datasets import librispeech as ls

    src = libri / "LibriSpeech" / "dev-clean"
    with tarfile.open(tmp_path / "my-part.tar.gz", "w:gz") as tar:
        tar.add(src, arcname="LibriSpeech/my-part")
    manifest = ls.prepare_subset(tmp_path, "my-part", num_jobs=1)
    assert len(json.loads(manifest.read_text())) == 5
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        ls.prepare_subset(tmp_path / "empty", "dev-other")
    # a known part's archive is held to its MD5
    shutil.copy(tmp_path / "my-part.tar.gz", tmp_path / "dev-other.tar.gz")
    with pytest.raises(RuntimeError, match="MD5"):
        ls.prepare_subset(tmp_path, "dev-other")


@pytest.mark.parametrize("text", TEXTS + ["no punctuation at all", "One. Two. Three.",
                                          "end with quote.\" next", ""])
def test_segmentation_equals_jax(text):
    from caiman_asr_tpu.data import segment_manifest as jsm
    from caiman_asr_tpu_torch.data import segment_manifest as sm

    assert sm.rule_based_segment(text) == jsm.rule_based_segment(text)
    assert "".join(sm.rule_based_segment(text)) == text
    splits = sm.rule_based_segment(text.strip())
    rep = sm.rule_based_segment(" ".join([text.strip()] * 2))
    for eos in ("<EOS>", " <EOS> "):
        assert (sm.build_transcript(sm.merge_split_words(splits), sm.merge_split_words(rep),
                                    sm.make_eos_for(eos))
                == jsm.build_transcript(jsm.merge_split_words(splits),
                                        jsm.merge_split_words(rep), jsm.make_eos_for(eos)))


@pytest.mark.parametrize("extra", [[], ["--append_only"], ["--eos_token", "<eos>"]])
def test_eos_add_equals_jax(tmp_path, extra):
    from caiman_asr_tpu.data.eos_add import main as jax_main
    from caiman_asr_tpu_torch.data.eos_add import main

    entries = [{"transcript": t, "files": [{"fname": f"u{i}.wav", "duration": 1.0}],
                "original_duration": 1.0} for i, t in enumerate(TEXTS)]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "m.json").write_text(json.dumps(entries))
    jax_main(["--data_dir", str(tmp_path / "jax"), "--manifests", "m.json", "--no_cuda", *extra])
    main(["--data_dir", str(tmp_path / "port"), "--manifests", "m.json", "--no_cuda", *extra])
    got = (tmp_path / "port" / "m.eos.json").read_text()
    assert got == (tmp_path / "jax" / "m.eos.json").read_text()
    out = json.loads(got)
    if "--append_only" not in extra:
        assert out[4]["transcript"] == "   "  # whitespace passes through
    if not extra:
        assert out[0]["eos_count"] == 2
    # an existing output is kept without --overwrite
    (tmp_path / "port" / "m.eos.json").write_text("kept")
    main(["--data_dir", str(tmp_path / "port"), "--manifests", "m.json", *extra])
    assert (tmp_path / "port" / "m.eos.json").read_text() == "kept"
    with pytest.raises(SystemExit):
        main(["--manifests", "m.json", "--eos_token", "EOS"])


def test_mean_json_duration_equals_jax(tmp_path):
    from caiman_asr_tpu.data import mean_json_duration as jmd
    from caiman_asr_tpu_torch.data import mean_json_duration as md

    for name, durs in (("a.json", [1.5, 3.25, 30.0]), ("b.json", [0.5, 19.99])):
        (tmp_path / name).write_text(json.dumps(
            [{"transcript": "x", "files": [], "original_duration": d} for d in durs]))
    for argv in (["--data_dir", str(tmp_path), "--jsons", "a.json", "b.json"],
                 ["--data_dir", str(tmp_path), "--jsons", "a.json", "--max_duration", "2"]):
        got = md.main(md.get_parser().parse_args(argv))
        assert got == jmd.main(jmd.get_parser().parse_args(argv))
    assert got == 1.5
    with pytest.raises(SystemExit):
        md.main(md.get_parser().parse_args(["--data_dir", str(tmp_path), "--jsons", "b.json",
                                            "--max_duration", "0.1"]))


def test_hf_to_json_equals_jax(tmp_path, monkeypatch):
    """A local HuggingFace dataset (a directory holding validation.jsonl, rows
    at 16 and 8 kHz) converted by both CLIs: the same manifests (split every
    2 utterances) and WAV files."""
    pytest.importorskip("datasets")
    from caiman_asr_tpu.data.make_datasets.hf_to_json import main as jax_main
    from caiman_asr_tpu_torch.data.make_datasets.hf_to_json import main

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    rng = np.random.default_rng(5)
    (tmp_path / "ds").mkdir()
    rows = [{"audio": {"array": (rng.normal(size=800 + 160 * i) * 0.1).tolist(),
                       "sampling_rate": 16000 if i % 2 == 0 else 8000},
             "text": t, "id": f"utt{i}"} for i, t in enumerate(TEXTS[:5])]
    (tmp_path / "ds" / "validation.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    argv = ["--hf_dataset", str(tmp_path / "ds"), "--hf_split", "validation",
            "--max_utterances_per_json", "2", "--max_leaf_dir_audios", "2",
            "--max_branch_dir_audios", "2"]
    want = jax_main(argv + ["--data_dir", str(tmp_path / "jax")])
    got = main(argv + ["--data_dir", str(tmp_path / "port")])
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 3
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Six WAV utterances, their manifest, and the same as two tar shards
    written by the port's make_webdataset."""
    from caiman_asr_tpu_torch.data.make_webdataset import write_shards
    from caiman_asr_tpu_torch.data.manifest import load_manifests

    root = tmp_path_factory.mktemp("shards")
    entries = []
    for i, text in enumerate(TEXTS):
        n = 3000 + 1700 * i
        write_wav(root / f"u{i}.wav", tone(i, n))
        entries.append({"transcript": text or "x",
                        "files": [{"fname": f"u{i}.wav", "duration": n / 16000}],
                        "original_duration": n / 16000})
    (root / "m.json").write_text(json.dumps(entries))
    tars = write_shards(load_manifests([root / "m.json"]), root / "tar", samples_per_shard=4)
    assert len(tars) == 2
    return root, [str(p.relative_to(root)) for p in tars]


def test_spm_train_reads_tar_shards_as_jax(shards, tmp_path):
    from caiman_asr_tpu.data.spm_train import main as jax_main
    from caiman_asr_tpu_torch.data.spm_train import main

    root, tars = shards
    tar_argv = ["--read_from_tar", "--tar_files", *tars, "--dataset_dir", str(root),
                "--vocab_size", "40"]
    jax_main(tar_argv + ["--output_prefix", str(tmp_path / "jax")])
    main(tar_argv + ["--output_prefix", str(tmp_path / "port")])
    main(["--manifests", "m.json", "--dataset_dir", str(root), "--vocab_size", "40",
          "--output_prefix", str(tmp_path / "manifest")])
    for ext in ("model", "json"):
        got = (tmp_path / f"port.{ext}").read_bytes()
        assert got == (tmp_path / f"jax.{ext}").read_bytes()
        assert got == (tmp_path / f"manifest.{ext}").read_bytes()


@pytest.mark.parametrize("max_utts", [None, 4])
def test_generate_mel_stats_reads_tar_shards_as_jax(shards, tmp_path, max_utts):
    from caiman_asr_tpu.data.generate_mel_stats import main as jax_main
    from caiman_asr_tpu_torch.data.generate_mel_stats import main
    from tests.test_torch_mel_stats import CONFIG

    root, tars = shards
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CONFIG.format(n_filt=40))
    base = ["--model_config", str(cfg), "--dataset_dir", str(root), "--batch_size", "3"] + (
        ["--max_utts", str(max_utts)] if max_utts else [])
    tar_argv = base + ["--read_from_tar", "--tar_files", *tars]
    jax_main(tar_argv + ["--output_path", str(tmp_path / "jax.npz")])
    main(tar_argv + ["--output_path", str(tmp_path / "port.npz")], device="cpu")
    main(base + ["--manifests", "m.json", "--output_path", str(tmp_path / "manifest.npz")],
         device="cpu")
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want, \
            np.load(tmp_path / "manifest.npz") as man:
        for k in ("melmeans", "melvars"):
            np.testing.assert_allclose(got[k], want[k], rtol=MEL_RTOL, err_msg=k)
            np.testing.assert_array_equal(got[k], man[k])  # the same audio, the same order
