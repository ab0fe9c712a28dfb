"""The port's latency and evaluation tools against the JAX package's, on the
workspace of ``tests/test_torch_val.py`` (its fixture imported): the
ground-truth CTM from forced alignment (``latency/generate_gt_ctm.py``),
emission latency (``latency/measure_latency.py`` and its lite summary) and
``val_multiple.py``, each as its CLI runs, the port on the CPU.

Tolerances: CTMs, manifests of results and the CSV's WER row equal JAX's
byte for byte; latency metrics equal (the same float64 arithmetic on the
same CTMs); losses within rtol 1e-5 (fp32 sums in another order), as
``tests/test_torch_val.py`` holds them.
"""

import csv
import json
import wave

import numpy as np
import pytest

from caiman_asr_tpu.latency import generate_gt_ctm as jax_gt
from caiman_asr_tpu.latency import measure_latency as jax_ml
from caiman_asr_tpu.latency.measure_latency_lite import compute_latency_metrics as jax_metrics
from caiman_asr_tpu_torch.latency import generate_gt_ctm, measure_latency
from caiman_asr_tpu_torch.latency.measure_latency_lite import compute_latency_metrics
from tests.test_torch_val import TEXTS, run_both, workspace  # noqa: F401  (fixture)

LOSS_RTOL = 1e-5
LONG_S = 65.0  # one utterance past a minute: --segment_len 1 cuts it in two


@pytest.fixture(scope="module")
def long_manifest(workspace):  # noqa: F811
    """One utterance of ``LONG_S`` seconds (the workspace's eight WAVs
    repeated) with their transcripts joined."""
    root, _ = workspace
    pcm, words = [], []
    while sum(map(len, pcm)) < LONG_S * 16000:
        for i, text in enumerate(TEXTS):
            with wave.open(str(root / f"utt{i}.wav")) as w:
                pcm.append(np.frombuffer(w.readframes(w.getnframes()), np.int16))
            words.append(text)
    audio = np.concatenate(pcm)
    with wave.open(str(root / "long.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(audio.tobytes())
    dur = len(audio) / 16000
    (root / "long.json").write_text(json.dumps([{
        "transcript": " ".join(words), "files": [{"fname": "long.wav", "duration": dur}],
        "original_duration": dur}]))
    return "long.json"


def _gt_argv(workspace, manifest, out, *extra):  # noqa: F811
    root, configs = workspace
    return ["--model_config", str(configs["mini"]), "--ckpt", str(root / "ckpt.npz"),
            "--dataset_dir", str(root), "--manifests", manifest, "--output_ctm", str(out),
            *extra]


@pytest.mark.parametrize("batch_size", ["8", "3"])
def test_generate_gt_ctm_equals_jax(workspace, tmp_path, batch_size):  # noqa: F811
    jax_gt.main(_gt_argv(workspace, "manifest.json", tmp_path / "jax.ctm", "--batch_size",
                         batch_size))
    generate_gt_ctm.main(_gt_argv(workspace, "manifest.json", tmp_path / "port.ctm",
                                  "--batch_size", batch_size, "--cpu"))
    got = (tmp_path / "port.ctm").read_text()
    assert got == (tmp_path / "jax.ctm").read_text()
    # one row a word of every transcript
    assert len(got.splitlines()) == sum(len(t.split()) for t in TEXTS)


def test_generate_gt_ctm_segmented_equals_jax_and_whole(workspace, long_manifest,
                                                        tmp_path):  # noqa: F811
    """--segment_len 1 encodes the 65 s utterance as two segments carrying
    the LSTM state: JAX's CTM, and the whole utterance's."""
    jax_gt.main(_gt_argv(workspace, long_manifest, tmp_path / "jax.ctm", "--segment_len", "1"))
    generate_gt_ctm.main(_gt_argv(workspace, long_manifest, tmp_path / "seg.ctm",
                                  "--segment_len", "1", "--cpu"))
    generate_gt_ctm.main(_gt_argv(workspace, long_manifest, tmp_path / "whole.ctm", "--cpu"))
    seg = (tmp_path / "seg.ctm").read_text()
    assert seg == (tmp_path / "jax.ctm").read_text()
    assert seg == (tmp_path / "whole.ctm").read_text()
    assert len(seg.splitlines()) > 100


def test_latency_metrics_equal_jax():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 50):
        lat = list(rng.normal(0.3, 0.1, n))
        sil, eos = list(rng.normal(0.5, 0.2, n // 2)), list(rng.normal(0.4, 0.1, n // 3))
        for fw in (None, 0.06):
            assert compute_latency_metrics(lat, sil, eos, fw) == jax_metrics(lat, sil, eos, fw)


def test_gt_ctm_to_val_to_measure_latency(workspace, tmp_path):  # noqa: F811
    """generate_gt_ctm -> val.py --dump_ctm --calculate_emission_latency
    --gt_ctm -> measure_latency, in both packages: the same CTMs and metrics
    (the random model's words seldom meet the transcripts', so these may
    count no word)."""
    gt = tmp_path / "gt.ctm"
    generate_gt_ctm.main(_gt_argv(workspace, "manifest.json", gt, "--cpu"))
    out = run_both(workspace, tmp_path, ["--dump_ctm", "--gt_ctm", str(gt),
                                         "--calculate_emission_latency"])
    (want, want_dir), (got, got_dir) = out["jax"], out["port"]
    assert (got_dir / "model.ctm").read_text() == (want_dir / "model.ctm").read_text()
    assert got.latency_metrics == want.latency_metrics
    argv = ["--gt_ctm", str(gt), "--model_ctm", str(got_dir / "model.ctm")]
    assert (measure_latency.main(measure_latency.parse_args(argv))
            == jax_ml.main(jax_ml.parse_args(argv)))


def test_measure_latency_equals_jax_and_val(workspace, tmp_path):  # noqa: F811
    """measure_latency on the workspace's ground truth (words the random
    model emits) against the model's CTM: JAX's metrics, and the mean and
    median emission latency that val.py reports itself; the plot written,
    and refused under another extension than .png."""
    root, _ = workspace
    out = run_both(workspace, tmp_path, ["--dump_ctm", "--gt_ctm", str(root / "gt.ctm"),
                                         "--calculate_emission_latency"])
    got, got_dir = out["port"]
    assert got.latency_metrics["n"] > 0
    frame_width = 0.01 * 3 * 2  # window stride x frame subsampling x stack time
    argv = ["--gt_ctm", str(root / "gt.ctm"), "--model_ctm", str(got_dir / "model.ctm"),
            "--frame_width", str(frame_width)]
    metrics = measure_latency.main(measure_latency.parse_args(
        argv + ["--output_img_path", str(tmp_path / "lat.png")]))
    assert metrics == jax_ml.main(jax_ml.parse_args(argv))
    assert (tmp_path / "lat.png").stat().st_size > 0
    assert metrics["mean-emission-latency"] == pytest.approx(got.latency_metrics["mean"],
                                                             abs=1e-12)
    assert metrics["median-emission-latency"] == pytest.approx(got.latency_metrics["median"],
                                                               abs=1e-12)
    with pytest.raises(ValueError, match="png"):
        measure_latency.main(measure_latency.parse_args(
            argv + ["--output_img_path", str(tmp_path / "lat.jpg")]))


def test_val_multiple_equals_jax(workspace, tmp_path):  # noqa: F811
    """Two checkpoints (--ckpt_glob) x two manifests, --calc_loss, in both
    packages: the same labels, WERs and CSV WER row; losses within 1e-5; a
    row equals a separate val.validate run; the overwrite gate."""
    from caiman_asr_tpu import val_multiple as jax_vm
    from caiman_asr_tpu_torch import val_multiple
    from caiman_asr_tpu_torch.val import val_arg_parser, validate

    root, configs = workspace
    entries = json.loads((root / "manifest.json").read_text())
    (root / "half.json").write_text(json.dumps(entries[::2]))
    base = ["--model_config", str(configs["mini"]), "--ckpt_glob", str(root / "ckpt*.npz"),
            "--all_dataset_dirs", str(root), str(root),
            "--all_val_manifests", "manifest.json", "half.json",
            "--custom_batch_sizes", "4", "3", "--calc_loss"]
    want = jax_vm.main(base + ["--output_dir", str(tmp_path / "jax")])
    got = val_multiple.main(base + ["--output_dir", str(tmp_path / "port"), "--cpu"])
    assert list(got) == list(want) and len(got) == 4
    for label in want:
        assert got[label]["wer"] == want[label]["wer"]
        np.testing.assert_allclose(got[label]["loss"], want[label]["loss"], rtol=LOSS_RTOL)
    pj, pp = (json.loads((tmp_path / d / "validate_multiple.json").read_text())
              for d in ("jax", "port"))
    assert {k for k in pp if k != "args"} == {k for k in pj if k != "args"}
    rows = {d: list(csv.reader((tmp_path / d / "validate_multiple.csv").open()))
            for d in ("jax", "port")}
    assert rows["port"][:2] == rows["jax"][:2]  # the header and the WER row
    for a, b in zip(rows["port"][2][1:], rows["jax"][2][1:]):
        np.testing.assert_allclose(float(a), float(b), atol=1e-4)

    # a row against one val.validate run of the same checkpoint and manifest
    label = next(k for k in got if k.endswith("half.json") and "ckpt_eos" in k)
    args = val_arg_parser().parse_args([
        "--model_config", str(configs["mini"]), "--ckpt", str(root / "ckpt_eos.npz"),
        "--dataset_dir", str(root), "--val_manifests", "half.json", "--val_batch_size", "3",
        "--calc_loss", "--cpu", "--output_dir", str(tmp_path / "one")])
    one = validate(args)
    assert got[label]["wer"] == one.wer and got[label]["loss"] == one.loss

    with pytest.raises(ValueError, match="overwrite"):
        val_multiple.main(base + ["--output_dir", str(tmp_path / "port"), "--cpu"])
