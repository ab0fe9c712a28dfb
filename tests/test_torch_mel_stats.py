"""The port's dataset mel statistics (``caiman_asr_tpu_torch/data/
generate_mel_stats.py``) against the JAX package's: ``main`` over the same
manifest writes the same ``.npz`` keys, the means and variances within
1e-5 relative (the two log-mel front ends round their fp32 products
differently). Dither is 0 in the config: the two draw it from different
generators."""

import json
import wave

import numpy as np
import pytest

MEL_RTOL = 1e-5

CONFIG = """
input_val:
  audio_dataset:
    sample_rate: 16000
  filterbank_features:
    sample_rate: 16000
    window_size: 0.025
    window_stride: 0.01
    n_fft: 512
    n_filt: {n_filt}
    dither: 0.0
  frame_splicing:
    frame_stacking: 3
    frame_subsampling: 3
"""


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("mel")
    rng = np.random.default_rng(2)
    entries = []
    for i in range(7):
        n = 3000 + 2100 * i
        t = np.arange(n) / 16000
        x = 0.3 * np.sin(2 * np.pi * (200 + 90 * i) * t) + 0.05 * rng.normal(size=n)
        with wave.open(str(root / f"u{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
        entries.append({"transcript": "x", "files": [{"fname": f"u{i}.wav", "duration": n / 16000}],
                        "original_duration": n / 16000})
    (root / "m.json").write_text(json.dumps(entries))
    return root


@pytest.mark.parametrize("n_filt, batch_size, max_utts", [(80, 32, None), (40, 3, None),
                                                          (80, 2, 5)])
def test_main_writes_what_jax_writes(dataset, tmp_path, n_filt, batch_size, max_utts):
    from caiman_asr_tpu.data.generate_mel_stats import main as jax_main
    from caiman_asr_tpu_torch.data.generate_mel_stats import main

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CONFIG.format(n_filt=n_filt))
    argv = ["--model_config", str(cfg), "--dataset_dir", str(dataset), "--manifests", "m.json",
            "--batch_size", str(batch_size)] + (["--max_utts", str(max_utts)] if max_utts else [])
    main(argv + ["--output_path", str(tmp_path / "port.npz")], device="cpu")
    jax_main(argv + ["--output_path", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files) == ["melmeans", "melvars"]
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == (n_filt,)
            np.testing.assert_allclose(got[k], want[k], rtol=MEL_RTOL, err_msg=k)


def test_the_webdataset_source_raises(dataset, tmp_path):
    """On a missing shard, as JAX's does (the shards themselves are read in
    tests/test_torch_data_tools.py)."""
    from caiman_asr_tpu.data.generate_mel_stats import main as jax_main
    from caiman_asr_tpu_torch.data.generate_mel_stats import main

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CONFIG.format(n_filt=80))
    argv = ["--model_config", str(cfg), "--read_from_tar", "--tar_files", "x.tar",
            "--dataset_dir", str(tmp_path), "--output_path", str(tmp_path / "o.npz")]
    with pytest.raises(FileNotFoundError):
        main(argv, device="cpu")
    with pytest.raises(FileNotFoundError):
        jax_main(argv)
