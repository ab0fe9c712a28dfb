"""Dataset log-mel statistics (melmeans, melvars) for the blended
normalisation (the port of ``caiman_asr_tpu/data/generate_mel_stats.py``;
reference data/generate_mel_stats.py).

Run:  python -m caiman_asr_tpu_torch.data.generate_mel_stats \
        --model_config configs/base-8703sp.yaml --dataset_dir DATA \
        --manifests train.json --output_path DATA/mel_stats.npz

The log-mels are computed by the port's ``LogMelFrontend`` on the card
(``main(argv, device="cpu")`` on the CPU), the sums kept in float64 on the
host. The audio comes from JSON manifests or, with ``--read_from_tar``,
from webdataset tar or zip shards (``--tar_files``, beneath
``--dataset_dir`` where relative).
"""

from __future__ import annotations

import argparse
from itertools import islice

import numpy as np
import torch

from caiman_asr_tpu_torch.data.audio import read_audio
from caiman_asr_tpu_torch.models.config import load_config
from caiman_asr_tpu_torch.ops.logmel import LogMelFrontend


def compute_mel_stats(frontend: LogMelFrontend, audio_iter, batch_size: int = 32):
    """Per-mel-bin mean and variance over every valid frame of the audio
    clips of ``audio_iter``, featurised ``batch_size`` at a time (sums and
    sums of squares in float64). Returns float32 (means, variances), the
    variances floored at 1e-10."""
    n_mels = frontend.config.n_mels
    total = np.zeros(n_mels, np.float64)
    total_sq = np.zeros(n_mels, np.float64)
    count = 0
    batch = []

    def flush():
        nonlocal total, total_sq, count
        if not batch:
            return
        S = max(len(a) for a in batch)
        audio = np.zeros((len(batch), S), np.float32)
        for i, a in enumerate(batch):
            audio[i, : len(a)] = a
        lens = torch.tensor([len(a) for a in batch], dtype=torch.int64)
        with torch.no_grad():
            feats, frame_lens = frontend(torch.from_numpy(audio), lens)
        feats = feats.double().cpu().numpy()  # [B, n_mels, T]
        for i, n in enumerate(frame_lens.cpu().tolist()):
            f = feats[i, :, :n]
            total += f.sum(axis=1)
            total_sq += (f ** 2).sum(axis=1)
            count += int(n)
        batch.clear()

    for a in audio_iter:
        batch.append(a)
        if len(batch) >= batch_size:
            flush()
    flush()
    means = total / max(count, 1)
    vars_ = total_sq / max(count, 1) - means ** 2
    return means.astype(np.float32), np.maximum(vars_, 1e-10).astype(np.float32)


def main(argv=None, *, device="cuda"):
    p = argparse.ArgumentParser(description="dataset log-mel stats")
    p.add_argument("--model_config", required=True)
    p.add_argument("--dataset_dir", default=".")
    p.add_argument("--manifests", nargs="+", default=[])
    p.add_argument("--read_from_tar", action="store_true")
    p.add_argument("--tar_files", nargs="+", default=[],
                   help="webdataset tar/zip shards (with --read_from_tar)")
    p.add_argument("--output_path", required=True)
    p.add_argument("--max_utts", type=int, default=None)
    p.add_argument("--batch_size", "--dump_mel_stats_batch_size", type=int,
                   default=32, help="featurizer batch size (reference "
                                    "args/norm_stats_generation.py:13)")
    args = p.parse_args(argv)

    from caiman_asr_tpu_torch.setup.builders import load_utterances

    pipe = load_config(args.model_config).input_val  # no augmentation
    frontend = LogMelFrontend(pipe.logmel, device=device)
    if args.read_from_tar:
        from caiman_asr_tpu_torch.data.webdataset import WebDatasetReader, shard_paths

        reader = WebDatasetReader(shard_paths(args.dataset_dir, args.tar_files),
                                  sample_rate=pipe.logmel.sample_rate)
        samples = (a for a, _txt, _key in reader._samples(0))
        audio_iter = islice(samples, args.max_utts) if args.max_utts else samples
        n_desc = "tar shards"
    elif args.manifests:
        utts = load_utterances(args.manifests, args.dataset_dir, pipe)
        if args.max_utts:
            utts = utts[: args.max_utts]
        audio_iter = (read_audio(u.fname, pipe.logmel.sample_rate) for u in utts)
        n_desc = f"{len(utts)} utts"
    else:
        raise SystemExit("pass --manifests or --read_from_tar --tar_files")
    means, vars_ = compute_mel_stats(frontend, audio_iter, args.batch_size)
    np.savez(args.output_path, melmeans=means, melvars=vars_)
    print(f"wrote {args.output_path}: {n_desc}, "
          f"mean[0]={means[0]:.3f} var[0]={vars_[0]:.3f}")


if __name__ == "__main__":
    main()
