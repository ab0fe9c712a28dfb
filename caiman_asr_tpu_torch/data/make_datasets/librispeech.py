"""LibriSpeech manifest preparation on local files (the port of
``caiman_asr_tpu/data/make_datasets/librispeech.py``).

Parses the ``*.trans.txt`` transcripts of an extracted subset under
``<data_dir>/LibriSpeech/<subset>`` and writes a JSON manifest in the
framework's format: one entry per utterance with ``transcript``,
``files: [{fname, duration}]``, ``original_duration`` and
``original_num_samples``. Where the extracted tree is missing, the subset's
archive ``<data_dir>/<subset>.tar.gz`` is checked against its MD5 and
extracted; the port downloads nothing, so without either it raises.
``--convert_to_wav`` decodes each FLAC file with the port's native decoder.

Run: python -m caiman_asr_tpu_torch.data.make_datasets.librispeech \\
       --data_dir /datasets/LibriSpeech --subsets dev-clean test-clean \\
       --skip_download_data
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

from caiman_asr_tpu_torch.data.make_datasets.io import audio_duration, extract_tar, md5_checksum

URL_BASE = "https://www.openslr.org/resources/12"

MD5 = {
    "dev-clean": "42e2234ba48799c1f50f24a7926300a1",
    "dev-other": "c8d0bcc9cca99d4f8b62fcc847357931",
    "test-clean": "32fa31d27d2e1cad72775fee3f4849a9",
    "test-other": "fb5a50374b501bb3bac4815ee91d3135",
    "train-clean-100": "2a93770f6d5c6c964bc36631d331a522",
    "train-clean-360": "c0e676e450a7ff2f54aeade5171606fa",
    "train-other-500": "d1a0fd59409feb2c614ce4d30c387708",
}


def parse_trans_file(path: Path) -> Dict[str, str]:
    """``<utt-id> <TRANSCRIPT>`` lines -> {utt-id: transcript}."""
    out = {}
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        utt_id, _, text = line.partition(" ")
        out[utt_id] = text.strip().lower()
    return out


def _flac_to_wav(flac: Path) -> Path:
    """Decode a FLAC file (native decoder) and write it as 16-bit WAV."""
    import wave

    from caiman_asr_tpu_torch.data.audio import read_audio

    pcm = read_audio(flac)
    wav = flac.with_suffix(".wav")
    with wave.open(str(wav), "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(16000)
        fh.writeframes((pcm * 32767.0).clip(-32768, 32767).astype("<i2").tobytes())
    return wav


def prepare_manifest(
    subset_dir: Path,
    data_dir: Path,
    use_relative_path: bool = True,
    num_jobs: int = 1,
    convert_to_wav: bool = False,
) -> List[dict]:
    jobs = []
    for trans in sorted(subset_dir.rglob("*.trans.txt")):
        transcripts = parse_trans_file(trans)
        for utt_id, text in sorted(transcripts.items()):
            audio = trans.parent / f"{utt_id}.flac"
            if not audio.exists():
                continue
            jobs.append((audio, text))

    def one(job):
        audio, text = job
        if convert_to_wav:
            audio = _flac_to_wav(audio)
        dur = audio_duration(audio)
        fname = str(audio.relative_to(data_dir)) if use_relative_path else str(audio)
        return {
            "transcript": text,
            "files": [{"fname": fname, "duration": dur}],
            "original_duration": dur,
            "original_num_samples": int(dur * 16000),
        }

    if num_jobs > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(num_jobs) as pool:
            return list(pool.map(one, jobs))
    return [one(j) for j in jobs]


def prepare_subset(
    data_dir: Path,
    subset: str,
    skip_download: bool = False,
    source_url: str = URL_BASE,
    force_download: bool = False,
    use_relative_path: bool = True,
    num_jobs: int = 1,
    skip_prepare_manifests: bool = False,
    convert_to_wav: bool = False,
) -> Path:
    """The subset's manifest path, written unless ``skip_prepare_manifests``.
    ``source_url`` names where the archive comes from; the port reads it
    only from ``data_dir``."""
    extracted = data_dir / "LibriSpeech" / subset
    if (force_download or not extracted.exists()) and not skip_download:
        tar = data_dir / f"{subset}.tar.gz"
        if not tar.exists():
            raise FileNotFoundError(
                f"{tar} not found: fetch {source_url.rstrip('/')}/{subset}.tar.gz into "
                f"{data_dir} (this tool downloads nothing), or pass --skip_download_data "
                "with the extracted tree in place")
        if subset in MD5 and not md5_checksum(tar, MD5[subset]):
            raise RuntimeError(f"MD5 mismatch for {tar}")
        extract_tar(tar, data_dir)
    if not extracted.exists():
        raise FileNotFoundError(f"{extracted} not found")
    suffix = "wav" if convert_to_wav else "flac"
    manifest = data_dir / f"librispeech-{subset}-{suffix}.json"
    if skip_prepare_manifests:
        return manifest
    entries = prepare_manifest(extracted, data_dir, use_relative_path, num_jobs, convert_to_wav)
    if not entries:
        raise RuntimeError(f"no utterances found under {extracted}")
    manifest.write_text(json.dumps(entries, indent=1))
    print(f"wrote {manifest} ({len(entries)} utterances)")
    return manifest


def main(argv=None):
    p = argparse.ArgumentParser(description="LibriSpeech preparation")
    p.add_argument("--data_dir", required=True,
                   help="Directory to save data and manifests")
    p.add_argument("--dataset_parts", "--subsets", dest="subsets",
                   nargs="+", default=["dev-clean"], choices=sorted(MD5),
                   help="Dataset parts to prepare")
    p.add_argument("--source_url", default=URL_BASE,
                   help="Where the archives come from (named in the error when one is "
                        "missing; nothing is downloaded)")
    p.add_argument("--force_download", action="store_true",
                   help="Extract the archive under --data_dir even if the tree exists")
    p.add_argument("--num_jobs", "--num_jobs_manifest_preparation",
                   dest="num_jobs", type=int, default=8,
                   help="Parallel jobs for manifest preparation")
    p.add_argument("--use_relative_path", action="store_true", default=True,
                   help="Use relative audio paths in manifests (default)")
    p.add_argument("--use_absolute_path", dest="use_relative_path",
                   action="store_false",
                   help="Use absolute audio paths in manifests")
    p.add_argument("--skip_download_data", "--skip_download",
                   dest="skip_download", action="store_true",
                   help="only build manifests from already-extracted data")
    p.add_argument("--skip_prepare_manifests", action="store_true",
                   help="Skip preparing manifests; only extract")
    p.add_argument("--convert_to_wav", action="store_true",
                   help="Convert audio from FLAC to WAV")
    args = p.parse_args(argv)
    for subset in args.subsets:
        prepare_subset(
            Path(args.data_dir),
            subset,
            skip_download=args.skip_download,
            source_url=args.source_url,
            force_download=args.force_download,
            use_relative_path=args.use_relative_path,
            num_jobs=args.num_jobs,
            skip_prepare_manifests=args.skip_prepare_manifests,
            convert_to_wav=args.convert_to_wav,
        )


if __name__ == "__main__":
    main()
