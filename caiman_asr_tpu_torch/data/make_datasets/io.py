"""Dataset preparation helpers on local files (the port of
``caiman_asr_tpu/data/make_datasets/io.py`` without ``download_file``: the
port fetches nothing over the network)."""

from __future__ import annotations

import hashlib
import struct
import tarfile
import wave
from pathlib import Path


def md5_checksum(path: str | Path, expected: str) -> bool:
    h = hashlib.md5()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == expected


def extract_tar(path: str | Path, dest: str | Path):
    with tarfile.open(path) as tar:
        tar.extractall(dest)


def audio_duration(path: str | Path) -> float:
    """Duration in seconds from file headers (no full decode)."""
    path = Path(path)
    if path.suffix.lower() == ".flac":
        return flac_info(path)["duration"]
    if path.suffix.lower() == ".wav":
        with wave.open(str(path), "rb") as w:
            return w.getnframes() / w.getframerate()
    raise ValueError(f"cannot read duration of {path}")


def flac_info(path: str | Path) -> dict:
    """Parse STREAMINFO (first metadata block) without decoding."""
    with open(path, "rb") as fh:
        if fh.read(4) != b"fLaC":
            raise ValueError(f"{path} is not a FLAC file")
        hdr = fh.read(4)
        if (hdr[0] & 0x7F) != 0:
            raise ValueError("first metadata block must be STREAMINFO")
        si = fh.read(34)
    sr = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4)
    channels = ((si[12] >> 1) & 0x7) + 1
    bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1
    total = ((si[13] & 0x0F) << 32) | struct.unpack(">I", si[14:18])[0]
    return {
        "sample_rate": sr,
        "channels": channels,
        "bits_per_sample": bps,
        "total_samples": total,
        "duration": total / sr if sr else 0.0,
    }
