"""JSON manifest parsing and filtering (the port of
``caiman_asr_tpu/data/manifest.py``).

Reference: data/dali/utils.py + data/dali/data_loader.py:137-255. Manifest
format: a JSON list of entries
  {"transcript": str, "files": [{"fname": ...}], "original_duration": float}.
"""

from __future__ import annotations

import json
import struct
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence


@dataclass
class Utterance:
    fname: str
    transcript: str
    duration: float
    manifest_idx: int = 0


def load_manifest(
    path: str | Path,
    data_dir: Optional[str | Path] = None,
    max_duration: Optional[float] = None,
    min_duration: Optional[float] = None,
    max_transcript_len: Optional[int] = None,
    manifest_idx: int = 0,
) -> List[Utterance]:
    """Load one manifest, applying the reference's utterance filters
    (max/min duration, max transcript length; data_loader.py:94-110)."""
    with open(path) as f:
        entries = json.load(f)
    root = Path(data_dir) if data_dir is not None else Path(path).parent
    out = []
    for e in entries:
        dur = float(e.get("original_duration") or e["files"][0].get("duration", 0.0))
        txt = e["transcript"]
        if max_duration is not None and dur > max_duration:
            continue
        if min_duration is not None and dur < min_duration:
            continue
        if max_transcript_len is not None and len(txt) > max_transcript_len:
            continue
        fname = e["files"][0]["fname"]
        out.append(
            Utterance(
                fname=str(root / fname),
                transcript=txt,
                duration=dur,
                manifest_idx=manifest_idx,
            )
        )
    return out


def load_manifests(paths: Sequence[str | Path], **kw) -> List[Utterance]:
    utts: List[Utterance] = []
    for i, p in enumerate(paths):
        utts.extend(load_manifest(p, manifest_idx=i, **kw))
    return utts


AUDIO_SUFFIXES = (".flac", ".wav")


def utterances_from_dir(
    audio_dir: str | Path, txt_dir: Optional[str | Path] = None
) -> List[Utterance]:
    """Build utterances from a directory of audio files paired with
    ``{stem}.txt`` transcripts (reference --val_from_dir /
    docs/src/training/directory_of_audio_format.md; txt_dir defaults to
    audio_dir). Files without a transcript are skipped with a warning."""
    import warnings

    audio_dir = Path(audio_dir)
    txt_root = Path(txt_dir) if txt_dir is not None else audio_dir
    out: List[Utterance] = []
    for p in sorted(audio_dir.rglob("*")):
        if p.suffix.lower() not in AUDIO_SUFFIXES:
            continue
        txt = txt_root / p.relative_to(audio_dir).with_suffix(".txt")
        if not txt.exists():
            warnings.warn(f"no transcript for {p} (expected {txt}); skipped")
            continue
        out.append(
            Utterance(
                fname=str(p),
                transcript=txt.read_text().strip(),
                duration=audio_duration(p),
            )
        )
    if not out:
        raise ValueError(f"no audio+transcript pairs under {audio_dir}")
    return out


def audio_duration(path: str | Path) -> float:
    """Duration in seconds from file headers, no full decode (the port's
    copy of ``caiman_asr_tpu/data/make_datasets/io.py:36-66``)."""
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
