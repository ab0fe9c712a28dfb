"""Real-time-paced file streaming (the port of
``caiman_asr_tpu/inference/file_streamer.py``; reference:
inference/benchmark/file_streamer.py:17-80): reads an audio file, converts
to S16LE mono 16 kHz, and yields fixed-duration chunks, optionally sleeping
to simulate a live microphone."""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np

from caiman_asr_tpu_torch.data.audio import read_audio


class FileStreamer:
    def __init__(
        self,
        path: str,
        chunk_seconds: float = 0.1,
        sample_rate: int = 16000,
        realtime: bool = True,
    ):
        self.audio = read_audio(path, sample_rate)
        self.chunk = int(chunk_seconds * sample_rate)
        self.chunk_seconds = chunk_seconds
        self.realtime = realtime

    def __iter__(self) -> Iterator[bytes]:
        start = time.monotonic()
        n_chunks = -(-len(self.audio) // self.chunk)
        for i in range(n_chunks):
            seg = self.audio[i * self.chunk : (i + 1) * self.chunk]
            pcm = (np.clip(seg, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
            if self.realtime:
                target = start + i * self.chunk_seconds
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            yield pcm

    @property
    def duration(self) -> float:
        return len(self.audio) / 16000.0
