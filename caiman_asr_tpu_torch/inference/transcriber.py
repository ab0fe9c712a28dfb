"""WebSocket streaming transcriber client (the port of
``caiman_asr_tpu/inference/transcriber.py``; reference:
inference/benchmark/transcriber.py). Streams a file (real-time paced) and
collects timestamped responses for WER/latency measurement.

``stream_file`` is the send/receive loop over a connection that is already
open; ``transcribe_file`` opens a WebSocket (``websockets``, imported only
there) and runs it. Messages and timing are the JAX module's.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import List

from caiman_asr_tpu_torch.inference.file_streamer import FileStreamer

SUBPROTOCOL = "stream.asr.api.myrtle.ai"
QUERY = "content_type=audio/x-raw;format=S16LE;channels=1;rate=16000"


@dataclass
class TimedResponse:
    recv_time: float  # seconds since stream start
    response: dict


@dataclass
class TranscriptionResult:
    fname: str
    duration: float
    responses: List[TimedResponse] = field(default_factory=list)

    @property
    def transcript(self) -> str:
        parts = []
        for tr in self.responses:
            r = tr.response
            if not r.get("is_provisional", False) and r.get("alternatives"):
                parts.append(r["alternatives"][0]["transcript"])
        return "".join(parts).strip()

    def finals_latencies(self) -> List[float]:
        """recv wall time minus audio-end time per final response; only
        meaningful when streamed in real time."""
        out = []
        for tr in self.responses:
            r = tr.response
            if not r.get("is_provisional", False):
                out.append(tr.recv_time - float(r["end"]))
        return out


async def stream_file(ws, streamer: FileStreamer, result: TranscriptionResult
                      ) -> TranscriptionResult:
    """Send the streamer's chunks and then EOS (an empty binary frame) over
    the open connection ``ws`` (``send`` and async iteration over the text
    frames it receives), appending each received response to ``result``
    with its arrival time since the start, until the server closes."""
    start = time.monotonic()

    async def send():
        loop = asyncio.get_event_loop()
        it = iter(streamer)
        while True:
            chunk = await loop.run_in_executor(None, lambda: next(it, None))
            if chunk is None:
                break
            await ws.send(chunk)
        await ws.send(b"")  # EOS

    send_task = asyncio.create_task(send())
    try:
        async for message in ws:
            result.responses.append(TimedResponse(time.monotonic() - start, json.loads(message)))
    finally:
        await send_task
    return result


async def transcribe_file(
    uri: str,
    path: str,
    chunk_seconds: float = 0.1,
    realtime: bool = True,
    retries: int = 3,
) -> TranscriptionResult:
    import websockets.asyncio.client

    streamer = FileStreamer(path, chunk_seconds, realtime=realtime)
    result = TranscriptionResult(fname=path, duration=streamer.duration)
    full_uri = f"{uri}?{QUERY}"
    last_err = None
    for _ in range(retries):
        try:
            async with websockets.asyncio.client.connect(
                full_uri, subprotocols=[SUBPROTOCOL]
            ) as ws:
                return await stream_file(ws, streamer, result)
        except Exception as e:  # retry transient failures
            last_err = e
            await asyncio.sleep(0.5)
    raise ConnectionError(f"failed to transcribe {path}: {last_err}")
