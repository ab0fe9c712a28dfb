"""Live demo client (the port of ``caiman_asr_tpu/inference/live_client.py``;
reference: inference/live_demo_client/): microphone or wav file ->
WebSocket -> terminal partial/final rendering.

Finals render green and persist; the current partial renders red and is
revised in place, with word-level wrapping (term_stack.py). Microphone
capture needs pyaudio (not bundled); ``--wav`` streams a file in real
time with no extra dependencies.

Run: python -m caiman_asr_tpu_torch.inference.live_client \
       --uri ws://host:port/asr/v0.1/stream [--wav audio.wav]
"""

from __future__ import annotations

import argparse
import asyncio
import json

from caiman_asr_tpu_torch.inference.term_stack import Style, TermStack
from caiman_asr_tpu_torch.inference.transcriber import QUERY, SUBPROTOCOL

CHUNK_SECONDS = 0.1
RATE = 16000


class TranscriptView:
    """Partial/final update policy over the terminal stack (reference
    live_demo_client/live_client.py message loop)."""

    def __init__(self, cols: int = 80, out=None):
        self.stack = TermStack(cols=cols, out=out)
        self._have_partial = False

    def update(self, response: dict):
        alts = response.get("alternatives") or []
        text = alts[0]["transcript"] if alts else ""
        if self._have_partial:
            self.stack.pop()
            self._have_partial = False
        if response.get("is_provisional"):
            self.stack.push(text, Style.PARTIAL)
            self._have_partial = True
        elif text:
            self.stack.push(text, Style.FINAL)


async def _mic_chunks():
    try:
        import pyaudio
    except ImportError:
        raise SystemExit(
            "pyaudio is required for microphone capture "
            "(pip install pyaudio), or stream a file with --wav"
        )
    pa = pyaudio.PyAudio()
    stream = pa.open(
        format=pyaudio.paInt16, channels=1, rate=RATE, input=True,
        frames_per_buffer=int(RATE * CHUNK_SECONDS),
    )
    loop = asyncio.get_event_loop()
    try:
        while True:
            yield await loop.run_in_executor(
                None, stream.read, int(RATE * CHUNK_SECONDS)
            )
    finally:
        stream.close()
        pa.terminate()


async def _wav_chunks(path: str):
    """Real-time-paced int16 chunks from a wav file."""
    import wave

    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: expected 16-bit mono wav")
        n = int(w.getframerate() * CHUNK_SECONDS)
        while True:
            data = w.readframes(n)
            if not data:
                return
            yield data
            await asyncio.sleep(CHUNK_SECONDS)


async def run(uri: str, wav: str | None = None):
    import websockets.asyncio.client

    view = TranscriptView()
    source = _wav_chunks(wav) if wav else _mic_chunks()
    async with websockets.asyncio.client.connect(
        f"{uri}?{QUERY}", subprotocols=[SUBPROTOCOL]
    ) as ws:

        async def send():
            async for data in source:
                await ws.send(data)
            await ws.send(b"")  # EOS for file input

        send_task = asyncio.create_task(send())
        try:
            async for message in ws:
                r = json.loads(message)
                if r.get("eos"):
                    break
                view.update(r)
        finally:
            send_task.cancel()
    print()


def main(argv=None):
    p = argparse.ArgumentParser(description="live transcription demo")
    p.add_argument("--uri", default="ws://localhost:8765/asr/v0.1/stream")
    p.add_argument("--wav", default=None, help="stream a wav file instead of the mic")
    args = p.parse_args(argv)
    asyncio.run(run(args.uri, args.wav))


if __name__ == "__main__":
    main()
