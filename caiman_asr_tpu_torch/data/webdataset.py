"""Tar and zip shards of ``{key}.flac|wav`` + ``{key}.txt`` pairs (the port
of ``caiman_asr_tpu/data/webdataset.py``).

Plain ``tarfile`` / ``zipfile`` streaming, no webdataset package: the
container is sniffed per file, not taken from the suffix; ``.flac`` goes
through the port's own decoder (``native``), ``.wav`` through ``wave``; a
seeded shuffle buffer; the train filters on duration and transcript length.
Over several processes each rank reads every ``num_shards``-th sample pair
from ``shard_id`` on, counted over the pairs of all the shards in order.
``WebDatasetLoader`` yields the ``Batch`` of ``data/loader.py``, so the
train and validation loops do not know the source.
"""

from __future__ import annotations

import io
import tarfile
import wave
import zipfile
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

from caiman_asr_tpu_torch.data.loader import Batch, quantise
from caiman_asr_tpu_torch.data.text.normalize import NormalizeConfig, normalize_transcript

AUDIO_EXTS = (".flac", ".wav")


class LengthUnknownError(Exception):
    """A tar stream's length is not known before it is read."""


def _decode_audio(name: str, data: bytes, target_sr: int) -> np.ndarray:
    from caiman_asr_tpu_torch.data.audio import resample

    if name.endswith(".flac"):
        from caiman_asr_tpu_torch.native import flac_decode

        samples, sr, bps, _ = flac_decode(data)
        audio = samples.astype(np.float32) / float(1 << (bps - 1))
        audio = audio.mean(axis=1) if audio.shape[1] > 1 else audio[:, 0]
    else:
        with wave.open(io.BytesIO(data), "rb") as w:
            sr = w.getframerate()
            raw = w.readframes(w.getnframes())
            audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
            if w.getnchannels() > 1:
                audio = audio.reshape(-1, w.getnchannels()).mean(axis=1)
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    return audio


class WebDatasetReader:
    """Iterates (audio, transcript, key) samples from tar or zip shards."""

    def __init__(
        self,
        tar_files: Sequence[str | Path],
        sample_rate: int = 16000,
        shuffle_buffer: int = 256,
        shard_id: int = 0,
        num_shards: int = 1,
        seed: int = 0,
        max_duration: Optional[float] = None,
        max_transcript_len: Optional[int] = None,
    ):
        self.tars = [Path(t) for t in tar_files]
        for t in self.tars:
            if not t.exists():
                raise FileNotFoundError(t)
        self.sr = sample_rate
        self.shuffle_buffer = shuffle_buffer
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.max_duration = max_duration
        self.max_transcript_len = max_transcript_len

    def __len__(self):
        raise LengthUnknownError("webdataset tar streams have unknown length")

    @staticmethod
    def _shard_members(path: Path) -> Iterator[tuple]:
        """(member name, bytes) pairs of one tar or zip shard, in order."""
        if zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as z:
                for info in z.infolist():
                    if not info.is_dir():
                        yield info.filename, z.read(info)
        else:
            with tarfile.open(path) as tar:
                for member in tar:
                    if member.isfile():
                        yield member.name, tar.extractfile(member).read()

    def _samples(self, epoch: int) -> Iterator[tuple]:
        """This shard's samples in file order. A pair counts toward the
        sharding whether or not a filter then drops it."""
        i = 0
        for tar_path in self.tars:
            pending: dict = {}
            for member_name, data in self._shard_members(tar_path):
                name = Path(member_name)
                key, ext = name.stem, name.suffix.lower()
                if ext not in AUDIO_EXTS and ext != ".txt":
                    continue
                entry = pending.setdefault(key, {})
                entry[ext] = data
                audio_ext = next((e for e in AUDIO_EXTS if e in entry), None)
                if not (audio_ext and ".txt" in entry):
                    continue
                del pending[key]
                mine = i % self.num_shards == self.shard_id
                i += 1
                if not mine:
                    continue
                text = entry[".txt"].decode("utf-8").strip()
                if self.max_transcript_len is not None and len(text) > self.max_transcript_len:
                    continue
                audio = _decode_audio(audio_ext, entry[audio_ext], self.sr)
                if self.max_duration is not None and len(audio) / self.sr > self.max_duration:
                    continue
                yield audio, text, key

    def shuffled(self, epoch: int) -> Iterator[tuple]:
        """The samples through a shuffle buffer seeded by ``(seed, epoch)``."""
        rng = np.random.default_rng((self.seed, epoch))
        buf: List[tuple] = []
        for s in self._samples(epoch):
            if len(buf) < self.shuffle_buffer:
                buf.append(s)
                continue
            j = int(rng.integers(len(buf)))
            yield buf[j]
            buf[j] = s
        rng.shuffle(buf)
        yield from buf


def make_padded_batch(group: List[tuple], tokenizer, norm_cfg: NormalizeConfig, charset,
                      sample_quantum: int, token_quantum: int) -> Batch:
    """(audio, text, key) samples as a ``Batch`` of quantised shape."""
    audios = [g[0] for g in group]
    texts = [normalize_transcript(g[1], charset, norm_cfg) for g in group]
    tokens = [tokenizer.tokenize(t) for t in texts]
    B = len(group)
    max_s = quantise(max(len(a) for a in audios), sample_quantum, sample_quantum)
    max_u = quantise(max(max(len(t) for t in tokens), 1), token_quantum, token_quantum)
    audio = np.zeros((B, max_s), np.float32)
    audio_lens = np.zeros(B, np.int32)
    toks = np.zeros((B, max_u), np.int32)
    tok_lens = np.zeros(B, np.int32)
    for i, (a, t) in enumerate(zip(audios, tokens)):
        audio[i, : len(a)] = a[:max_s]
        audio_lens[i] = min(len(a), max_s)
        toks[i, : len(t)] = t[:max_u]
        tok_lens[i] = min(len(t), max_u)
    return Batch(audio=audio, audio_lens=audio_lens, tokens=toks, token_lens=tok_lens,
                 transcripts=[g[1] for g in group], fnames=[g[2] for g in group])


class WebDatasetLoader:
    """Batches of ``batch_size`` samples over a reader, with the manifest
    loader's interface. The only host random stream its batches draw from
    is the tokenizer's subword sampling (``host_rng_state``)."""

    def __init__(
        self,
        reader: WebDatasetReader,
        tokenizer,
        batch_size: int,
        normalize_config: Optional[NormalizeConfig] = None,
        sample_quantum_secs: float = 2.0,
        token_quantum: int = 32,
        charset: Optional[list] = None,
        drop_last: bool = False,
    ):
        self.drop_last = drop_last
        self.reader = reader
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.norm_cfg = normalize_config or NormalizeConfig()
        self.sr = reader.sr
        self.sample_quantum = int(sample_quantum_secs * self.sr)
        self.token_quantum = token_quantum
        self.charset = charset if charset is not None else tokenizer.charset

    def _host_rngs(self) -> List[np.random.Generator]:
        tok_rng = getattr(self.tokenizer, "_rng", None)
        return [tok_rng] if tok_rng is not None else []

    def host_rng_state(self) -> list:
        return [r.bit_generator.state for r in self._host_rngs()]

    def set_host_rng_state(self, states: list) -> None:
        rngs = self._host_rngs()
        if len(states) != len(rngs):
            raise ValueError(f"{len(states)} host random states for {len(rngs)} streams")
        for rng, state in zip(rngs, states):
            rng.bit_generator.state = state

    def _batch(self, group: List[tuple]) -> Batch:
        batch = make_padded_batch(group, self.tokenizer, self.norm_cfg, self.charset,
                                  self.sample_quantum, self.token_quantum)
        batch.host_rng = self.host_rng_state()
        return batch

    def epoch(self, epoch: int, resume_step: int = 0) -> Iterator[Batch]:
        """This shard's batches of ``epoch``, the first ``resume_step``
        skipped (neither tokenised nor padded)."""
        group: List[tuple] = []
        skipped = 0
        for sample in self.reader.shuffled(epoch):
            group.append(sample)
            if len(group) == self.batch_size:
                if skipped < resume_step:
                    skipped += 1
                else:
                    yield self._batch(group)
                group = []
        if group and not self.drop_last and skipped >= resume_step:  # the tail batch
            yield self._batch(group)


def shard_paths(dataset_dir, names) -> List[str]:
    """Shard names as paths, beneath ``dataset_dir`` where relative."""
    return [str(Path(n) if Path(n).is_absolute() else Path(dataset_dir) / n) for n in names]


def read_shard_transcripts(tar_files) -> list:
    """Every transcript of tar or zip shards, without decoding audio (for
    tokenizer and n-gram training)."""
    out = []
    for path in tar_files:
        for name, data in WebDatasetReader._shard_members(Path(path)):
            if name.lower().endswith(".txt"):
                out.append(data.decode("utf-8").strip())
    return out
