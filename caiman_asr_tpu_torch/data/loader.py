"""Host data loader (the port of ``caiman_asr_tpu/data/loader.py:39-236``).

Decodes, trims and augments audio on a thread pool, tokenises through a
cache, and pads each batch to quantised (samples, tokens) shapes, a small
fixed set the device path sees again and again. Everything here is numpy
on the host, with the JAX package's ``np.random.default_rng`` seeds, so a
batch is the JAX loader's bit for bit; the caller moves it to the device.
``FeaturePipeline`` (the device half) lives in ``data/featurize.py`` and is
re-exported here under the JAX package's name.
"""

from __future__ import annotations

import concurrent.futures as cf
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from caiman_asr_tpu_torch.data.audio import read_audio, speed_perturb, trim_silence
from caiman_asr_tpu_torch.data.featurize import FeaturePipeline  # noqa: F401
from caiman_asr_tpu_torch.data.manifest import Utterance
from caiman_asr_tpu_torch.data.sampler import Sampler
from caiman_asr_tpu_torch.data.text.normalize import NormalizeConfig, normalize_transcript
from caiman_asr_tpu_torch.data.tokenizer import Tokenizer
from caiman_asr_tpu_torch.models.config import PipelineConfig


def quantise(n: int, step: int, minimum: int) -> int:
    return max(minimum, -(-n // step) * step)


@dataclass
class Batch:
    audio: np.ndarray        # [B, S] float32
    audio_lens: np.ndarray   # [B] int32
    tokens: np.ndarray       # [B, U] int32
    token_lens: np.ndarray   # [B] int32
    transcripts: List[str]
    fnames: List[str]
    # the host random streams' states after this batch was made
    # (AudioDataLoader.host_rng_state): a resumed run restores them
    host_rng: Optional[list] = None


class AudioDataLoader:
    """Iterates epochs of padded batches for one data-parallel rank."""

    def __init__(
        self,
        utterances: Sequence[Utterance],
        sampler: Sampler,
        tokenizer: Tokenizer,
        pipeline: PipelineConfig,
        rank: int = 0,
        train: bool = True,
        normalize_config: Optional[NormalizeConfig] = None,
        num_workers: int = 8,
        seed: int = 0,
        sample_quantum_secs: float = 2.0,
        token_quantum: int = 32,
        prefetch: int = 2,
        background_noise=None,   # (NoiseDataset, NoiseSampler)
        babble_noise=None,       # NoiseSampler
        prob_narrowband: float = 0.0,
        inspect_audio_dir=None,
    ):
        self.utts = list(utterances)
        self.sampler = sampler
        self.tokenizer = tokenizer
        self.pipe = pipeline
        self.rank = rank
        self.train = train
        self.norm_cfg = normalize_config or NormalizeConfig()
        self.rng = np.random.default_rng((seed, rank))
        self.sr = pipeline.logmel.sample_rate
        self.sample_quantum = int(sample_quantum_secs * self.sr)
        self.token_quantum = token_quantum
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.background_noise = background_noise
        self.babble_noise = babble_noise
        self.prob_narrowband = prob_narrowband
        self.inspect_audio_dir = inspect_audio_dir
        # the noise's SNR schedule (data/noise.NoiseSchedule, set by the
        # trainer): a batch made for a step takes that step's SNR ranges
        self.noise_schedule = None
        self._inspect_n = 0
        self._token_cache: Dict[int, List[int]] = {}
        max_dur = pipeline.dataset.max_duration or max(
            (u.duration for u in self.utts), default=1.0
        )
        if train and pipeline.dataset.speed_perturbation:
            max_dur = max_dur / pipeline.dataset.speed_perturbation.get("min_rate", 1.0)
        self.max_samples = quantise(
            int(max_dur * self.sr) + 1, self.sample_quantum, self.sample_quantum
        )
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers)

    def __len__(self):
        return len(self.utts)

    def steps_per_epoch(self, epoch: int = 0) -> int:
        return len(self.sampler.epoch_batches(epoch))

    def _tokens(self, idx: int) -> List[int]:
        # Sub-token sampling must resample every epoch when enabled; cache
        # only when sampling is off (the reference caches post-normalization
        # text and re-tokenizes, iterator.py:50-55 + token_cache.py).
        if self.tokenizer.sampling > 0.0 and self.train:
            text = normalize_transcript(
                self.utts[idx].transcript, self.tokenizer.charset, self.norm_cfg
            )
            return self.tokenizer.tokenize(text)
        if idx not in self._token_cache:
            text = normalize_transcript(
                self.utts[idx].transcript, self.tokenizer.charset, self.norm_cfg
            )
            self._token_cache[idx] = self.tokenizer.tokenize(text)
        return self._token_cache[idx]

    def _host_rngs(self) -> List[np.random.Generator]:
        """The host random streams a training batch draws from, in a fixed
        order: the loader's, the background-noise and babble samplers' (one
        object when ``setup/builders.build_noise`` made both) and the
        tokenizer's subword sampling."""
        rngs = [self.rng]
        if self.background_noise is not None:
            rngs.append(self.background_noise[1].rng)
        if self.babble_noise is not None:
            rngs.append(self.babble_noise.rng)
        tok_rng = getattr(self.tokenizer, "_rng", None)
        if tok_rng is not None:
            rngs.append(tok_rng)
        return rngs

    def host_rng_state(self) -> list:
        """The states of ``_host_rngs`` (JSON-serialisable dicts)."""
        return [r.bit_generator.state for r in self._host_rngs()]

    def set_host_rng_state(self, states: list) -> None:
        """Restore states taken by ``host_rng_state``, so that the next
        batch draws what it would have drawn in the run that took them."""
        rngs = self._host_rngs()
        if len(states) != len(rngs):
            raise ValueError(f"{len(states)} host random states for {len(rngs)} streams")
        for rng, state in zip(rngs, states):
            rng.bit_generator.state = state

    def _load_one(self, idx: int, rng: np.random.Generator):
        u = self.utts[idx]
        audio = read_audio(u.fname, self.sr)
        if self.train and self.pipe.dataset.trim_silence:
            audio = trim_silence(audio)
        sp = self.pipe.dataset.speed_perturbation
        if self.train and sp:
            if rng.random() < sp.get("p", 1.0):
                rate = rng.uniform(sp.get("min_rate", 0.85), sp.get("max_rate", 1.15))
                audio = speed_perturb(audio, rate)
        # 8 kHz resimulation applies in train AND val (reference exposes
        # --prob_train_narrowband / --prob_val_narrowband separately;
        # build_dataloader.py:63-81 routes each into its pipeline)
        if self.prob_narrowband > 0.0 and rng.random() < self.prob_narrowband:
            from caiman_asr_tpu_torch.data.audio import narrowband_resim

            audio = narrowband_resim(audio, self.sr)
        return audio

    def make_batch(self, idxs: Sequence[int], step: Optional[int] = None) -> Batch:
        """The batch of utterances ``idxs``; with ``step`` and a noise
        schedule, its noise at that step's SNR ranges."""
        if step is not None and self.noise_schedule is not None:
            # set here, where batches are made one at a time in order, so
            # that the ranges a batch takes do not hang on when the trainer
            # gets to it (batches are made ahead)
            self.noise_schedule.adjust_snrs(step)
        rngs = [
            np.random.default_rng((int(self.rng.integers(2**31)), i))
            for i in range(len(idxs))
        ]
        audios = list(self._pool.map(self._load_one, idxs, rngs))
        if self.train and self.background_noise is not None:
            # background noise at per-sample scheduled SNRs
            # (reference data/dali/noise.py blend + iterator)
            from caiman_asr_tpu_torch.data.audio import blend_noise

            ds, sampler = self.background_noise
            for i in range(len(audios)):
                snr, start = sampler.draw()
                if snr < 100.0:
                    audios[i] = blend_noise(
                        rngs[i], audios[i], ds.get(rngs[i]), snr, start
                    )
        if self.train and self.babble_noise is not None and len(audios) > 1:
            from caiman_asr_tpu_torch.data.audio import blend_noise

            for i in range(len(audios)):
                snr, start = self.babble_noise.draw()
                if snr < 100.0:
                    others = [j for j in range(len(audios)) if j != i]
                    j = others[int(rngs[i].integers(len(others)))]
                    audios[i] = blend_noise(rngs[i], audios[i], audios[j], snr, start)
        if self.inspect_audio_dir is not None:
            # debug dump of the fully augmented host-side audio (reference
            # --inspect_audio, dali/pipeline.py:142-147 save_audio)
            import wave as _wave
            from pathlib import Path as _Path

            d = _Path(self.inspect_audio_dir)
            d.mkdir(parents=True, exist_ok=True)
            for a in audios:
                with _wave.open(str(d / f"augmented_{self._inspect_n:06d}.wav"),
                                "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(int(self.sr))
                    w.writeframes(
                        (np.clip(a, -1, 1) * 32767).astype(np.int16).tobytes()
                    )
                self._inspect_n += 1
        tokens = [self._tokens(i) for i in idxs]

        max_s = quantise(
            max(len(a) for a in audios), self.sample_quantum, self.sample_quantum
        )
        max_s = min(max_s, self.max_samples)
        max_u = quantise(
            max(max(len(t) for t in tokens), 1), self.token_quantum, self.token_quantum
        )
        B = len(idxs)
        audio = np.zeros((B, max_s), np.float32)
        audio_lens = np.zeros(B, np.int32)
        toks = np.zeros((B, max_u), np.int32)
        tok_lens = np.zeros(B, np.int32)
        for i, (a, t) in enumerate(zip(audios, tokens)):
            a = a[:max_s]
            audio[i, : len(a)] = a
            audio_lens[i] = len(a)
            t = t[:max_u]
            toks[i, : len(t)] = t
            tok_lens[i] = len(t)
        return Batch(
            audio=audio,
            audio_lens=audio_lens,
            tokens=toks,
            token_lens=tok_lens,
            transcripts=[self.utts[i].transcript for i in idxs],
            fnames=[self.utts[i].fname for i in idxs],
            host_rng=self.host_rng_state() if self.train else None,
        )

    def epoch(self, epoch: int, resume_step: int = 0, first_step: Optional[int] = None,
              accum: int = 1) -> Iterator[Batch]:
        """Yield this rank's batches for an epoch, with prefetch. With
        ``first_step``, batch j serves step ``first_step + j // accum`` and
        is made at that step's noise SNR ranges."""
        batches = self.sampler.epoch_batches(epoch, resume_step)
        # a last global batch shorter than the ranks may leave a rank nothing
        idx_lists = [i for i in (self.sampler.shard(b, self.rank) for b in batches) if len(i)]
        if not idx_lists:
            return
        steps = [None if first_step is None else first_step + j // accum
                 for j in range(len(idx_lists))]
        futures: List[cf.Future] = []
        pool = cf.ThreadPoolExecutor(max_workers=1)
        for j in range(min(self.prefetch, len(idx_lists))):
            futures.append(pool.submit(self.make_batch, idx_lists[j], steps[j]))
        n = len(idx_lists)
        for i in range(n):
            if i + self.prefetch < n:
                j = i + self.prefetch
                futures.append(pool.submit(self.make_batch, idx_lists[j], steps[j]))
            yield futures[i].result()
        pool.shutdown(wait=False)
