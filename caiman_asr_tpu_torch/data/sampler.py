"""Epoch samplers (reference: data/dali/sampler.py:71-713).

Contract: ``epoch_batches(epoch)`` returns the list of *global* batches for
an epoch; each global batch is a numpy index array of length
``batch_size * world_size`` which data-parallel rank r slices as
``batch[r::world_size]`` (round-robin, mirroring the reference's
``_to_dali_order`` sharding, sampler.py:321-360). All ranks derive identical
epochs from the shared seed, so no file-list broadcast is needed.

Reference behaviours kept:
- **pessimistic first batch**: the first batch of epoch 0 contains the
  longest utterances so OOM fails immediately (sampler.py:286-316);
- **BucketingSampler**: shuffle -> sort by duration -> chunk into buckets of
  ``batch_size * num_buckets`` -> shuffle within bucket -> batch -> shuffle
  batches (sampler.py:645-713);
- mid-epoch resume by dropping the first ``resume_step`` batches.

The port's copy of ``caiman_asr_tpu/data/sampler.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class Sampler:
    def __init__(
        self,
        durations: Sequence[float],
        batch_size: int,
        world_size: int = 1,
        seed: int = 0,
        drop_last: bool = True,
        pessimistic_first_batch: bool = True,
        randomize_first_n_epochs: int = 0,
    ):
        self.durations = np.asarray(durations, dtype=np.float64)
        self.batch_size = batch_size
        self.world_size = world_size
        self.global_batch = batch_size * world_size
        self.seed = seed
        self.drop_last = drop_last
        self.pessimistic_first_batch = pessimistic_first_batch
        # reference args/train.py:233-237: fully randomize the first n
        # epochs regardless of bucketing (warmup on an unsorted stream)
        self.randomize_first_n_epochs = randomize_first_n_epochs

    def _order(self, epoch: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def _random_order(self, epoch: int, rng: np.random.Generator) -> np.ndarray:
        """Fully random epoch order (used for the first
        ``randomize_first_n_epochs`` epochs regardless of bucketing)."""
        return rng.permutation(len(self.durations))

    def epoch_batches(self, epoch: int, resume_step: int = 0) -> List[np.ndarray]:
        rng = np.random.default_rng((self.seed, epoch))
        if epoch < self.randomize_first_n_epochs:
            order = self._random_order(epoch, rng)
        else:
            order = self._order(epoch, rng)
        n = (len(order) // self.global_batch) * self.global_batch
        if n == 0 and (self.drop_last or len(order) == 0):
            return []
        batches = [
            order[i : i + self.global_batch] for i in range(0, n, self.global_batch)
        ]
        if not self.drop_last and n < len(order):
            batches.append(order[n:])
        if not batches:
            return []
        if self.pessimistic_first_batch and epoch == 0 and resume_step == 0:
            # Prepend a batch of the longest utterances (fail-fast OOM probe);
            # it replaces the first batch rather than adding a step.
            longest = np.argsort(self.durations)[-self.global_batch:]
            batches[0] = longest
        return batches[resume_step:]

    def shard(self, batch: np.ndarray, rank: int) -> np.ndarray:
        return batch[rank :: self.world_size]


class SimpleSampler(Sampler):
    """In-manifest order (reference SimpleSampler)."""

    def _order(self, epoch, rng):
        return np.arange(len(self.durations))


class SortedSampler(Sampler):
    """Sorted by duration — minimal padding waste, no shuffling (val)."""

    def _order(self, epoch, rng):
        return np.argsort(self.durations, kind="stable")


class RandomSampler(Sampler):
    def _order(self, epoch, rng):
        return rng.permutation(len(self.durations))


class BucketingSampler(Sampler):
    def __init__(self, *args, num_buckets: int = 6, **kw):
        super().__init__(*args, **kw)
        self.num_buckets = num_buckets

    def _order(self, epoch, rng):
        if self.num_buckets <= 0:
            # reference args/train.py:225-231: 0 buckets means no duration
            # grouping at all (RandomSampler semantics)
            return self._random_order(epoch, rng)
        n = len(self.durations)
        perm = rng.permutation(n)
        # Stable sort of the shuffled order by duration.
        srt = perm[np.argsort(self.durations[perm], kind="stable")]
        bucket_size = self.global_batch * self.num_buckets
        out_batches = []
        for s in range(0, n, bucket_size):
            bucket = srt[s : s + bucket_size].copy()
            rng.shuffle(bucket)
            for b in range(0, len(bucket), self.global_batch):
                chunk = bucket[b : b + self.global_batch]
                if len(chunk) == self.global_batch or not self.drop_last:
                    out_batches.append(chunk)
        order = np.arange(len(out_batches))
        rng.shuffle(order)
        return np.concatenate([out_batches[i] for i in order]) if out_batches else np.array([], np.int64)


class WeightedBucketingSampler(BucketingSampler):
    """Bucketing sampler with per-manifest epoch weighting
    (reference: data/dali/manifest_ratios.py + sampler weighted epochs).

    Modes (mutually exclusive, matching the reference CLI):
    - ``absolute_ratios``: target fraction of the epoch per manifest
      (normalised); manifests are over/under-sampled to hit it;
    - ``relative_ratios``: multiply each manifest's natural (duration-
      proportional) share by the given factor;
    - ``canary_exponent``: weight each manifest by
      ``duration(manifest) ** exponent`` (the NVIDIA Canary temperature
      trick; exponent < 1 upweights small manifests).

    A weight w means every utterance of that manifest appears
    ``floor(w)`` times per epoch plus once more with probability frac(w).
    """

    def __init__(
        self,
        durations,
        manifest_ids,
        batch_size: int,
        world_size: int = 1,
        seed: int = 0,
        num_buckets: int = 6,
        absolute_ratios=None,
        relative_ratios=None,
        canary_exponent=None,
        **kw,
    ):
        super().__init__(durations, batch_size, world_size, seed=seed,
                         num_buckets=num_buckets, **kw)
        self.manifest_ids = np.asarray(manifest_ids, np.int64)
        n_manifests = int(self.manifest_ids.max()) + 1 if len(self.manifest_ids) else 0
        modes = [absolute_ratios is not None, relative_ratios is not None,
                 canary_exponent is not None]
        if sum(modes) > 1:
            raise ValueError("set at most one manifest-weighting mode")
        dur_per = np.array([
            self.durations[self.manifest_ids == m].sum() for m in range(n_manifests)
        ])
        total = dur_per.sum() or 1.0
        if absolute_ratios is not None:
            if len(absolute_ratios) != n_manifests:
                raise ValueError("one absolute ratio per manifest required")
            target = np.asarray(absolute_ratios, float)
            target = target / target.sum()
            self.weights = target * total / np.maximum(dur_per, 1e-9)
        elif relative_ratios is not None:
            if len(relative_ratios) != n_manifests:
                raise ValueError("one relative ratio per manifest required")
            self.weights = np.asarray(relative_ratios, float)
        elif canary_exponent is not None:
            w = dur_per ** float(canary_exponent)
            share = w / w.sum()
            self.weights = share * total / np.maximum(dur_per, 1e-9)
        else:
            self.weights = np.ones(n_manifests)

    def _weighted_indices(self, rng) -> np.ndarray:
        """Epoch index pool with per-manifest over/under-sampling applied."""
        w = self.weights[self.manifest_ids]  # per-utterance weight
        repeats = np.floor(w).astype(np.int64)
        repeats += (rng.random(len(w)) < (w - np.floor(w))).astype(np.int64)
        return np.repeat(np.arange(len(w)), repeats)

    def _random_order(self, epoch, rng):
        # keep the manifest weighting even in fully-randomized epochs
        idxs = self._weighted_indices(rng)
        return idxs[rng.permutation(len(idxs))]

    def _order(self, epoch, rng):
        if self.num_buckets <= 0:
            return self._random_order(epoch, rng)
        idxs = self._weighted_indices(rng)
        if len(idxs) == 0:
            return np.array([], np.int64)
        perm = idxs[rng.permutation(len(idxs))]
        srt = perm[np.argsort(self.durations[perm], kind="stable")]
        bucket_size = self.global_batch * self.num_buckets
        out_batches = []
        for s in range(0, len(srt), bucket_size):
            bucket = srt[s : s + bucket_size].copy()
            rng.shuffle(bucket)
            for b in range(0, len(bucket), self.global_batch):
                chunk = bucket[b : b + self.global_batch]
                if len(chunk) == self.global_batch or not self.drop_last:
                    out_batches.append(chunk)
        order = np.arange(len(out_batches))
        rng.shuffle(order)
        return (np.concatenate([out_batches[i] for i in order])
                if out_batches else np.array([], np.int64))
