"""HuggingFace datasets reader (the port of
``caiman_asr_tpu/data/hugging_face.py``; reference data/hugging_face/core.py).

Streams a HuggingFace audio dataset into the same ``Batch`` interface as the
other loaders. ``datasets`` is imported only when a reader is built. A
dataset on local files works without the network, e.g.
``datasets.load_dataset("json", data_files=..., split="train")`` with an
``{array, sampling_rate}`` audio column; a hub dataset needs it in the
datasets cache.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from caiman_asr_tpu_torch.data.loader import Batch
from caiman_asr_tpu_torch.data.text.normalize import NormalizeConfig


class HuggingFaceReader:
    def __init__(
        self,
        dataset: str,
        split: str = "train",
        config: Optional[str] = None,
        audio_column: str = "audio",
        text_column: str = "text",
        sample_rate: int = 16000,
        streaming: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        import datasets as hf_datasets

        self.ds = hf_datasets.load_dataset(dataset, config, split=split, streaming=streaming)
        # re-cast to the target rate only where the column really is an
        # Audio feature: a plain {array, sampling_rate} column (a local json
        # dataset) would fail lazily inside the datasets decoder; such
        # columns are resampled in __iter__ instead
        feats = getattr(self.ds, "features", None)
        if feats is not None and isinstance(feats.get(audio_column), hf_datasets.Audio):
            try:
                self.ds = self.ds.cast_column(audio_column,
                                              hf_datasets.Audio(sampling_rate=sample_rate))
            except Exception:
                pass
        self.audio_column = audio_column
        self.text_column = text_column
        self.sr = sample_rate
        self.shard_id = shard_id
        self.num_shards = num_shards

    def __iter__(self):
        from caiman_asr_tpu_torch.data.audio import resample

        for i, item in enumerate(self.ds):
            if i % self.num_shards != self.shard_id:
                continue
            audio = item[self.audio_column]
            arr = np.asarray(audio["array"], np.float32)
            sr = int(audio.get("sampling_rate", self.sr))
            if sr != self.sr:
                arr = resample(arr, sr, self.sr)
            yield arr, item[self.text_column], str(item.get("id", i))


class HuggingFaceLoader:
    """Batches of ``batch_size`` samples over a reader, with the manifest
    loader's interface."""

    def __init__(
        self,
        reader: HuggingFaceReader,
        tokenizer,
        batch_size: int,
        normalize_config: Optional[NormalizeConfig] = None,
        sample_quantum_secs: float = 2.0,
        token_quantum: int = 32,
        drop_last: bool = False,
    ):
        self.drop_last = drop_last
        self.reader = reader
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.norm_cfg = normalize_config or NormalizeConfig()
        self.sr = reader.sr
        self.sample_quantum = int(sample_quantum_secs * reader.sr)
        self.token_quantum = token_quantum

    def _batch(self, group: List[tuple]) -> Batch:
        from caiman_asr_tpu_torch.data.webdataset import make_padded_batch

        return make_padded_batch(group, self.tokenizer, self.norm_cfg, self.tokenizer.charset,
                                 self.sample_quantum, self.token_quantum)

    def epoch(self, epoch: int, resume_step: int = 0) -> Iterator[Batch]:
        group: List[tuple] = []
        skipped = 0
        for sample in self.reader:
            group.append(sample)
            if len(group) == self.batch_size:
                if skipped < resume_step:
                    skipped += 1
                else:
                    yield self._batch(group)
                group = []
        if group and not self.drop_last and skipped >= resume_step:  # the tail batch
            yield self._batch(group)
