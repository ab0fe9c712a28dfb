"""Parallel beam decoding across worker processes (the port of
``caiman_asr_tpu/decoding/parallel.py``; reference:
rnnt/parallel_decoder.py:16-165).

The adaptive beam's hypothesis bookkeeping is host-side Python; for offline
evaluation the reference spreads utterances over a process pool with 2x
over-chunking. Same scheme here: the parent runs the encoder on the model's
device (on the card, K1), then ships numpy encoder-output chunks to worker
processes that each hold a CPU copy of the model and run the host beam
(``decoding/beam.RNNTBeamDecoder``).

The workers run on the CPU by design, as in the JAX package
(``caiman_asr_tpu/decoding/parallel.py:28``), not as a fallback: N processes
must not open N CUDA contexts on one card. Each worker process starts
with ``CUDA_VISIBLE_DEVICES=""`` in its environment, set only around its
start: the cards are hidden from its first instruction, before the spawned
interpreter re-imports the parent's main module. It builds its model with
``device="cpu"`` and runs no K1. Its torch thread count is the host's cores
shared out over the workers, so that they do not oversubscribe the host.

Workers are spawned lazily with an initializer that rebuilds the decoder
from (config path, tokenizer path, checkpoint path, decoder kwargs): live
modules do not cross process boundaries. As in the JAX package, a worker
takes the checkpoint's EMA weights where it has them, whatever
``--no_ema`` says; without a checkpoint it takes the parent's weights,
which the port's random init cannot rebuild from a path.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ProcessPoolExecutor
from multiprocessing.context import SpawnContext, SpawnProcess
from typing import Dict, List, Optional

_worker_decoder = None
_ENV_LOCK = threading.Lock()


class _CpuProcess(SpawnProcess):
    """A spawned process whose environment hides the cards; the parent's
    own is put back once it has started."""

    def start(self):
        with _ENV_LOCK:
            prev = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                super().start()
            finally:
                if prev is None:
                    del os.environ["CUDA_VISIBLE_DEVICES"]
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = prev


class _CpuSpawnContext(SpawnContext):
    """spawn (not fork: a forked child would inherit the parent's CUDA
    context), each worker started by :class:`_CpuProcess`."""

    Process = _CpuProcess


def _init_worker(config_path, tokenizer_path, ckpt_path, decoder_kwargs, params, threads):
    """Build a CPU decoder inside the worker process."""
    global _worker_decoder
    import torch

    from caiman_asr_tpu_torch.decoding.beam import RNNTBeamDecoder
    from caiman_asr_tpu_torch.export.checkpointer import apply_params, load_checkpoint
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.setup.builders import build_model, build_tokenizer

    torch.set_num_threads(threads)
    cfg = load_config(config_path)
    tokenizer = build_tokenizer(cfg, tokenizer_path)
    model, blank_idx = build_model(cfg, tokenizer, device="cpu")
    model.eval()
    if ckpt_path:
        loaded, ema, _, _ = load_checkpoint(ckpt_path)
        params = ema if ema is not None else loaded
    apply_params(model.param_tree(), params)
    _worker_decoder = RNNTBeamDecoder(model, blank_idx, tokenizer, **(decoder_kwargs or {}))


def _decode_chunk(args):
    encs, enc_lens = args
    return _worker_decoder.decode_encs(encs, enc_lens)


def _worker_state(_=None) -> dict:
    """What a worker holds: its pid, whether it initialised CUDA, its torch
    thread count and its decoder's device (for tests)."""
    import torch

    return {"pid": os.getpid(), "cuda_initialized": torch.cuda.is_initialized(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "threads": torch.get_num_threads(), "device": str(_worker_decoder.device),
            "temperature": _worker_decoder.temperature,
            "ngram_lm": _worker_decoder.ngram_lm is not None,
            "keywords": _worker_decoder.keywords is not None}


class ParallelDecoder:
    """Chunk a batch of encoder outputs over a beam-decoding process pool."""

    def __init__(
        self,
        model,
        config_path: str,
        tokenizer_path: Optional[str],
        ckpt_path: Optional[str],
        decoder_kwargs: Optional[dict] = None,
        nprocs: Optional[int] = None,
        min_batch_per_proc: int = 1,
    ):
        from caiman_asr_tpu_torch.training.tree import tree_map

        self.model = model
        if nprocs is None or nprocs < 0:
            nprocs = min(os.cpu_count() or 1, 8)
        self.nprocs = max(1, nprocs)
        self.min_batch_per_proc = max(1, min_batch_per_proc)
        params = None if ckpt_path else tree_map(
            lambda t: t.detach().float().cpu().numpy(), model.param_tree())
        threads = max(1, (os.cpu_count() or 1) // self.nprocs)
        # fresh interpreters build their CPU models from scratch; the pool
        # starts its workers on demand, each with the cards hidden
        self._pool = ProcessPoolExecutor(
            max_workers=self.nprocs,
            mp_context=_CpuSpawnContext(),
            initializer=_init_worker,
            initargs=(config_path, tokenizer_path, ckpt_path, decoder_kwargs, params, threads),
        )

    def decode(self, feats, feat_lens) -> List[Dict]:
        """Encoder on the model's device, then the beam on the workers.
        feats: [T, B, in_feats] time-major."""
        import torch

        with torch.inference_mode():
            encs, enc_lens, _ = self.model.encode(feats, feat_lens)
        return self.decode_encs(encs.float().cpu().numpy(), enc_lens.cpu().numpy())

    def decode_encs(self, encs, enc_lens) -> List[Dict]:
        B = encs.shape[0]
        # 2x over-chunking for load balance (reference parallel_decoder.py),
        # but never split below the per-chunk minimum batch size
        n_chunks = min(B, 2 * self.nprocs, max(1, B // self.min_batch_per_proc))
        sizes = [(B + n_chunks - 1 - i) // n_chunks for i in range(n_chunks)]
        chunks, start = [], 0
        for s in sizes:
            if s <= 0:
                continue
            chunks.append((encs[start : start + s], enc_lens[start : start + s]))
            start += s
        results = self._pool.map(_decode_chunk, chunks)
        out: List[Dict] = []
        for r in results:
            out.extend(r)
        return out

    def worker_states(self) -> list:
        """One :func:`_worker_state` a task, over 2 x nprocs tasks."""
        return list(self._pool.map(_worker_state, range(2 * self.nprocs)))

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
