"""Deterministic synthetic data pipeline, as the reference's
``repro/data/pipeline.py``: the same numpy generator, so the batches are
the reference's, word for word.

Stateless (step -> batch is a pure function of (seed, step, shard), so a
restart replays the same stream), shard-aware, with a background
prefetcher.  Tokens mix Zipfian unigrams with copy spans, structure a
language model learns within a few hundred steps.  Batches are numpy
arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "tokens"          # tokens | frames
    d_model: int = 0              # for frame stubs
    n_codebooks: int = 0
    zipf_alpha: float = 1.2
    copy_fraction: float = 0.3    # fraction of positions in copy spans


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


class SyntheticStream:
    """step -> batch, deterministic; shard-aware for several hosts."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1):
        if cfg.global_batch % n_shards:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {n_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards
        self._probs = _zipf_probs(cfg.vocab_size, cfg.zipf_alpha)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard]))
        b, s = self.local_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self._probs)
        # copy spans: induction structure the model can learn
        n_copy = int(cfg.copy_fraction * s) // 2
        if n_copy > 4:
            for i in range(b):
                start = rng.integers(0, s - 2 * n_copy)
                src = toks[i, start:start + n_copy]
                toks[i, start + n_copy:start + 2 * n_copy] = src
        toks = toks.astype(np.int32)
        if cfg.kind == "frames":
            frames = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
            batch = {"frames": frames}
        else:
            batch = {"tokens": toks[:, :s]}
        labels = toks[:, 1:s + 1]
        if cfg.n_codebooks:
            labels = np.stack([(labels + k) % cfg.vocab_size
                               for k in range(cfg.n_codebooks)], axis=-1)
        batch["labels"] = labels
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """A background thread keeping ``depth`` batches ready (overlaps host
    data generation with device compute).  ``close`` stops it."""

    def __init__(self, stream: SyntheticStream, depth: int = 2,
                 start_step: int = 0):
        self._stream = stream
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def stream_for_model(model, shape, seed: int = 0, shard: int = 0,
                     n_shards: int = 1) -> SyntheticStream:
    cfg = model.cfg
    return SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        kind=cfg.input_kind if cfg.input_kind == "frames" else "tokens",
        d_model=cfg.d_model, n_codebooks=cfg.n_codebooks),
        shard=shard, n_shards=n_shards)
