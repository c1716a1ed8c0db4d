"""Host-sharded deterministic data pipeline with background prefetch
(``src/repro/data/pipeline.py``).

Every process computes the same epoch permutation from the (seed, epoch)
pair and takes its rank-strided slice, so restarts are deterministic
given (seed, step): ``batches(start_step)`` fast-forwards. The rank and
world size are ``torch.distributed``'s where it is initialised, else 0
and 1 (the reference reads ``jax.process_index`` / ``process_count``).
Prefetch is a small thread and queue that overlap host batch assembly
with device work.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


def _rank_and_world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataPipeline:
    def __init__(self, n_examples: int, batch_size: int,
                 make_batch: Callable[[np.ndarray], Dict],
                 seed: int = 0, shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None, prefetch: int = 2,
                 drop_remainder: bool = True):
        """make_batch: maps example-id array [B] -> batch dict of arrays."""
        rank, world = _rank_and_world()
        self.n = n_examples
        self.bs = batch_size
        self.make_batch = make_batch
        self.seed = seed
        self.shard_index = shard_index if shard_index is not None else rank
        self.shard_count = shard_count if shard_count is not None else world
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder

    def _epoch_ids(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(self.n)
        return perm[self.shard_index::self.shard_count]

    def batches(self, start_step: int = 0) -> Iterator[Dict]:
        """Infinite batch iterator, fast-forwarded to ``start_step``."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            step = 0
            epoch = 0
            while not stop.is_set():
                ids = self._epoch_ids(epoch)
                nb = len(ids) // self.bs
                for b in range(nb):
                    if step >= start_step:
                        batch = self.make_batch(
                            ids[b * self.bs:(b + 1) * self.bs])
                        while not stop.is_set():
                            try:
                                q.put((step, batch), timeout=0.5)
                                break
                            except queue.Full:
                                continue
                    step += 1
                epoch += 1

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                step, batch = q.get()
                yield batch
        finally:
            stop.set()


def lm_batches(tokens: np.ndarray, batch_size: int, seq_len: int,
               seed: int = 0, start_step: int = 0,
               shard_count: Optional[int] = None) -> Iterator[Dict]:
    """Fixed-shape causal-LM batches from a flat token stream.

    tokens: [N] int32. Yields {tokens [B, S], labels [B, S]} (labels are
    tokens shifted left; last position predicts the next stream token).
    ``shard_count=1``: every rank takes the whole stream (the global
    batch, which a trainer over a mesh lays out itself).
    """
    n_seq = (len(tokens) - 1) // seq_len

    def make(ids):
        b_tok = np.stack([tokens[i * seq_len:(i + 1) * seq_len]
                          for i in ids])
        b_lab = np.stack([tokens[i * seq_len + 1:(i + 1) * seq_len + 1]
                          for i in ids])
        return {"tokens": b_tok.astype(np.int32),
                "labels": b_lab.astype(np.int32)}

    pipe = DataPipeline(n_seq, batch_size, make, seed=seed,
                        shard_index=0 if shard_count == 1 else None,
                        shard_count=shard_count)
    return pipe.batches(start_step=start_step)
