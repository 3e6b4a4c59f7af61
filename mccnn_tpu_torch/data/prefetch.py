"""Host-side batch prefetching: overlap patch sampling with device steps
(the port's own copy of mccnn_tpu/data/prefetch.py).

The reference samples every batch synchronously on the host between
steps (reference: src/train.py:161-166); this wrapper moves sampling to
one background thread feeding a bounded queue.

Sample-stream parity: a single producer thread draws batches in the same
order the synchronous loop would, and it never samples past an epoch
boundary (``epoch_len`` batches), so the sampler's RNG stream -- and hence
every batch -- is bit-identical to the unprefetched loop, including across
``reset()`` reshuffles.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


class BatchPrefetcher:
    """Background-thread prefetch around a ``TripletSampler``-like object.

    Draws exactly ``epoch_len`` batches per epoch, then idles until
    ``reset()``; drop-in for the sampler's ``next_batch``/``reset`` pair in
    an epoch loop that consumes exactly ``epoch_len`` batches per epoch.
    """

    def __init__(self, sampler, batch_size: int, epoch_len: int,
                 depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if epoch_len < 1:
            raise ValueError("epoch_len must be >= 1")
        self._sampler = sampler
        self._batch_size = batch_size
        self._epoch_len = epoch_len
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._resume = threading.Event()
        self._epoch_done = threading.Event()
        self._stop = False
        self._consumed = 0  # batches taken this epoch (consumer thread only)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            for _ in range(self._epoch_len):
                if self._stop:
                    return
                try:
                    batch = self._sampler.next_batch(self._batch_size)
                except BaseException as exc:  # surfaced on the next get()
                    self._error = exc
                    self._epoch_done.set()
                    return
                self._queue.put(batch)
            self._epoch_done.set()
            self._resume.wait()
            if self._stop:
                return
            self._resume.clear()

    def next_batch(self, batch_size: Optional[int] = None) -> Batch:
        if batch_size is not None and batch_size != self._batch_size:
            raise ValueError(
                f"prefetcher was built for batch_size={self._batch_size}"
            )
        while True:
            try:
                batch = self._queue.get(timeout=0.5)
                self._consumed += 1
                return batch
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if not self._thread.is_alive():
                    raise RuntimeError("prefetch thread died")

    def reset(self) -> None:
        """End-of-epoch reshuffle; requires the epoch fully consumed."""
        # check the consumed count BEFORE waiting on _epoch_done: with more
        # than `depth` batches unconsumed the producer is blocked on the
        # bounded queue.put() and will never set _epoch_done — waiting
        # first would deadlock instead of reporting the misuse
        if self._consumed != self._epoch_len and self._error is None:
            raise RuntimeError(
                "reset() before consuming the full epoch "
                f"({self._consumed}/{self._epoch_len} batches consumed)"
            )
        self._epoch_done.wait()
        if self._error is not None:
            raise self._error
        self._consumed = 0
        self._epoch_done.clear()
        self._sampler.reset()  # producer is idle: safe to touch its RNG
        self._resume.set()

    def close(self) -> None:
        self._stop = True
        self._resume.set()
        while self._thread.is_alive():  # unblock a producer mid-put
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    def __enter__(self) -> "BatchPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
