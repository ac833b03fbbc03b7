"""Background-threaded batch prefetching (counterpart of
`faithdiff_tpu/data/prefetch.py`; the torch-DataLoader-workers
role in the reference's training stack, `train_SDXL_stage_1.py` via
accelerate's DataLoader).

Two layers, composable:

- `PrefetchIterator(it, depth)`: one producer thread drains any batch
  iterator into a bounded queue so host-side work (decode, augment,
  degradation planning, embed lookup) overlaps the device step. Depth 2
  is enough — the device step is the long pole and the queue only needs
  to hide producer jitter.
- `ParallelSampleLoader(ds, batch_size, ...)`: `num_workers` threads call
  `ds[idx]` concurrently (zlib inflate and numpy release the GIL), batches
  assembled in draw order. Each draw gets its own `random.Random` seeded
  by (seed, draw_index), so augmentation is bit-reproducible at ANY
  worker count — unlike torch's worker-dependent RNG streams.

Both propagate worker exceptions to the consumer and stop cleanly via
`close()` / context manager / GC.
"""
from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence


_SENTINEL = object()


class PrefetchIterator:
    """Wrap `it` with a single producer thread and a bounded queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        assert depth >= 1
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(it,), daemon=True)
        self._thread.start()

    def _produce(self, it):
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — relay to consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class ParallelSampleLoader:
    """Infinite batch iterator over an indexable dataset with parallel
    sample workers and in-order assembly.

    `collate(samples) -> batch` combines one draw's samples. Sampling is
    uniform-with-replacement (the reference's random sampler over an
    offline dataset). Draw `d`, slot `b` uses
    `random.Random(f"{seed}:{d * batch_size + b}")` for both the index pick
    and the augmentation rng — reproducible for any `num_workers`.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable[[Sequence], dict],
        seed: int = 0,
        num_workers: int = 4,
        depth: int = 2,
    ):
        assert num_workers >= 1 and depth >= 1
        self._ds = dataset
        self._bs = batch_size
        self._collate = collate
        self._seed = seed
        self._pool = ThreadPoolExecutor(max_workers=num_workers,
                                        thread_name_prefix="fd-data")
        self._pending: "queue.Queue" = queue.Queue()
        self._depth = depth
        self._draw = 0

    def _sample(self, counter: int):
        rng = random.Random(f"{self._seed}:{counter}")
        idx = rng.randrange(len(self._ds))
        return self._ds.__getitem__(idx, rng=rng)

    def _submit_draw(self):
        base = self._draw * self._bs
        futs = [self._pool.submit(self._sample, base + b)
                for b in range(self._bs)]
        self._pending.put(futs)
        self._draw += 1

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while self._pending.qsize() < self._depth:
            self._submit_draw()
        futs = self._pending.get()
        return self._collate([f.result() for f in futs])

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
