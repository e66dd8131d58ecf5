"""Prefetching data loader: overlap host preprocessing with device compute.

The reference uses torch DataLoader worker processes + a custom list collate
(``lib/utils/collate_custom.py``; workers at ``train_fast.py:105``). The TPU
equivalent: a thread pool decodes/resizes/pads images into fixed-shape numpy
batches while the device crunches the previous batch, with a bounded queue
for backpressure. Fixed shape buckets mean no collate logic at all — samples
of one bucket simply stack.

The port's own copy of ``detectorch_tpu/data/loader.py``, held to it by
tests/test_torch_host_copies.py, with one repair: a worker takes its
prefetch permit before its task, where the original takes it after and can
deadlock (later items holding every permit while the item the consumer
waits for blocks on the semaphore).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_SENTINEL = object()


class PrefetchLoader:
    """Background-thread(ed) map over an index iterable.

    make_sample(index) runs in worker threads (cv2/numpy release the GIL for
    the heavy parts); results arrive in submission order.
    """

    def __init__(
        self,
        indices: Iterable,
        make_sample: Callable,
        num_workers: int = 4,
        prefetch: int = 8,
    ):
        self.indices = list(indices)
        self.make_sample = make_sample
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.indices)

    def __iter__(self) -> Iterator:
        task_q: queue.Queue = queue.Queue()
        # per-slot result delivery keeps submission order
        slots = [queue.Queue(maxsize=1) for _ in range(len(self.indices))]
        for i, idx in enumerate(self.indices):
            task_q.put((i, idx))
        for _ in range(self.num_workers):
            task_q.put(_SENTINEL)

        inflight = threading.Semaphore(self.prefetch)
        errors: list = []

        # a worker takes its permit before its task: tasks leave the queue
        # in order, so the items that hold permits are always the lowest
        # unconsumed ones, and the one the consumer waits for has a worker
        def worker():
            while True:
                inflight.acquire()
                item = task_q.get()
                if item is _SENTINEL:
                    inflight.release()
                    return
                i, idx = item
                try:
                    slots[i].put(self.make_sample(idx))
                except Exception as e:  # surface in consumer
                    errors.append(e)
                    slots[i].put(_SENTINEL)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            for i in range(len(self.indices)):
                out = slots[i].get()
                inflight.release()
                if out is _SENTINEL:
                    raise errors[0]
                yield out
        finally:
            # drop the tasks left, then let every worker take a permit and
            # a sentinel, so that all of them exit
            try:
                while True:
                    task_q.get_nowait()
            except queue.Empty:
                pass
            for _ in threads:
                task_q.put(_SENTINEL)
                inflight.release()
