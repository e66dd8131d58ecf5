"""Wall-clock timer with running average (reference lib/utils/timer.py:34-60).

The port's own copy of ``detectorch_tpu/utils/timer.py``, held to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def tic(self):
        self.start_time = time.time()

    def toc(self, average: bool = True) -> float:
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0
