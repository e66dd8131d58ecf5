"""Training statistics: median-smoothed windows, ETA, json-line logging.

Reference ``lib/utils/training_stats.py:35-114`` + ``lib/utils/logging.py:35-81``
(SmoothedValue / log_json_stats).

The port's own copy of ``detectorch_tpu/utils/stats.py``, held to it by
tests/test_torch_host_copies.py.
"""

from __future__ import annotations

import datetime
import json
from collections import defaultdict, deque

import numpy as np

from detectorch_tpu_torch.utils.timer import Timer


class SmoothedValue:
    """Median/mean over a sliding window (reference logging.py:44-63)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(value)
        self.series.append(value)
        self.count += 1
        self.total += value

    def get_median_value(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_average_value(self) -> float:
        return self.total / max(self.count, 1)


def log_json_stats(stats: dict):
    print("json_stats: {:s}".format(json.dumps(stats, sort_keys=True)), flush=True)


class TrainingStats:
    """reference training_stats.py:35-114 semantics: iter timer, smoothed
    losses, ETA, periodic json_stats emission."""

    def __init__(self, max_iter: int, log_period: int = 20, window_size: int = 20):
        self.max_iter = max_iter
        self.log_period = log_period
        self.iter_timer = Timer()
        self.smoothed_losses = defaultdict(lambda: SmoothedValue(window_size))
        self.smoothed_metrics = defaultdict(lambda: SmoothedValue(window_size))
        # the reference's headline 'loss' stat is the median of the PER-ITER
        # SUM of losses, tracked in its own window (training_stats.py:80-83)
        self.smoothed_total_loss = SmoothedValue(window_size)
        self.cur_iter = 0

    def iter_tic(self):
        self.iter_timer.tic()

    def iter_toc(self):
        return self.iter_timer.toc(average=False)

    def update_iter_stats(self, cur_iter: int, losses: dict, metrics: dict):
        self.cur_iter = cur_iter
        vals = {k: float(v) for k, v in losses.items()}
        # headline total: the caller's own 'loss' entry verbatim when given
        # (summing it with its components would double-count), else the sum
        # of the components
        total = vals.pop("loss", None)
        if total is None:
            total = float(np.sum(list(vals.values()))) if vals else 0.0
        for k, v in vals.items():
            self.smoothed_losses[k].add_value(v)
        for k, v in metrics.items():
            self.smoothed_metrics[k].add_value(float(v))
        self.smoothed_total_loss.add_value(total)

    def get_stats(self, cur_iter: int, lr: float) -> dict:
        eta_seconds = self.iter_timer.average_time * (self.max_iter - cur_iter)
        stats = {
            "iter": cur_iter,
            "time": self.iter_timer.average_time,
            "eta": str(datetime.timedelta(seconds=int(eta_seconds))),
            "lr": float(lr),
            "loss": self.smoothed_total_loss.get_median_value(),
        }
        for k, v in self.smoothed_losses.items():
            stats[k] = v.get_median_value()
        for k, v in self.smoothed_metrics.items():
            stats[k] = v.get_median_value()
        return stats

    def log_iter_stats(self, cur_iter: int, lr: float):
        if cur_iter % self.log_period == 0:
            log_json_stats(self.get_stats(cur_iter, lr))
