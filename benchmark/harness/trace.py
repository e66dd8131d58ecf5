"""Reading a ``torch.profiler`` trace of a few requests.

The profiler's Chrome trace puts host events (operators, CUDA runtime
calls) and device events (kernels, copies, sets) on one clock, in
microseconds. From the events inside the window that the benchmark marks:

  * ``busy_s``: the union of the device's intervals;
  * ``device_ops``: device seconds by operation name;
  * ``idle_gaps``: the device's idle gaps, each named by the innermost host
    event running at its middle, seconds summed by name;
  * ``syncs``: the host's calls that wait for the device;
  * ``kernel_s(part)``: device seconds of the kernels whose name holds `part`.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "python_function")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


class Trace:
    def __init__(self, path: str, window: str):
        events = json.loads(open(path).read())["traceEvents"]
        marks = [e for e in events if e.get("name") == window and e.get("ph") == "X"
                 and e.get("cat") in HOST_CATS]
        if not marks:
            raise RuntimeError(f"the trace has no {window!r} window")
        w = max(marks, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        inside = [e for e in events if e.get("ph") == "X" and "dur" in e
                  and self.t0 <= float(e["ts"]) < self.t1]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in inside if e.get("cat") in HOST_CATS and e is not w]
        self.syncs = sum(1 for e in inside if e.get("cat") == "cuda_runtime"
                         and e["name"] in SYNC_CALLS)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self) -> List[Tuple[float, float]]:
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(max(a, self.t0), min(b, self.t1)) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def kernel_s(self, part: str) -> float:
        return sum(float(e["dur"]) for e in self.device if part in e["name"]) * 1e-6

    def kernel_count(self, part: str) -> int:
        return sum(1 for e in self.device if part in e["name"])

    def device_ops(self, top: int = 10):
        by: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by[e["name"]] += float(e["dur"]) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        busy = self._busy()
        gaps, at = [], self.t0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < self.t1:
            gaps.append((at, self.t1))
        hosts = sorted(self.host, key=lambda e: float(e["ts"]))
        starts = [float(e["ts"]) for e in hosts]
        longest = max((float(e["dur"]) for e in hosts), default=0.0)
        by: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            name = "host idle"
            # nested host events: the latest to start of those covering mid
            # is the innermost
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                e = hosts[j]
                if starts[j] < mid - longest:
                    break
                if float(e["ts"]) + float(e["dur"]) >= mid:
                    name = e["name"]
                    break
            by[name] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]
