"""The port's layer spans in a traced stretch (a ``harness/trace.Trace``).

The program marks its layers with ``utils/profiling.span``: under
``torch.profiler`` each is a ``user_annotation`` named ``detectorch::<name>``
on the host, in the same trace and on the same clock as the kernels, and
spans nest by the host thread's stack. Each request's spans lie inside its
``detectorch::request`` span. From the window's events:

  * ``busy_s``: device seconds of each kernel, copy and set, put down to the
    innermost span that holds its launch (the ``cuda_runtime`` call with the
    same ``args.correlation``), whenever the device ran it. An event whose
    launch is not in the trace takes the span of the previous event on its
    stream whose launch is, as one stream runs in launch order
    (``unlaunched`` counts them, ``unlaunched_s`` their seconds);
  * ``wait_s``: each idle gap of the device (``Trace.idle_gaps``' gaps) put
    down to the innermost span open on the host at the gap's middle;
  * ``syncs``: the host's calls that wait for the device (``SYNC_CALLS``)
    put down to the innermost span around them.

Each table sums a span name over its spans and the spans inside them; what
lies in no span (the harness's fetch and loop) is under ``OUTSIDE``. The
per-request readers divide by the number of ``request`` spans, and read
nothing where the trace has no such span or none of the name asked for.
"""

from __future__ import annotations

import bisect
import functools
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import SYNC_CALLS, Trace

# the program's utils/profiling.SPAN_PREFIX, not imported from it: a
# program without spans lacks it, and the metrics then read nothing
PREFIX = "detectorch::"
REQUEST = "request"
OUTSIDE = ""


class Spans:
    def __init__(self, trace: Trace):
        marks = sorted((e for e in trace.host if e.get("cat") == "user_annotation"
                        and e["name"].startswith(PREFIX)),
                       key=lambda e: (float(e["ts"]), -float(e["dur"])))
        self.names = [e["name"][len(PREFIX):] for e in marks]
        self.start = [float(e["ts"]) for e in marks]
        self.end = [float(e["ts"]) + float(e["dur"]) for e in marks]
        self.tid = [e.get("tid") for e in marks]
        self.parent: List[int] = []
        self._by_tid: Dict[object, List[int]] = defaultdict(list)
        stacks: Dict[object, List[int]] = defaultdict(list)
        for i in range(len(marks)):
            stack = stacks[self.tid[i]]
            while stack and self.end[stack[-1]] <= self.start[i]:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
            self._by_tid[self.tid[i]].append(i)
        self._starts = {t: [self.start[i] for i in ix] for t, ix in self._by_tid.items()}
        self.count: Dict[str, int] = defaultdict(int)
        for name in self.names:
            self.count[name] += 1
        self.requests = self.count[REQUEST]

        self.busy_s: Dict[str, float] = defaultdict(float)
        self.wait_s: Dict[str, float] = defaultdict(float)
        self.syncs: Dict[str, float] = defaultdict(float)
        self.unlaunched, self.unlaunched_s = 0, 0.0
        # (device event, its span's name or None, its launch in the trace?),
        # in device order; (gap start, gap end, its span's index or -1)
        self.placed: List[Tuple[dict, Optional[str], bool]] = []
        self.gaps: List[Tuple[float, float, int]] = []

        launches = {e["args"]["correlation"]: e for e in trace.host
                    if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        last: Dict[object, int] = {}
        for e in sorted(trace.device, key=lambda e: float(e["ts"])):
            args = e.get("args", {})
            stream = args.get("stream")
            launch = launches.get(args.get("correlation"))
            if launch is not None:
                at = self.innermost(float(launch["ts"]), launch.get("tid"))
                last[stream] = at
            else:
                at = last.get(stream, -1)
                self.unlaunched += 1
                self.unlaunched_s += float(e["dur"]) * 1e-6
            self._add(self.busy_s, at, float(e["dur"]) * 1e-6)
            self.placed.append((e, self.names[at] if at >= 0 else None, launch is not None))

        at_end = trace.t0
        for a, b in trace._busy() + [(trace.t1, trace.t1)]:
            if a > at_end:
                self.gaps.append((at_end, a, self.innermost((at_end + a) / 2)))
                self._add(self.wait_s, self.gaps[-1][2], (a - at_end) * 1e-6)
            at_end = max(at_end, b)

        for e in trace.host:
            if e.get("cat") == "cuda_runtime" and e["name"] in SYNC_CALLS:
                self._add(self.syncs, self.innermost(float(e["ts"]), e.get("tid")), 1)

    def innermost(self, t: float, tid=None) -> int:
        """The index of the innermost span open at `t` on thread `tid` (on
        any thread: the latest to start), or -1."""
        best = -1
        for key in ([tid] if tid is not None else list(self._by_tid)):
            ix = self._by_tid.get(key)
            if not ix:
                continue
            j = bisect.bisect_right(self._starts[key], t) - 1
            i = ix[j] if j >= 0 else -1
            while i >= 0 and self.end[i] < t:
                i = self.parent[i]
            if i >= 0 and (best < 0 or self.start[i] > self.start[best]):
                best = i
        return best

    def _add(self, table: Dict[str, float], i: int, value: float):
        """`value` to the span `i`'s name and to every name around it, once
        each; to OUTSIDE where `i` is -1."""
        if i < 0:
            table[OUTSIDE] += value
        seen = set()
        while i >= 0:
            if self.names[i] not in seen:
                seen.add(self.names[i])
                table[self.names[i]] += value
            i = self.parent[i]

    def per_request(self, table: Dict[str, float], name: str) -> Optional[float]:
        if not self.requests or (name != OUTSIDE and not self.count.get(name)):
            return None
        return table.get(name, 0.0) / self.requests

    def busy_ms(self, name: str) -> Optional[float]:
        v = self.per_request(self.busy_s, name)
        return None if v is None else v * 1e3

    def wait_ms(self, name: str) -> Optional[float]:
        v = self.per_request(self.wait_s, name)
        return None if v is None else v * 1e3

    def syncs_per_request(self, name: str) -> Optional[float]:
        return self.per_request(self.syncs, name)


@functools.lru_cache(maxsize=1)
def of(trace: Trace) -> Spans:
    """The spans of `trace`, read once for all the metrics of a run."""
    return Spans(trace)
