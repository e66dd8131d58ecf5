"""The grouped 3x3 convs' share of their roofline, in %: the least time a
request of the trunk's grouped convs (the larger of their grouped FLOPs at
989 TFLOP/s and their bf16 input, weights and output at 3.35 TB/s, call
by call; harness/grouped.py) over the device ms a request under the
program's 'grouped_conv' span. Nothing to read without the span."""

from benchmark.harness import spans


def read(layer):
    g = layer.get("grouped_conv")
    busy = spans.of(layer["trace"]).busy_ms("grouped_conv")
    if g is None or not busy:
        return None
    return 100.0 * g["bound_ms"] / busy
