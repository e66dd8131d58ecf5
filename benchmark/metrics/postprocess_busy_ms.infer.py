"""Device ms a request of the kernels, copies and sets launched inside the
program's span 'postprocess': the per-class NMS and the cap. Each event
counts for the span that holds its launch, whenever the device ran it
(harness/spans.py); nothing to read without the program's spans."""

from benchmark.harness import spans


def read(layer):
    return spans.of(layer["trace"]).busy_ms("postprocess")
