"""Device ms a request of the kernels, copies and sets launched inside the
program's span 'grouped_conv': the ResNeXt trunk's grouped 3x3 convs (33
a request on ResNeXt-101, inside 'backbone'). Nothing to read where the
program has no such span."""

from benchmark.harness import spans


def read(layer):
    return spans.of(layer["trace"]).busy_ms("grouped_conv")
