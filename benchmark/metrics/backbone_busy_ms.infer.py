"""Device ms a request of the kernels, copies and sets launched inside the
program's span 'backbone': the backbone (ResNet-50 conv1..res5 and the FPN
neck, or C4's conv1..res4). Each event counts for the span that holds its
launch, whenever the device ran it (harness/spans.py); nothing to read
without the program's spans."""

from benchmark.harness import spans


def read(layer):
    return spans.of(layer["trace"]).busy_ms("backbone")
