"""Ms a request that the device sat idle while the host ran the program's
span 'backbone' (the backbone (ResNet-50 conv1..res5 and the FPN neck, or
C4's conv1..res4)) or a span inside it: each idle gap of the traced window
goes to the innermost span open at its middle (harness/spans.py); nothing
to read without the program's spans."""

from benchmark.harness import spans


def read(layer):
    return spans.of(layer["trace"]).wait_ms("backbone")
