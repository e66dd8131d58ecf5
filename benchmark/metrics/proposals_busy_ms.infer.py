"""Device ms a request of the kernels, copies and sets launched inside the
program's span 'proposals': the RPN head and the proposals (blob bounds,
decode, NMS, collect). Each event counts for the span that holds its
launch, whenever the device ran it (harness/spans.py); nothing to read
without the program's spans."""

from benchmark.harness import spans


def read(layer):
    return spans.of(layer["trace"]).busy_ms("proposals")
