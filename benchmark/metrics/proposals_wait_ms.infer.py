"""Ms a request that the device sat idle while the host ran the program's
span 'proposals' (the RPN head and the proposals (blob bounds, decode,
NMS, collect)) or a span inside it: each idle gap of the traced window
goes to the innermost span open at its middle (harness/spans.py); nothing
to read without the program's spans."""

from benchmark.harness import spans


def read(layer):
    return spans.of(layer["trace"]).wait_ms("proposals")
