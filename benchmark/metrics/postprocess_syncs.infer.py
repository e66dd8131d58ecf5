"""The host's waits for the device a request (cudaStreamSynchronize and the
like in the profiler's trace) inside the program's span 'postprocess': the
per-class NMS's fixpoint tests (harness/spans.py); nothing to read without
the program's spans."""

from benchmark.harness import spans


def read(layer):
    return spans.of(layer["trace"]).syncs_per_request("postprocess")
