"""The host's waits for the device per request (cudaStreamSynchronize and
the like in the profiler's trace): the NMS fixpoints' tests, and the one
fetch that ends the request."""


def read(layer):
    return layer["trace"].syncs / layer["requests"]
