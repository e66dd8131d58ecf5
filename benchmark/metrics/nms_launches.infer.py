"""NMS kernel launches a request (the kernels named detectorch_nms in the
profiler's trace: the IoU mask and the greedy scan, for the proposal and the
per-class NMS). Nothing to read where no such kernel ran."""


def read(layer):
    n = layer["trace"].kernel_count("detectorch_nms")
    return n / layer["requests"] if n else None
