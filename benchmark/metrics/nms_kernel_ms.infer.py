"""Device ms a request of the NMS kernels (named detectorch_nms in the
profiler's trace). Nothing to read where no such kernel ran."""


def read(layer):
    if not layer["trace"].kernel_count("detectorch_nms"):
        return None
    return layer["trace"].kernel_s("detectorch_nms") * 1e3 / layer["requests"]
