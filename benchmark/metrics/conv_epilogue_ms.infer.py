"""Device ms a request of the conv epilogue kernels (named
detectorch_conv_epilogue in the profiler's trace). Nothing to read where no
such kernel ran."""


def read(layer):
    if not layer["trace"].kernel_count("detectorch_conv_epilogue"):
        return None
    return layer["trace"].kernel_s("detectorch_conv_epilogue") * 1e3 / layer["requests"]
