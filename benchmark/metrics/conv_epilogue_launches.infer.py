"""Conv epilogue kernel launches a request (the kernels named
detectorch_conv_epilogue in the profiler's trace: bias, shortcut and relu
after each of the trunk's frozen-BN convs and each FPN neck conv). Nothing
to read where no such kernel ran."""


def read(layer):
    n = layer["trace"].kernel_count("detectorch_conv_epilogue")
    return n / layer["requests"] if n else None
