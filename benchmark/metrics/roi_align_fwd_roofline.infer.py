"""The forward RoIAlign kernel's share of its roofline, in %: the least
time of its calls (touched feature bytes read once, rois read, the fp32
output written, or its fp32 operations; harness/flops.roi_align_calls)
over the kernel's time in the profiler's trace. Nothing to read where the
kernel did not run."""


def read(layer):
    r = layer["roi_align_fwd"]
    if not r["launches"] or r["kernel_ms"] <= 0:
        return None
    return 100.0 * r["bound_ms"] / r["kernel_ms"]
