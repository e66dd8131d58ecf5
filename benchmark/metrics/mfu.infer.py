"""The whole request's share of the H100's dense bf16 peak, in %: the
benchmark's count of conv, linear and RoIAlign work an image
(harness/flops) times the window's img/s, over 989 TFLOP/s."""

from benchmark.harness.flops import BF16_FLOPS_PER_S


def read(layer):
    return 100.0 * layer["flops_per_image"] * layer["img_per_s"] / BF16_FLOPS_PER_S
