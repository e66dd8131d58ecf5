"""The share of the traced requests' window in which no operation ran on
the device, in %."""


def read(layer):
    tr = layer["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
