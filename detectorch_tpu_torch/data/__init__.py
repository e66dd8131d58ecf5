"""Input data: roidb targets (numpy, no JAX) and on-device preprocessing."""
