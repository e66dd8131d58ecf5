"""Host-side training data: roidb targets (numpy, no JAX)."""
