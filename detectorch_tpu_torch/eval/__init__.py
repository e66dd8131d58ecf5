"""Detection postprocessing in PyTorch."""
