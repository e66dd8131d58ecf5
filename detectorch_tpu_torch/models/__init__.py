"""Backbone, FPN neck, RPN, heads and the detector assembly in PyTorch."""
