"""Entry points, run as ``python -m detectorch_tpu_torch.tools.<name>``."""
