"""detectorch_tpu_torch — the PyTorch + CUDA port of detectorch_tpu for Hopper.

The JAX package ``detectorch_tpu`` is the reference; this package mirrors its
module names so each function has an obvious counterpart. It imports
``torch`` and never ``jax``: the only thing it takes from the JAX package is
``detectorch_tpu.config`` (``PRESETS``, ``ModelConfig``, ``TestConfig``),
which is free of JAX.

The FPN RoIAlign forward runs as a hand-written CUDA kernel
(``csrc/roi_align_fwd.cu``, wrapped by ``ops/cuda/roi_align_kernel.py``) on
CUDA tensors; on CPU tensors the same wrapper runs the plain PyTorch version
in ``ops/roi_align.py``.
"""

__version__ = "0.1.0"
