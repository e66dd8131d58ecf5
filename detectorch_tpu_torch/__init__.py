"""detectorch_tpu_torch — the PyTorch + CUDA port of detectorch_tpu for Hopper.

The JAX package ``detectorch_tpu`` is the reference; this package mirrors its
module names so each function has an obvious counterpart. It imports
``torch`` and never ``jax``, and no module of the JAX package: the host
modules it needs (``config``, ``data/{coco,transforms,loader}``,
``train/sampler``, ``eval/{rle,coco_eval,mask_paste,results_io}``,
``utils/{stats,timer}``) are its own copies, under the same paths.

The FPN RoIAlign forward and its feature gradient run as hand-written CUDA
kernels (``csrc/roi_align_fwd.cu``, ``csrc/roi_align_bwd.cu``, wrapped by
``ops/cuda/roi_align_kernel.py``) on CUDA tensors; on CPU tensors the same
wrappers run the plain PyTorch versions in ``ops/roi_align.py``.
"""

__version__ = "0.1.0"
