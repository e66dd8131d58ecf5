"""detectorch_tpu_torch — the PyTorch + CUDA port of detectorch_tpu for Hopper.

The JAX package ``detectorch_tpu`` is the reference; this package mirrors its
module names so each function has an obvious counterpart. It imports
``torch`` and never ``jax``: from the JAX package it takes only modules that
stay free of JAX when called — ``detectorch_tpu.config`` (``PRESETS`` and the
config dataclasses), the host-side data path (``data.coco``,
``data.transforms``, ``data.loader``, ``train.sampler.sample_rois`` with
targets set), the host-side evaluation (``eval.rle``, ``eval.mask_paste``,
``eval.coco_eval``, ``eval.results_io``) and ``utils.stats``.

The FPN RoIAlign forward and its feature gradient run as hand-written CUDA
kernels (``csrc/roi_align_fwd.cu``, ``csrc/roi_align_bwd.cu``, wrapped by
``ops/cuda/roi_align_kernel.py``) on CUDA tensors; on CPU tensors the same
wrappers run the plain PyTorch versions in ``ops/roi_align.py``.
"""

__version__ = "0.1.0"
