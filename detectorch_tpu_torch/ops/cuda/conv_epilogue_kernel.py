"""The trunk's frozen-BN conv epilogue on the card: the CUDA kernels' build,
binding and wrappers, and their plain PyTorch mirrors.

The kernels (``detectorch_tpu_torch/csrc/conv_epilogue.cu``, design note
there) replace no Pallas kernel: they take the place of the PyTorch
operators that ran the frozen-BN affine, the residual add and the relu after
each of the trunk's convs. They are built and loaded as the other kernels
are (``roi_align_kernel.build_library``, ``_Kernel``: nvcc for ``sm_90a``
into ``build/detectorch_tpu_torch/``, ``ctypes``, PyTorch's current stream).

  * ``fold_scale(w, s, dtype)``: the conv's weight with the BN scale folded
    in, ``W * s[o]`` in fp32 rounded once to ``dtype``, in w's layout.
  * ``conv_epilogue(y, b, residual, relu)``: ``y <- act((y + b[c]) (+ r))``
    in place on a conv's channels_last output, in fp32, rounded once.

Each wrapper checks its tensors and raises on what the kernel does not
take; CPU tensors run the mirror (``fold_mirror``, ``epilogue_mirror``:
the same arithmetic in PyTorch), CUDA tensors launch the kernel or raise.
Neither records anything for autograd, so both refuse operands that
autograd would record (``models/resnet`` runs the unfused form there).
"""

from __future__ import annotations

import ctypes

import torch

from detectorch_tpu_torch.ops.cuda.roi_align_kernel import CSRC, _Kernel, _one_device

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LANES = 8             # channels of a 16-byte bf16 vector: C must be a multiple of it
MAX_CHANNELS = 2048   # kMaxChannels in conv_epilogue.cu: the bias table, 8 KB of fp32


def _refuse_autograd(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} records nothing for autograd; it got operands that "
                           "require grad with grad mode on")


def epilogue_mirror(y, bias, residual=None, relu: bool = True):
    """The epilogue kernel's arithmetic in PyTorch: (y + bias[c]) + residual
    in fp32, relu, rounded once to y's dtype and written into y."""
    z = y.float() + bias[:, None, None]
    if residual is not None:
        z += residual.float()
    if relu:
        z.clamp_min_(0)
    return y.copy_(z)


def fold_mirror(w, scale, dtype):
    """The fold kernel's arithmetic in PyTorch: W * s[o] in fp32, rounded
    once to `dtype`."""
    return (w * scale[:, None, None, None]).to(dtype)


class ConvEpilogue(_Kernel):
    """The epilogue kernel's wrapper: one launch a call."""

    source = CSRC / "conv_epilogue.cu"
    symbol = "detectorch_conv_epilogue"
    argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def __call__(self, y: torch.Tensor, bias: torch.Tensor, residual=None,
                 relu: bool = True) -> torch.Tensor:
        """y <- act((y + bias[c]) (+ residual)) in place; returns y.

        y (N, C, H, W) float32 or bfloat16 in channels_last memory, C a
        multiple of 8 up to 2048; bias (C,) float32; residual None or of y's
        shape, dtype and layout; all on one device."""
        operands = [y, bias] + ([residual] if residual is not None else [])
        device = _one_device(operands, "the conv epilogue")
        _refuse_autograd("the conv epilogue", *operands)
        if y.dim() != 4 or y.dtype not in _DTYPES:
            raise TypeError(f"y must be 4-D float32 or bfloat16, got {y.dtype} {tuple(y.shape)}")
        c = y.shape[1]
        if c % LANES or c > MAX_CHANNELS:
            raise ValueError(f"channels must be a multiple of {LANES} up to {MAX_CHANNELS}, "
                             f"got {c}")
        if not y.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("y must be channels_last contiguous")
        if bias.dtype != torch.float32 or bias.shape != (c,) or not bias.is_contiguous():
            raise ValueError(f"bias must be contiguous ({c},) float32")
        if residual is not None and (
                residual.shape != y.shape or residual.dtype != y.dtype
                or not residual.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("the residual must be channels_last contiguous, of y's shape "
                             "and dtype")
        if device.type == "cpu":
            return epilogue_mirror(y, bias, residual, relu)
        if y.data_ptr() % 16 or (residual is not None and residual.data_ptr() % 16):
            raise ValueError("y and the residual must be 16-byte aligned")
        if y.numel() == 0:
            return y
        self._call(device.index, y.data_ptr(),
                   residual.data_ptr() if residual is not None else None, bias.data_ptr(),
                   y.numel(), c, _DTYPES[y.dtype], int(relu),
                   torch.cuda.current_stream(device).cuda_stream)
        return y


class FoldScale(_Kernel):
    """The fold kernel's wrapper: one launch a call."""

    source = CSRC / "conv_epilogue.cu"
    symbol = "detectorch_fold_scale"
    argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def __call__(self, w: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
        """W * scale[o] in fp32, rounded once to `dtype`, in w's memory
        layout. w (O, I, KH, KW) float32, contiguous or channels_last;
        scale (O,) float32; both on one device."""
        device = _one_device([w, scale], "the weight fold")
        _refuse_autograd("the weight fold", w, scale)
        if dtype not in _DTYPES:
            raise TypeError(f"the folded weight must be float32 or bfloat16, got {dtype}")
        if w.dim() != 4 or w.dtype != torch.float32 or not (
                w.is_contiguous() or w.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError("w must be 4-D float32, contiguous or channels_last")
        rows = w.shape[0]
        if scale.dtype != torch.float32 or scale.shape != (rows,) or not scale.is_contiguous():
            raise ValueError(f"scale must be contiguous ({rows},) float32")
        if device.type == "cpu":
            return fold_mirror(w, scale, dtype)
        out = torch.empty_like(w, dtype=dtype)  # w's strides: the output axis outermost
        if w.numel() == 0:
            return out
        if w.numel() >= 2 ** 31:
            raise ValueError(f"the fold takes fewer than 2**31 elements, got {w.numel()}")
        self._call(device.index, w.data_ptr(), scale.data_ptr(), out.data_ptr(), rows,
                   w.numel() // rows, _DTYPES[dtype],
                   torch.cuda.current_stream(device).cuda_stream)
        return out


conv_epilogue = ConvEpilogue()
fold_scale = FoldScale()
