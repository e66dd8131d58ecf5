"""Batched greedy NMS on the card: the CUDA kernel's build, binding and
wrapper, and a numpy mirror of its two stages.

The kernel (``detectorch_tpu_torch/csrc/nms.cu``, design note there)
replaces no Pallas kernel: it takes the place of ``ops/nms.batched_nms_blocked``
on CUDA tensors, whose fixpoint tests each cost a host sync. It is built and
loaded as the RoIAlign kernels are (``roi_align_kernel.build_library``,
``_Kernel``: nvcc for ``sm_90a`` into ``build/detectorch_tpu_torch/``,
``ctypes``, PyTorch's current stream). ``ops/nms.batched_nms`` chooses by
where the tensors lie: CPU tensors run the blocked version, CUDA tensors
sort their rows (``ops/nms.sort_rows``) and launch this kernel, or raise.

Its two stages are mirrored in numpy (``iou_words``, ``greedy_scan``,
``nms_mirror``) so that the CPU tests can hold its algorithm, words, chunks
and early stop included, to the blocked version and to JAX's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from detectorch_tpu_torch.ops.cuda.roi_align_kernel import CSRC, _Kernel, _one_device

WORD = 64  # boxes per mask word and per scan chunk (kWord in nms.cu)
_MAX_ROWS = 65535  # the mask kernel's grid.z
# the scan's `removed` words in the 48 KB of shared memory a launch takes,
# less 2 KB for its static arrays (260 bytes), alignment and what the
# runtime keeps; the C entry checks the exact limit (cudaFuncGetAttributes)
_MAX_WORDS = (48 * 1024 - 2048) // 8


def num_words(n: int) -> int:
    """Mask words per box: ceil(n / 64)."""
    return -(-n // WORD)


class BatchedNms(_Kernel):
    """The kernel's wrapper: one call launches the mask and the scan."""

    source = CSRC / "nms.cu"
    symbol = "detectorch_nms"
    kernels = 2
    argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]

    def __call__(self, sboxes: torch.Tensor, alive: torch.Tensor, order: torch.Tensor,
                 iou_thresh: float, max_out: int):
        """Greedy NMS over rows already sorted by ``ops/nms.sort_rows``.

        sboxes (M, N, 4) fp32, alive (M, N) bool, order (M, N) int64, all on
        one CUDA device. Returns keep_idx (M, max_out) int64 (``order`` at
        the first max_out kept positions, 0 in unfilled slots) and
        keep_valid (M, max_out) bool. No host sync.
        """
        device = _one_device([sboxes, alive, order], "NMS")
        if device.type != "cuda":
            raise ValueError(f"the NMS kernel needs CUDA tensors, got {device}")
        m, n = alive.shape
        if sboxes.dtype != torch.float32 or sboxes.shape != (m, n, 4) \
                or not sboxes.is_contiguous() or sboxes.data_ptr() % 16:
            raise ValueError("sboxes must be contiguous (M, N, 4) float32, 16-byte aligned")
        if alive.dtype != torch.bool or not alive.is_contiguous():
            raise ValueError("alive must be contiguous (M, N) bool")
        if order.dtype != torch.int64 or order.shape != (m, n) or not order.is_contiguous():
            raise ValueError("order must be contiguous (M, N) int64")
        if m > _MAX_ROWS or num_words(n) > _MAX_WORDS:
            raise ValueError(f"the NMS kernel takes at most {_MAX_ROWS} rows of at most "
                             f"{_MAX_WORDS * WORD} boxes, got ({m}, {n})")
        keep_idx = torch.empty((m, max_out), dtype=torch.int64, device=device)
        keep_valid = torch.empty((m, max_out), dtype=torch.bool, device=device)
        if m == 0 or max_out == 0:
            return keep_idx, keep_valid
        if n == 0:
            return keep_idx.zero_(), keep_valid.zero_()
        words = num_words(n)
        mask = torch.empty((m, n, words), dtype=torch.int64, device=device)
        self._call(
            device.index, sboxes.data_ptr(), alive.data_ptr(), order.data_ptr(), m, n, words,
            float(iou_thresh), max_out, mask.data_ptr(), keep_idx.data_ptr(),
            keep_valid.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
        return keep_idx, keep_valid


batched_nms_kernel = BatchedNms()


def iou_words(sboxes, alive, iou_thresh: float) -> np.ndarray:
    """Stage 1 in numpy: the (M, N, ceil(N/64)) uint64 mask. Bit b of word c
    of box i is set iff j = 64c + b > i and IoU(i, j) >= fp32(iou_thresh),
    with the kernel's fp32 arithmetic step by step; rows of dead boxes and
    words left of the diagonal block, which the kernel does not write, are
    0 here."""
    f = np.float32
    b = np.asarray(torch.as_tensor(sboxes, dtype=torch.float32).cpu())
    live = np.asarray(torch.as_tensor(alive).cpu()).astype(bool)
    m, n = live.shape
    area = ((b[..., 2] - b[..., 0]) + f(1)) * ((b[..., 3] - b[..., 1]) + f(1))
    iw = (np.fmin(b[:, :, None, 2], b[:, None, :, 2])
          - np.fmax(b[:, :, None, 0], b[:, None, :, 0])) + f(1)
    ih = (np.fmin(b[:, :, None, 3], b[:, None, :, 3])
          - np.fmax(b[:, :, None, 1], b[:, None, :, 1])) + f(1)
    inter = np.where(iw < 0, f(0), iw) * np.where(ih < 0, f(0), ih)
    union = (area[:, :, None] + area[:, None, :]) - inter
    hit = (union > 0) & (inter > 0)
    iou = np.zeros_like(inter)
    iou[hit] = inter[hit] / union[hit]
    bits = (iou >= f(iou_thresh)) & np.triu(np.ones((n, n), bool), 1) & live[:, :, None]
    words = num_words(n)
    bits = np.pad(bits, ((0, 0), (0, 0), (0, words * WORD - n)))
    return np.packbits(bits, axis=-1, bitorder="little").view("<u8").reshape(m, n, words)


def greedy_scan(mask: np.ndarray, alive, order, max_out: int):
    """Stage 2 in numpy, as each CTA runs it: per row, 64-box chunks in
    order; the chunk's live, not yet removed boxes resolved lowest first
    against the diagonal words, each kept box written to the next slot;
    then the kept boxes' words ORed into the later chunks; the walk stops at
    max_out kept. Returns (keep_idx (M, max_out) int64, keep_valid bool)."""
    live = np.asarray(torch.as_tensor(alive).cpu()).astype(bool)
    order = np.asarray(torch.as_tensor(order).cpu())
    m, n = live.shape
    words = num_words(n)
    keep_idx = np.zeros((m, max_out), np.int64)
    keep_valid = np.zeros((m, max_out), bool)
    for r in range(m):
        removed = np.zeros(words, np.uint64)
        filled = 0
        for c in range(words):
            if filled >= max_out:
                break
            base = c * WORD
            remaining = sum(1 << b for b in range(min(WORD, n - base)) if live[r, base + b])
            remaining &= ~int(removed[c])
            kept = []
            while remaining and filled < max_out:
                b = (remaining & -remaining).bit_length() - 1
                keep_idx[r, filled] = order[r, base + b]
                keep_valid[r, filled] = True
                filled += 1
                kept.append(b)
                remaining &= remaining - 1
                remaining &= ~int(mask[r, base + b, c])
            if kept and filled < max_out:
                removed[c + 1:] |= np.bitwise_or.reduce(mask[r, [base + b for b in kept], c + 1:])
    return keep_idx, keep_valid


def nms_mirror(sboxes, alive, order, iou_thresh: float, max_out: int):
    """Both stages in numpy, on ``ops/nms.sort_rows``'s output: what the
    kernel returns for the same inputs."""
    return greedy_scan(iou_words(sboxes, alive, iou_thresh), alive, order, max_out)
