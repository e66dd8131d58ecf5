"""Multilevel FPN RoIAlign forward: the CUDA kernel's build, binding and wrapper.

Replaces the Pallas TPU kernel ``_roi_align_pallas_batched``
(``detectorch_tpu/ops/pallas/roi_align_kernel.py:164``); the kernel itself and
a note on its design are in ``detectorch_tpu_torch/csrc/roi_align_fwd.cu``.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C entry point, at first use, into ``build/detectorch_tpu_torch/`` at
the root of the checkout; the library's name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
It is loaded with ``ctypes`` and launched on PyTorch's current stream.

``roi_align_fwd(...)`` dispatches on where its tensors lie: CPU tensors run
the plain PyTorch version (``ops/roi_align.multilevel_roi_align``); CUDA
tensors launch the kernel or raise — there is no fallback on CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import torch

from detectorch_tpu_torch.ops import roi_align as plain

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "roi_align_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "detectorch_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
PRECISIONS = ("exact",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 8


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def check_precision(fwd_precision: str) -> None:
    """The port computes RoIAlign exactly; any other tier is refused rather
    than silently run at another precision."""
    if fwd_precision not in PRECISIONS:
        raise ValueError(f"roi_align_fwd_precision {fwd_precision!r} is not "
                         f"supported by the port; supported: {PRECISIONS}")


class RoIAlignForward:
    """The kernel's wrapper. ``launches`` counts kernel launches (CPU calls
    that run the plain version do not count); ``build_log`` keeps nvcc's
    ``-Xptxas -v`` report of the last build."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def build(self) -> Path:
        """Compile (if no library for this source exists yet) and load."""
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"roi_align_fwd-{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True,
                )
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {SOURCE}:\n{self.build_log}")
                os.replace(tmp, lib_path)  # atomic: concurrent builds of one source agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        if self._lib is None:
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.roi_align_fwd
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ]
            self._lib = lib
        return lib_path

    def __call__(
        self,
        feature_list: Sequence[torch.Tensor],
        rois: torch.Tensor,
        batch_idx: torch.Tensor,
        levels: torch.Tensor,
        level_scales: Sequence[float],
        pooled_h: int,
        pooled_w: int,
        sampling_ratio: int = 2,
        max_grid: int = 8,
        fwd_precision: str = "exact",
    ) -> torch.Tensor:
        """RoIAlign over FPN levels: (R, PH, PW, C) fp32.

        feature_list: per level (B, H_l, W_l, C) NHWC, finest first; rois
        (R, 4) fp32 image-space xyxy; batch_idx and levels (R,) int32.
        """
        check_precision(fwd_precision)
        tensors = [*feature_list, rois, batch_idx, levels]
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise ValueError(f"RoIAlign inputs lie on several devices: {devices}")
        if rois.device.type == "cpu":
            return plain.multilevel_roi_align(
                feature_list, rois, batch_idx, levels, level_scales,
                pooled_h, pooled_w, sampling_ratio, max_grid)
        if rois.device.type != "cuda":
            raise ValueError(f"RoIAlign kernel needs CUDA tensors, got {rois.device}")
        return self._launch(feature_list, rois, batch_idx, levels, level_scales,
                            pooled_h, pooled_w, sampling_ratio, max_grid)

    def _launch(self, feature_list, rois, batch_idx, levels, level_scales,
                pooled_h, pooled_w, sampling_ratio, max_grid):
        n_lvl = len(feature_list)
        if not 1 <= n_lvl <= _MAX_LEVELS or len(level_scales) != n_lvl:
            raise ValueError(f"need 1..{_MAX_LEVELS} levels with one scale each")
        f0 = feature_list[0]
        if f0.dtype not in _DTYPES:
            raise TypeError(f"features must be float32 or bfloat16, got {f0.dtype}")
        num_images, channels = f0.shape[0], f0.shape[-1]
        if channels % 8:
            raise ValueError(f"channels must be a multiple of 8, got {channels}")
        for f in feature_list:
            if f.dim() != 4 or f.dtype != f0.dtype or f.shape[0] != num_images \
                    or f.shape[-1] != channels:
                raise ValueError("levels must be (B, H_l, W_l, C) of one dtype, B and C")
            # NHWC with channel-contiguous pixels, rows and images; a
            # channels_last NCHW tensor permuted to NHWC passes as it is
            if not f.is_contiguous() or f.data_ptr() % 16:
                raise ValueError("levels must be contiguous NHWC, 16-byte aligned")
        r = rois.shape[0]
        if rois.dtype != torch.float32 or rois.shape != (r, 4) \
                or not rois.is_contiguous() or rois.data_ptr() % 16:
            raise ValueError("rois must be contiguous (R, 4) float32, 16-byte aligned")
        for name, t in (("batch_idx", batch_idx), ("levels", levels)):
            if t.dtype != torch.int32 or t.shape != (r,) or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous (R,) int32")
        if sampling_ratio < 0 or (sampling_ratio == 0 and max_grid < 1):
            raise ValueError("sampling_ratio must be > 0, or 0 with max_grid >= 1")

        out = torch.empty((r, pooled_h, pooled_w, channels), dtype=torch.float32,
                          device=rois.device)
        if r == 0:
            return out
        if self._lib is None:
            self.build()
        ptrs = (ctypes.c_void_p * n_lvl)(*[f.data_ptr() for f in feature_list])
        strides = (ctypes.c_longlong * n_lvl)(*[f.stride(0) for f in feature_list])
        heights = (ctypes.c_int * n_lvl)(*[f.shape[1] for f in feature_list])
        widths = (ctypes.c_int * n_lvl)(*[f.shape[2] for f in feature_list])
        scales = (ctypes.c_float * n_lvl)(*[float(s) for s in level_scales])
        err = self._lib.roi_align_fwd(
            rois.device.index, _DTYPES[f0.dtype], n_lvl, ptrs, strides, heights,
            widths, scales, num_images, rois.data_ptr(), batch_idx.data_ptr(),
            levels.data_ptr(), r, channels, pooled_h, pooled_w, sampling_ratio,
            max_grid, out.data_ptr(),
            torch.cuda.current_stream(rois.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"roi_align_fwd launch failed: CUDA error {err}")
        self.launches += 1
        return out


roi_align_fwd = RoIAlignForward()
