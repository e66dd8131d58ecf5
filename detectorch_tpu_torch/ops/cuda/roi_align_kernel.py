"""Multilevel RoIAlign forward and backward (the FPN pyramid, or C4's one
level): the CUDA kernels' build, binding and wrappers.

  * ``roi_align_fwd`` replaces the Pallas TPU kernel
    ``_roi_align_pallas_batched``
    (``detectorch_tpu/ops/pallas/roi_align_kernel.py:164``); kernel and design
    note in ``detectorch_tpu_torch/csrc/roi_align_fwd.cu``.
  * ``roi_align_bwd`` replaces ``_slab_grad_group`` (same file, ``:489``); kernel
    and design note in ``detectorch_tpu_torch/csrc/roi_align_bwd.cu``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C entry point, at first use, into ``build/detectorch_tpu_torch/`` at
the root of the checkout; the library's name carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
It is loaded with ``ctypes`` and launched on PyTorch's current stream.

Each wrapper dispatches on where its tensors lie: CPU tensors run the plain
PyTorch version (``ops/roi_align.multilevel_roi_align`` and
``multilevel_roi_align_backward``); CUDA tensors launch the kernel or raise —
there is no fallback on CUDA.

The C4 call site (``roi_align_c4``, ``roi_align_c4_bwd``) runs the same two
kernels with one level at the C4 scale and the adaptive grid (sampling_ratio
0, max_grid 8); on CPU tensors its plain versions are the separable
``ops/roi_align.roi_align_matmul`` and its gradient, JAX's C4 formulation.

What each kernel decides per roi is mirrored here in numpy, so that the CPU
tests can hold it to the plain version: the forward's tap plan
(``fwd_tap_plan``) and the backward's per-tile roi lists
(``roi_tile_lists``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from detectorch_tpu_torch.ops import roi_align as plain

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "detectorch_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
PRECISIONS = ("exact",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 8
TILE = 8          # the backward kernel's output tile (kTile in roi_align_bwd.cu)
_MAX_POOLED = 16  # kMaxPooled in roi_align_bwd.cu


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


def build_library(source: Path) -> Tuple[Path, str]:
    """Compile `source` with nvcc into ``BUILD_DIR/<stem>-<hash>.so``, unless
    a library for this source and these flags exists already. Returns its
    path and nvcc's ``-Xptxas -v`` report ("" when it was reused)."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    lib_path = BUILD_DIR / f"{source.stem}-{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds of one source agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, log


class _Kernel:
    """A kernel's library, entry point and launch count. ``launches`` counts
    kernel launches, ``kernels`` per call (CPU calls that run the plain
    version do not count);
    ``build_log`` keeps nvcc's ``-Xptxas -v`` report of the last build.
    ``observers`` are called with every call's geometry, on the CPU and on
    the card: (level shapes, rois, batch_idx, levels, level_scales,
    pooled_h, pooled_w, sampling_ratio, max_grid) (the FLOP count of
    ``tools/measure`` reads them)."""

    source: Path
    symbol: str
    argtypes: list
    kernels = 1

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self.observers = []
        self._fn = None

    def observe(self, level_shapes, *geometry):
        for fn in self.observers:
            fn([tuple(int(d) for d in s) for s in level_shapes], *geometry)

    def build(self) -> Path:
        """Compile (if no library for this source exists yet) and load."""
        lib_path, log = build_library(self.source)
        if log:
            self.build_log = log
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(lib_path)), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        return lib_path

    def _call(self, *args):
        if self._fn is None:
            self.build()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {err}")
        self.launches += self.kernels


def _int_array(values):
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def _check_indices(rois, batch_idx, levels):
    r = rois.shape[0]
    if rois.dtype != torch.float32 or rois.shape != (r, 4) \
            or not rois.is_contiguous() or rois.data_ptr() % 16:
        raise ValueError("rois must be contiguous (R, 4) float32, 16-byte aligned")
    for name, t in (("batch_idx", batch_idx), ("levels", levels)):
        if t.dtype != torch.int32 or t.shape != (r,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (R,) int32")


def _one_device(tensors, what: str) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} kernel needs CUDA tensors, got {device}")
    return device


class RoIAlignForward(_Kernel):
    """The forward kernel's wrapper."""

    source = CSRC / "roi_align_fwd.cu"
    symbol = "roi_align_fwd"
    argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]

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
        """RoIAlign over levels (FPN's, or C4's one): (R, PH, PW, C) fp32.

        feature_list: per level (B, H_l, W_l, C) NHWC, finest first; rois
        (R, 4) fp32 image-space xyxy; batch_idx and levels (R,) int32.
        """
        check_precision(fwd_precision)
        self.observe([f.shape for f in feature_list], rois, batch_idx, levels, level_scales,
                     pooled_h, pooled_w, sampling_ratio, max_grid)
        if _one_device([*feature_list, rois, batch_idx, levels], "RoIAlign").type == "cpu":
            return plain.multilevel_roi_align(
                feature_list, rois, batch_idx, levels, level_scales,
                pooled_h, pooled_w, sampling_ratio, max_grid)
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
        _check_indices(rois, batch_idx, levels)
        r = rois.shape[0]
        if sampling_ratio < 0 or (sampling_ratio == 0 and max_grid < 1):
            raise ValueError("sampling_ratio must be > 0, or 0 with max_grid >= 1")

        out = torch.empty((r, pooled_h, pooled_w, channels), dtype=torch.float32,
                          device=rois.device)
        if r == 0:
            return out
        ptrs = (ctypes.c_void_p * n_lvl)(*[f.data_ptr() for f in feature_list])
        strides = (ctypes.c_longlong * n_lvl)(*[f.stride(0) for f in feature_list])
        heights = (ctypes.c_int * n_lvl)(*[f.shape[1] for f in feature_list])
        widths = (ctypes.c_int * n_lvl)(*[f.shape[2] for f in feature_list])
        scales = (ctypes.c_float * n_lvl)(*[float(s) for s in level_scales])
        self._call(
            rois.device.index, _DTYPES[f0.dtype], n_lvl, ptrs, strides, heights,
            widths, scales, num_images, rois.data_ptr(), batch_idx.data_ptr(),
            levels.data_ptr(), r, channels, pooled_h, pooled_w, sampling_ratio,
            max_grid, out.data_ptr(),
            torch.cuda.current_stream(rois.device).cuda_stream,
        )
        return out


def tile_tables(level_shapes, tile: int = TILE):
    """The backward kernel's output tiles: tile x tile pixels, numbered
    level-major, then image, then row-major within the level. level_shapes:
    per level (B, H_l, W_l). Returns per level the tiles along a row and
    per image, and each level's first tile id (plus the total at the end)."""
    num_images = int(level_shapes[0][0])
    tiles_x = [-(-int(s[2]) // tile) for s in level_shapes]
    tiles_per_image = [-(-int(s[1]) // tile) * tx for s, tx in zip(level_shapes, tiles_x)]
    tile_base = [0]
    for n in tiles_per_image:
        tile_base.append(tile_base[-1] + num_images * n)
    return tiles_x, tiles_per_image, tile_base


def scratch_ints(num_rois: int, num_tiles: int, max_tiles_per_image: int) -> int:
    """int32 scratch of the backward kernel, from shapes alone: per roi its
    tile range (4), per tile a count and a first slot (plus the total), and
    room for every roi in every tile of one image of its level."""
    return 4 * num_rois + 2 * num_tiles + 1 + num_rois * max_tiles_per_image


def _sample_coord(start, bin_size, grid, p, i):
    """The kernels' sample_coord, in float32 step by step."""
    f = np.float32
    return f(f(start + f(f(p) * bin_size)) + f(f(f(i) + f(0.5)) * bin_size) / f(grid))


def tile_span(start, bin_size, grid, pooled, size, tile: int = TILE):
    """The backward kernel's tile_span: tiles [lo, hi] along one axis that a
    roi's taps can reach (one pixel of slack on each side)."""
    top = np.float32(size - 1)
    first = min(max(_sample_coord(start, bin_size, grid, 0, 0), 0), top)
    last = min(max(_sample_coord(start, bin_size, grid, pooled - 1, grid - 1), 0), top)
    lo = max(int(np.floor(first)) - 1, 0)
    hi = min(int(np.floor(last)) + 2, size - 1)
    return lo // tile, hi // tile


def roi_geometry_f32(box, scale, pooled_h, pooled_w, sampling_ratio=2, max_grid=8):
    """The kernels' roi_geometry in float32 step by step: (start_h, start_w,
    bin_h, bin_w, grid_h, grid_w)."""
    f = np.float32
    s = f(scale)
    x1, y1, x2, y2 = (f(v) for v in box)
    start_w, start_h = f(x1 * s), f(y1 * s)
    bin_w = f(max(f(f(x2 * s) - start_w), f(1)) / f(pooled_w))
    bin_h = f(max(f(f(y2 * s) - start_h), f(1)) / f(pooled_h))
    grid_h = grid_w = sampling_ratio
    if sampling_ratio <= 0:
        grid_h = int(min(max(np.ceil(bin_h), 1), max_grid))
        grid_w = int(min(max(np.ceil(bin_w), 1), max_grid))
    return start_h, start_w, bin_h, bin_w, grid_h, grid_w


def axis_taps(start, bin_size, grid, p, size):
    """The forward kernel's axis_taps, in float32 step by step: the distinct
    rows (or columns) of `size` that the `grid` samples of bin p reach along
    one axis, ascending, and their summed bilinear weights. Samples outside
    [-1, size] add nothing; a sample clamped onto the last row gives both of
    its weights to it. Returns (taps, weights) as lists."""
    f = np.float32
    taps, weights = [], []

    def add(t, w):
        for k in (-1, -2):  # a new tap matches one of the last two, or is new
            if len(taps) >= -k and taps[k] == t:
                weights[k] = f(weights[k] + w)
                return
        taps.append(t)
        weights.append(w)

    fsize = f(size)
    for i in range(grid):
        y = _sample_coord(start, bin_size, grid, p, i)
        if y < -1 or y > fsize:
            continue
        y = min(max(y, f(0)), f(fsize - 1))
        y0 = int(np.floor(y))
        y1 = min(y0 + 1, size - 1)
        ly = f(y - f(y0))
        add(y0, f(f(1) - ly))
        add(y1, ly)
    return taps, weights


def fwd_tap_plan(feature_shapes, rois, batch_idx, levels, level_scales, pooled_h, pooled_w,
                 sampling_ratio=2, max_grid=8):
    """The forward kernel's tap plan, built on the CPU as each of its blocks
    builds it: per roi None for a level or image out of range (the block
    stages nothing and writes zeros), else a dict with its ``level``,
    ``image``, ``inv_count`` and, per bin row ph, ``rows[ph]`` = (rows,
    weights) and per bin column pw ``cols[pw]`` = (columns, weights): the
    feature rows and columns that the kernel loads for the roi's bins, with
    the weights it sums them by."""
    shapes = [tuple(int(d) for d in s[:3]) for s in feature_shapes]
    rois = np.asarray(torch.as_tensor(rois, dtype=torch.float32).cpu())
    batch_idx = np.asarray(torch.as_tensor(batch_idx).cpu())
    levels = np.asarray(torch.as_tensor(levels).cpu())
    plans = []
    for r in range(len(rois)):
        lvl, b = int(levels[r]), int(batch_idx[r])
        if not (0 <= lvl < len(shapes) and 0 <= b < shapes[0][0]):
            plans.append(None)
            continue
        _, height, width = shapes[lvl]
        sh, sw, bh, bw, gh, gw = roi_geometry_f32(rois[r], level_scales[lvl], pooled_h,
                                                  pooled_w, sampling_ratio, max_grid)
        plans.append({
            "level": lvl, "image": b,
            "inv_count": np.float32(np.float32(1) / np.float32(gh * gw)),
            "rows": [axis_taps(sh, bh, gh, ph, height) for ph in range(pooled_h)],
            "cols": [axis_taps(sw, bw, gw, pw, width) for pw in range(pooled_w)],
        })
    return plans


def roi_tile_lists(feature_shapes, rois, batch_idx, levels, level_scales, pooled_h, pooled_w,
                   sampling_ratio=2, max_grid=8):
    """The backward kernel's per-tile roi lists, built on the CPU as its
    kernels build them: per roi the tile range of its level and image (none
    for a level or image out of range), a count per tile, an exclusive scan
    into first slots, and a fill in ascending roi order — the order that the
    kernel's sort restores. Returns (starts, lists) as numpy int64: tile t's
    rois are lists[starts[t]:starts[t + 1]]."""
    shapes = [tuple(int(d) for d in s[:3]) for s in feature_shapes]
    tiles_x, tiles_per_image, tile_base = tile_tables(shapes)
    rois = np.asarray(torch.as_tensor(rois, dtype=torch.float32).cpu())
    batch_idx = np.asarray(torch.as_tensor(batch_idx).cpu())
    levels = np.asarray(torch.as_tensor(levels).cpu())
    tiles_of = []
    for r in range(len(rois)):
        lvl, b = int(levels[r]), int(batch_idx[r])
        if not (0 <= lvl < len(shapes) and 0 <= b < shapes[0][0]):
            tiles_of.append([])
            continue
        sh, sw, bh, bw, gh, gw = roi_geometry_f32(rois[r], level_scales[lvl], pooled_h,
                                                  pooled_w, sampling_ratio, max_grid)
        ty0, ty1 = tile_span(sh, bh, gh, pooled_h, shapes[lvl][1])
        tx0, tx1 = tile_span(sw, bw, gw, pooled_w, shapes[lvl][2])
        first = tile_base[lvl] + b * tiles_per_image[lvl]
        tiles_of.append([first + ty * tiles_x[lvl] + tx
                         for ty in range(ty0, ty1 + 1) for tx in range(tx0, tx1 + 1)])
    counts = np.zeros(tile_base[-1], np.int64)
    for tiles in tiles_of:
        counts[tiles] += 1
    starts = np.concatenate([[0], np.cumsum(counts)])
    lists = np.zeros(starts[-1], np.int64)
    cursor = starts[:-1].copy()
    for r, tiles in enumerate(tiles_of):
        lists[cursor[tiles]] = r
        cursor[tiles] += 1
    return starts, lists


class RoIAlignBackward(_Kernel):
    """The backward kernel's wrapper: the feature gradient of RoIAlign."""

    source = CSRC / "roi_align_bwd.cu"
    symbol = "roi_align_bwd"
    argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]

    def __call__(
        self,
        g: torch.Tensor,
        feature_shapes: Sequence[Sequence[int]],
        rois: torch.Tensor,
        batch_idx: torch.Tensor,
        levels: torch.Tensor,
        level_scales: Sequence[float],
        pooled_h: int,
        pooled_w: int,
        sampling_ratio: int = 2,
        max_grid: int = 8,
        out_dtype: torch.dtype = torch.float32,
    ) -> List[torch.Tensor]:
        """Feature gradient: per level (B, H_l, W_l, C) in `out_dtype`.

        g: (R, PH, PW, C) fp32 cotangent of the forward's output;
        feature_shapes: per level (B, H_l, W_l, C); rois (R, 4) fp32;
        batch_idx and levels (R,) int32. Summed in fp32, rounded once.
        """
        self.observe(feature_shapes, rois, batch_idx, levels, level_scales, pooled_h, pooled_w,
                     sampling_ratio, max_grid)
        if _one_device([g, rois, batch_idx, levels], "RoIAlign backward").type == "cpu":
            return plain.multilevel_roi_align_backward(
                g, feature_shapes, rois, batch_idx, levels, level_scales,
                pooled_h, pooled_w, sampling_ratio, max_grid, out_dtype)
        return self._launch(g, feature_shapes, rois, batch_idx, levels, level_scales,
                            pooled_h, pooled_w, sampling_ratio, max_grid, out_dtype)

    def _launch(self, g, feature_shapes, rois, batch_idx, levels, level_scales,
                pooled_h, pooled_w, sampling_ratio, max_grid, out_dtype):
        shapes = [tuple(int(d) for d in s) for s in feature_shapes]
        n_lvl = len(shapes)
        if not 1 <= n_lvl <= _MAX_LEVELS or len(level_scales) != n_lvl:
            raise ValueError(f"need 1..{_MAX_LEVELS} levels with one scale each")
        if out_dtype not in _DTYPES:
            raise TypeError(f"gradients must be float32 or bfloat16, got {out_dtype}")
        num_images, channels = shapes[0][0], shapes[0][-1]
        if channels % 8:
            raise ValueError(f"channels must be a multiple of 8, got {channels}")
        if any(len(s) != 4 or s[0] != num_images or s[-1] != channels for s in shapes):
            raise ValueError("levels must be (B, H_l, W_l, C) of one B and C")
        _check_indices(rois, batch_idx, levels)
        r = rois.shape[0]
        if g.dtype != torch.float32 or g.shape != (r, pooled_h, pooled_w, channels) \
                or not g.is_contiguous() or g.data_ptr() % 16:
            raise ValueError("g must be contiguous (R, PH, PW, C) float32, 16-byte aligned")
        if not (1 <= pooled_h <= _MAX_POOLED and 1 <= pooled_w <= _MAX_POOLED):
            raise ValueError(f"pooled sizes must lie in 1..{_MAX_POOLED}")
        if sampling_ratio < 0 or (sampling_ratio == 0 and max_grid < 1):
            raise ValueError("sampling_ratio must be > 0, or 0 with max_grid >= 1")

        outs = [torch.empty(s, dtype=out_dtype, device=g.device) for s in shapes]
        tiles_x, tiles_per_image, tile_base = tile_tables([s[:3] for s in shapes])
        scratch = torch.empty(scratch_ints(r, tile_base[-1], max(tiles_per_image)),
                              dtype=torch.int32, device=g.device)
        ptrs = (ctypes.c_void_p * n_lvl)(*[o.data_ptr() for o in outs])
        scales = (ctypes.c_float * n_lvl)(*[float(s) for s in level_scales])
        self._call(
            g.device.index, _DTYPES[out_dtype], n_lvl, ptrs,
            _int_array([s[1] for s in shapes]), _int_array([s[2] for s in shapes]), scales,
            _int_array(tiles_x), _int_array(tiles_per_image), _int_array(tile_base), num_images,
            g.data_ptr(), rois.data_ptr(), batch_idx.data_ptr(), levels.data_ptr(), r,
            scratch.data_ptr(), scratch.numel(), channels, pooled_h, pooled_w, sampling_ratio,
            max_grid, torch.cuda.current_stream(g.device).cuda_stream,
        )
        return outs


roi_align_fwd = RoIAlignForward()
roi_align_bwd = RoIAlignBackward()


def _one_level(rois):
    """(B, N, 4) rois of one level -> (B*N, 4) fp32, image indices and
    level indices (all 0), as the kernels take them."""
    bsz, n = rois.shape[:2]
    flat = rois.reshape(bsz * n, 4).float().contiguous()
    bidx = torch.arange(bsz, dtype=torch.int32, device=rois.device).repeat_interleave(n)
    return flat, bidx, torch.zeros(bsz * n, dtype=torch.int32, device=rois.device)


def roi_align_c4(features, rois, pooled_h: int, pooled_w: int, spatial_scale: float,
                 sampling_ratio: int = 0, max_grid: int = 8) -> torch.Tensor:
    """C4 RoIAlign: features (B, H, W, C) NHWC of one level, rois (B, N, 4)
    image-space xyxy -> (B, N, PH, PW, C) fp32; one forward kernel launch
    for the whole batch on CUDA tensors, ``roi_align_matmul`` on CPU ones."""
    if _one_device([features, rois], "C4 RoIAlign").type == "cpu":
        if roi_align_fwd.observers:
            roi_align_fwd.observe([features.shape], *_one_level(rois), (spatial_scale,),
                                  pooled_h, pooled_w, sampling_ratio, max_grid)
        return plain.roi_align_matmul(features, rois, pooled_h, pooled_w, spatial_scale,
                                      sampling_ratio, max_grid)
    bsz, n = rois.shape[:2]
    out = roi_align_fwd([features.contiguous()], *_one_level(rois), (spatial_scale,),
                        pooled_h, pooled_w, sampling_ratio, max_grid)
    return out.reshape(bsz, n, pooled_h, pooled_w, -1)


def roi_align_c4_bwd(g, feature_shape, rois, pooled_h: int, pooled_w: int,
                     spatial_scale: float, sampling_ratio: int = 0, max_grid: int = 8,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Feature gradient of ``roi_align_c4``: g (B, N, PH, PW, C) fp32 ->
    (B, H, W, C) in `out_dtype`, summed in fp32 and rounded once; one
    backward kernel launch on CUDA tensors, ``roi_align_matmul_backward``
    on CPU ones."""
    if _one_device([g, rois], "C4 RoIAlign backward").type == "cpu":
        if roi_align_bwd.observers:
            roi_align_bwd.observe([feature_shape], *_one_level(rois), (spatial_scale,),
                                  pooled_h, pooled_w, sampling_ratio, max_grid)
        return plain.roi_align_matmul_backward(g, feature_shape, rois, pooled_h, pooled_w,
                                               spatial_scale, sampling_ratio, max_grid,
                                               out_dtype=out_dtype)
    g = g.reshape(-1, pooled_h, pooled_w, g.shape[-1]).contiguous()
    return roi_align_bwd(g, [tuple(feature_shape)], *_one_level(rois), (spatial_scale,),
                         pooled_h, pooled_w, sampling_ratio, max_grid, out_dtype)[0]
