"""The port's native RLE: ``csrc/rle_native.cpp``, built at first use with the
host C++ compiler into a plain-C shared library and loaded with ``ctypes``.

It is the port's copy of the JAX package's CPython extension
(``native/rle_ext.cpp``): the same algorithms behind a C interface over
int64 / uint8 / char buffers, so the build needs a C++17 compiler and
nothing of Python's or numpy's headers. ``eval/rle`` calls it for the paste
encode, the string codec, the run-walk IoU and the area; its numpy bodies
(``*_np``) stay there as the plain versions that the tests and
``chip_smoke.py`` hold this library to, byte for byte.

The compiler is ``$CXX``, else ``c++`` or ``g++`` on ``PATH``. The library is
written to ``build/detectorch_tpu_torch/rle_native-<hash>.so`` at the root of
the checkout, named by a hash of the source and the flags, through a temp
file and ``os.replace``, so that processes that build at once agree on one
file. A failed build raises ``RuntimeError`` with the compiler's output;
there is no fallback to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rle_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "detectorch_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
MAX_CHARS_PER_COUNT = 13  # 65 bits of 5-bit groups: any int64 count

_SIGNATURES = {
    "rle_counts_to_string": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64,
                                              ctypes.c_char_p, ctypes.c_int64]),
    "rle_string_to_counts": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64,
                                              ctypes.c_void_p, ctypes.c_int64]),
    "rle_encode_pasted": (ctypes.c_int64, [ctypes.c_void_p] + [ctypes.c_int64] * 6
                          + [ctypes.c_char_p, ctypes.c_int64]),
    "rle_area": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
    "rle_iou_matrix": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]),
}


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native RLE needs a C++ compiler: set CXX or put c++ or g++ "
                           "on PATH")
    return cxx


def build_library(build_dir: Path = BUILD_DIR) -> Tuple[Path, str]:
    """Compile ``csrc/rle_native.cpp`` into ``build_dir/rle_native-<hash>.so``
    unless that file exists. Returns its path and the compiler's output ("" if
    it was reused)."""
    build_dir = Path(build_dir)
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()) \
        .hexdigest()[:16]
    lib_path = build_dir / f"rle_native-{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        cmd = [compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"building the native RLE failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree on one file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, log


class Library:
    """The loaded library, built and loaded once behind a lock (the eval
    loop's finalize may run on loader threads). Each call releases the
    interpreter lock while the C code runs."""

    def __init__(self, build_dir: Path = BUILD_DIR):
        self.build_dir = build_dir
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    path, _ = build_library(self.build_dir)
                    lib = ctypes.CDLL(str(path))
                    for name, (restype, argtypes) in _SIGNATURES.items():
                        fn = getattr(lib, name)
                        fn.restype, fn.argtypes = restype, argtypes
                    self.path = path
                    self._lib = lib
        return self._lib

    # -- the entry points ----------------------------------------------------

    def counts_to_string(self, counts: Sequence[int]) -> str:
        c = np.ascontiguousarray(counts, np.int64)
        cap = MAX_CHARS_PER_COUNT * len(c)
        out = ctypes.create_string_buffer(max(cap, 1))
        n = self.load().rle_counts_to_string(c.ctypes.data, len(c), out, cap)
        return out.raw[:n].decode("ascii")

    def string_to_counts(self, s) -> List[int]:
        b = s.encode("ascii") if isinstance(s, str) else bytes(s)
        out = np.empty(len(b), np.int64)
        n = self.load().rle_string_to_counts(b, len(b), out.ctypes.data, len(b))
        if n < 0:
            raise ValueError("truncated RLE string")
        return out[:n].tolist()

    def encode_pasted(self, binary: np.ndarray, x0: int, y0: int, im_h: int,
                      im_w: int) -> str:
        patch = np.ascontiguousarray(binary, np.uint8)
        if patch.ndim != 2:
            raise ValueError(f"patch must be 2-D, got shape {patch.shape}")
        bh, bw = patch.shape
        x0, y0, im_h, im_w = int(x0), int(y0), int(im_h), int(im_w)
        if bh and bw and not (0 <= x0 and 0 <= y0 and x0 + bw <= im_w and y0 + bh <= im_h):
            raise ValueError(f"a ({bh}, {bw}) patch at ({x0}, {y0}) does not fit a "
                             f"({im_h}, {im_w}) canvas")
        fn = self.load().rle_encode_pasted
        # a paste's string is short: a few runs per column; a longer one is
        # measured by the first call and written by a second
        cap = 64 + 16 * bw
        out = ctypes.create_string_buffer(cap)
        n = fn(patch.ctypes.data, bh, bw, x0, y0, im_h, im_w, out, cap)
        if n > cap:
            out = ctypes.create_string_buffer(n)
            n = fn(patch.ctypes.data, bh, bw, x0, y0, im_h, im_w, out, n)
        return out.raw[:n].decode("ascii")

    def area(self, counts: Sequence[int]) -> int:
        c = np.ascontiguousarray(counts, np.int64)
        return int(self.load().rle_area(c.ctypes.data, len(c)))

    def iou_matrix(self, dt_counts: Sequence[Sequence[int]], gt_counts: Sequence[Sequence[int]],
                   iscrowd: Sequence[bool]) -> np.ndarray:
        d, g = len(dt_counts), len(gt_counts)
        if len(iscrowd) != g:
            raise ValueError(f"iscrowd has {len(iscrowd)} entries for {g} gts")
        out = np.zeros((d, g), np.float64)
        if d == 0 or g == 0:
            return out
        parts = [np.asarray(c, np.int64).reshape(-1) for c in (*dt_counts, *gt_counts)]
        offsets = np.zeros(d + g + 1, np.int64)
        np.cumsum([len(p) for p in parts], out=offsets[1:])
        counts = np.ascontiguousarray(np.concatenate(parts))
        crowd = np.ascontiguousarray([bool(c) for c in iscrowd], np.uint8)
        self.load().rle_iou_matrix(counts.ctypes.data, offsets.ctypes.data, d, g,
                                   crowd.ctypes.data, out.ctypes.data)
        return out


# the one library of this process, loaded at its first call
library = Library()
