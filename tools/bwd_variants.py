"""Time build variants of the port's RoIAlign backward kernel on one CUDA card.

    python3 tools/bwd_variants.py [--other DIR ...]

Builds ``detectorch_tpu_torch/csrc/roi_align_bwd.cu`` three ways — as it is
(two blocks of 512 threads per SM), capped at one block per SM (its
``__launch_bounds__`` rewritten), and with its accumulation loop left out
(the per-tile lists, the weights and the write of zeros: the kernel's
floor) — and times each on the inputs of the smoke test's phase 6, beside
this script at the root of the checkout (batch 8 pyramids at 832x1344,
C = 256, strides 4 to 32; 512 rois per image at 7x7 and 128 at 14x14,
random and clustered rois from its generators), bf16 gradients, by CUDA
events, in two rounds in opposite orders. ``--other`` also times the backward of
another checkout of this repository (for example ``git archive`` of an
earlier commit unpacked into a directory), in a process of its own, before
and after this checkout's. Prints one JSON line per variant and round.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ITERS = 20

# run in a fresh interpreter with a checkout's root first on sys.path:
# times that checkout's roi_align_bwd on this checkout's inputs
_TIME_CHECKOUT = """
import importlib.util, json, sys
root, tool, label = sys.argv[1:4]
sys.path.insert(0, root)
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_bwd
spec = importlib.util.spec_from_file_location("bwd_variants_tool", tool)
bv = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bv)
print(json.dumps({"variant": label, "ms": bv.time_all(roi_align_bwd, bv.cases())}), flush=True)
"""


def cases():
    """The phase-6 calls, keyed by name: (args of roi_align_bwd). The smoke
    test is loaded from this checkout by its path, whichever checkout's
    package is imported."""
    import importlib.util

    import torch

    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    strides = (4, 8, 16, 32)
    scales = tuple(1.0 / s for s in strides)
    shapes = [(cs.BATCH, cs.HEIGHT // s, cs.WIDTH // s, 256) for s in strides]
    out = {}
    for pooled, n in ((7, cs.TRAIN_ROIS), (14, cs.TRAIN_MASK_ROWS)):
        for kind, make in (("random", cs.make_rois), ("clustered", cs.make_clustered_rois)):
            gen = torch.Generator(device=dev)
            gen.manual_seed(11)
            rois = make(gen, cs.BATCH, n, cs.HEIGHT, cs.WIDTH, dev).reshape(-1, 4).contiguous()
            levels = (map_rois_to_fpn_levels(rois) - 2).contiguous()
            bidx = torch.arange(cs.BATCH, dtype=torch.int32, device=dev).repeat_interleave(n)
            g = torch.randn((cs.BATCH * n, pooled, pooled, 256), generator=gen, device=dev)
            out[f"{kind} {pooled}x{pooled}"] = (g, shapes, rois, bidx, levels, scales,
                                                pooled, pooled, 2)
    return out


def time_all(kernel, calls):
    """Mean CUDA-event ms of kernel(*args, out_dtype=bf16) for each call."""
    import torch

    res = {}
    for name, args in calls.items():
        for _ in range(3):
            kernel(*args, out_dtype=torch.bfloat16)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            kernel(*args, out_dtype=torch.bfloat16)
        stop.record()
        torch.cuda.synchronize()
        res[name] = start.elapsed_time(stop) / ITERS
    return res


def _variants(build_dir: Path):
    """name -> a RoIAlignBackward built from a variant of the source."""
    from detectorch_tpu_torch.ops.cuda import roi_align_kernel as K

    src = (K.CSRC / "roi_align_bwd.cu").read_text()
    loop = "for (int k = 0; k < nk; ++k) {"
    bounds = "__launch_bounds__(kThreads, 2) roi_align_bwd_kernel("
    if src.count(loop) != 1 or src.count(bounds) != 1:
        raise RuntimeError("the kernel's text is not what this tool expects")
    texts = {
        "as_is": src,
        "one_block_per_sm": src.replace(bounds, bounds.replace(", 2)", ", 1)")),
        "no_accumulation": src.replace(loop, "for (int k = 0; k < 0; ++k) {"),
    }
    build_dir.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name, text in texts.items():
        path = build_dir / f"roi_align_bwd_{name}.cu"
        path.write_text(text)
        kernel = type(name, (K.RoIAlignBackward,), {"source": path})()
        kernel.build()
        regs = [line.strip() for line in kernel.build_log.splitlines()
                if "registers" in line and "smem" in line]
        print(json.dumps({"variant": name, "ptxas": regs[:1]}), flush=True)
        kernels[name] = kernel
    return kernels


def _time_checkout(root: str, label: str):
    proc = subprocess.run([sys.executable, "-c", _TIME_CHECKOUT, root, __file__, label],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stderr[-3000:]}")
    print(proc.stdout.strip().splitlines()[-1], flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--other", action="append", default=[],
                   help="root of another checkout whose backward is timed too")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bwd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia-smi": smi}), flush=True)
    for root in args.other:
        _time_checkout(root, f"other:{root}")
    kernels = _variants(REPO / "build" / "bwd_variants")
    calls = cases()
    for order in (list(kernels), list(reversed(kernels))):
        for name in order:
            print(json.dumps({"variant": name, "ms": time_all(kernels[name], calls)}), flush=True)
    for root in args.other:
        _time_checkout(root, f"other:{root}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
