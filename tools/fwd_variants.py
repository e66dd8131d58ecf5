"""Time build variants of the port's RoIAlign forward kernel on one CUDA card.

    python3 tools/fwd_variants.py [--other DIR ...]

Builds ``detectorch_tpu_torch/csrc/roi_align_fwd.cu`` seven ways — as it is
(at least 4 blocks of 8 warps per SM, so at most 64 registers a thread),
without its output write (the loads and FMAs only: the store is kept behind
a test that never holds), without its feature loads (each 16-byte load
replaced by bits of its own address: the plan, the walk over the rows, the
FMAs and the write), without both (the plan, the walk and the FMAs), and
with its ``__launch_bounds__`` asking for 3 or 5 blocks per SM instead of
4, and with its streaming output stores made ordinary write-back ones — and
times each on the inputs of the smoke test's phase 3, beside this script at
the root of the checkout (batch 8 pyramids at 832x1344, C = 256, strides 4
to 32, bf16 and fp32 features; 1000 rois per image at 7x7 and 108 at 14x14,
random and clustered rois from its generators), by CUDA events, in two
rounds in opposite orders; each round also times the kernel as built on
the same rois put in (image, level, centre row) order, beside the time of
the argsort that orders them. ``--other`` also times the forward of another
checkout of this repository (for example ``git archive`` of an earlier
commit unpacked into a directory), in a process of its own, before and
after this checkout's. Prints one JSON line per variant and round.
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
# times that checkout's roi_align_fwd on this checkout's inputs
_TIME_CHECKOUT = """
import importlib.util, json, sys
root, tool, label = sys.argv[1:4]
sys.path.insert(0, root)
from detectorch_tpu_torch.ops.cuda.roi_align_kernel import roi_align_fwd
spec = importlib.util.spec_from_file_location("fwd_variants_tool", tool)
fv = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fv)
print(json.dumps({"variant": label, "ms": fv.time_all(roi_align_fwd, fv.cases())}), flush=True)
"""


def cases():
    """The phase-3 calls of the 832x1344 bucket, keyed by name: (args of
    roi_align_fwd). The smoke test is loaded from this checkout by its
    path, whichever checkout's package is imported."""
    import importlib.util

    import torch

    from detectorch_tpu_torch.ops.fpn_levels import map_rois_to_fpn_levels

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    scales = tuple(1.0 / s for s in (4, 8, 16, 32))
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        feats = cs.make_pyramid(gen, cs.BATCH, cs.HEIGHT, cs.WIDTH, 256, dtype, dev)
        for pooled, n in ((7, cs.BOX_ROIS), (14, cs.MASK_ROIS)):
            for kind, make in (("random", cs.make_rois), ("clustered", cs.make_clustered_rois)):
                rois = make(gen, cs.BATCH, n, cs.HEIGHT, cs.WIDTH, dev).reshape(-1, 4).contiguous()
                levels = (map_rois_to_fpn_levels(rois) - 2).contiguous()
                bidx = torch.arange(cs.BATCH, dtype=torch.int32, device=dev).repeat_interleave(n)
                out[f"{str(dtype)[6:]} {kind} {pooled}x{pooled}"] = (
                    feats, rois, bidx, levels, scales, pooled, pooled, 2)
    return out


def time_all(kernel, calls):
    """Mean CUDA-event ms of kernel(*args) for each call."""
    import torch

    res = {}
    for name, args in calls.items():
        for _ in range(3):
            kernel(*args)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            kernel(*args)
        stop.record()
        torch.cuda.synchronize()
        res[name] = start.elapsed_time(stop) / ITERS
    return res


def _variants(build_dir: Path):
    """name -> a RoIAlignForward built from a variant of the source."""
    from detectorch_tpu_torch.ops.cuda import roi_align_kernel as K

    src = (K.CSRC / "roi_align_fwd.cu").read_text()
    store = "store_cs<V>(o, acc, inv_count);"
    load = "return __ldg(reinterpret_cast<const uint4*>(p));"
    bounds = "__launch_bounds__(kMaxWarps * 32, 4)"
    if src.count(store) != 1 or src.count(load) != 1 or src.count(bounds) != 1:
        raise RuntimeError("the kernel's text is not what this tool expects")
    # never true: the loads and FMAs stay, the write goes
    no_store = f"if (__float_as_uint(acc[0]) == 0xffffffffu) {store}"
    # bits of the address: no memory traffic, values the compiler cannot fold
    no_load = ("const uint32_t a = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p)); "
               "return make_uint4(a, a >> 8, a >> 16, a >> 24);")
    texts = {
        "as_is": src,
        "no_write": src.replace(store, no_store),
        "no_loads": src.replace(load, no_load),
        "no_loads_no_write": src.replace(store, no_store).replace(load, no_load),
        # 3 or 5 blocks of 8 warps per SM: up to 85 or 51 registers a thread
        "min_blocks_3": src.replace(bounds, bounds.replace(", 4)", ", 3)")),
        "min_blocks_5": src.replace(bounds, bounds.replace(", 4)", ", 5)")),
        # the output through ordinary (write-back) stores, not evict-first ones
        "store_wb": src.replace("__stcs(", "__stwb("),
    }
    build_dir.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name, text in texts.items():
        path = build_dir / f"roi_align_fwd_{name}.cu"
        path.write_text(text)
        kernel = type(name, (K.RoIAlignForward,), {"source": path})()
        kernel.build()
        regs = [line.strip() for line in kernel.build_log.splitlines()
                if "registers" in line or "spill" in line or "entry function" in line]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        kernels[name] = kernel
    return kernels


def sorted_calls(calls):
    """The same calls with the rois put in (image, level, centre row) order,
    so that blocks launched together read neighbouring feature rows; and
    the mean CUDA-event ms of the argsort that makes each order."""
    import torch

    out, sort_ms = {}, {}
    for name, (feats, rois, bidx, levels, *rest) in calls.items():
        centre = ((rois[:, 1] + rois[:, 3]) * 0.5).clamp(-4096, 4095).long() + 4096
        key = (bidx.long() * 8 + levels.long()) * 8192 + centre
        perm = torch.argsort(key)
        out[name] = (feats, rois[perm].contiguous(), bidx[perm].contiguous(),
                     levels[perm].contiguous(), *rest)
        sort_ms[name] = time_all(lambda: torch.argsort(key), {name: ()})[name]
    return out, sort_ms


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
                   help="root of another checkout whose forward is timed too")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fwd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia-smi": smi}), flush=True)
    for root in args.other:
        _time_checkout(root, f"other:{root}")
    kernels = _variants(REPO / "build" / "fwd_variants")
    calls = cases()
    by_roi_order, sort_ms = sorted_calls(calls)
    print(json.dumps({"argsort_ms": sort_ms}), flush=True)
    for order in (list(kernels), list(reversed(kernels))):
        for name in order:
            print(json.dumps({"variant": name, "ms": time_all(kernels[name], calls)}), flush=True)
        print(json.dumps({"variant": "as_is, rois sorted",
                          "ms": time_all(kernels["as_is"], by_roi_order)}), flush=True)
    for root in args.other:
        _time_checkout(root, f"other:{root}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
