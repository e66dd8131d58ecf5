"""The multi-rank dry run (``parallel.dryrun``): one e2e Mask R-CNN step and
sharded batched inference held against one process, on n ranks of a
('data', 'model') mesh, data n/2 x model 2 for even n.

  python -m detectorch_tpu_torch.tools.dryrun_multichip            # every card
  python -m detectorch_tpu_torch.tools.dryrun_multichip --n 2      # 2 ranks
  python -m detectorch_tpu_torch.tools.dryrun_multichip --n 2 --device cpu

On the card each rank takes card r mod the card count (NCCL with a card
per rank, gloo where ranks share one). Prints one JSON line per rank and
exits non-zero if any rank or check fails.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=None,
                   help="ranks; default: the CUDA card count (2 with --device cpu)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    import torch

    from detectorch_tpu_torch.parallel.dryrun import dryrun_multichip, mesh_shape

    n = args.n or (torch.cuda.device_count() if args.device == "cuda" else 2)
    if n < 1:
        raise SystemExit("no CUDA device: pass --device cpu")
    t0 = time.perf_counter()
    results = dryrun_multichip(n, args.device)
    for r in results:
        print(json.dumps(r), flush=True)
    data, model = mesh_shape(n)
    print(f"dryrun_multichip({n}) OK on {args.device}: mesh data {data} x model {model}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
