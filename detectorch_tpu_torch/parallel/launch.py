"""Start `world` ranks of a function on this machine, as torchrun would, and
collect what each returns.

Each rank is a process of the ``spawn`` start method (a fresh interpreter:
safe with CUDA and with threads) with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK), joined through ``parallel.mesh.
init_distributed_from_env`` at a ``file://`` rendezvous in a temporary
directory, so no port is chosen and parallel runs cannot collide. A rank
that raises, exits non-zero or does not finish in time fails the whole
run: the others are terminated and ``run_ranks`` raises with its
traceback.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

# a collective whose peer died waits this long before it raises
COLLECTIVE_TIMEOUT_S = 300


def _rank_main(target, rank, world, local_rank, backend, init_method, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank))
    import torch
    import torch.distributed as dist

    from detectorch_tpu_torch.parallel.mesh import init_distributed_from_env

    torch.set_num_threads(1)  # the ranks share the host's cores
    try:
        init_distributed_from_env(backend, init_method, COLLECTIVE_TIMEOUT_S)
        results.put((rank, True, target(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target: Callable, world: int, args: Sequence = (), backend: str = "gloo",
              local_ranks: Optional[Sequence[int]] = None, timeout_s: float = 900) -> List:
    """Run target(*args) on `world` ranks and return their results in rank
    order. `target` must be importable (a module-level function) and its
    arguments and result picklable. `local_ranks` gives each rank's
    LOCAL_RANK, its CUDA device where there is one (default: the rank);
    several ranks on one card need the gloo backend, as NCCL refuses two
    ranks on one device."""
    local_ranks = list(range(world)) if local_ranks is None else list(local_ranks)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        try:
            for rank in range(world):
                p = ctx.Process(target=_rank_main, daemon=True,
                                args=(target, rank, world, local_ranks[rank], backend,
                                      init_method, tuple(args), results))
                p.start()
                procs.append(p)
            out = {}
            deadline = time.monotonic() + timeout_s
            while len(out) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [(i, p.exitcode) for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank(s) exited with {dead} before returning")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world - len(out)} rank(s) did not finish in "
                                           f"{timeout_s:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
            bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"rank(s) exited with {bad}")
            return [out[r] for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                    if p.is_alive():
                        p.kill()
