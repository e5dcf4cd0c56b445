"""Run a function on every rank of a local process group: the ranks of a
mesh on one host (the CPU tests' gloo groups, two ranks sharing one card),
without torchrun.

`run_ranks(fn, world, *args)` spawns `world` processes, each of which
starts the process group on a free localhost port (with a timeout),
calls fn(rank, *args) and sends its result back; the parent waits for
them with a deadline and raises, naming the rank and carrying its
traceback, if any rank fails or the deadline passes (the others are then
stopped), so a dead rank never leaves its peers hanging in a collective.
`fn` and its arguments must pickle (a module-level function).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List

from raindrop_tpu_torch.parallel.mesh import free_port


def _rank_main(fn, rank, world, port, backend, timeout_s, threads, out, args):
    status: Any
    try:
        import torch
        import torch.distributed as dist

        from raindrop_tpu_torch.parallel.mesh import initialize_distributed

        torch.set_num_threads(threads)
        initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend,
                               timeout_s=timeout_s)
        try:
            status = ("ok", fn(rank, *args))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reports it
        status = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(status, f)
    os.replace(out + ".tmp", out)
    if status[0] != "ok":
        os._exit(1)


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              timeout_s: float = 300.0, threads: int = 1) -> List[Any]:
    """[fn(0, *args), ..., fn(world - 1, *args)], each run in its own
    process of a `backend` group of `world` ranks. `timeout_s` bounds the
    group's collectives and the whole run; `threads` sets each rank's
    torch threads (default one: the ranks share the host's cores with
    whatever else runs there)."""
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="ranks") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, port, backend, timeout_s, threads,
                                   outs[r], args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
        results = []
        for r in range(world):
            if not os.path.exists(outs[r]):
                results.append(("error", f"rank {r} ended without a result "
                                         f"(exit code {procs[r].exitcode})"))
                continue
            with open(outs[r], "rb") as f:
                results.append(pickle.load(f))
    errors = [(r, msg) for r, (kind, msg) in enumerate(results) if kind != "ok"]
    if errors:
        first = failed if failed is not None else errors[0][0]
        msg = dict(errors).get(first, errors[0][1])
        raise RuntimeError(f"rank {first} of {world} failed:\n{msg}")
    return [value for _, value in results]
