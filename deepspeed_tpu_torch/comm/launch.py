"""Start one process per rank on this host and collect what each returns.

The reference's tests fan a function out over N worker processes
(tests/unit/common.py `DistributedExec`); the port's tensor-parallel tests
and `chip_smoke.py --tp N` do the same with `spawn_ranks`.  The ranks
meet at a file store, so no port is opened, and the parent bounds the
whole run by a time limit of its own: a rank that raises, dies or hangs
fails the call, and every rank still running is ended.
"""
from __future__ import annotations

import os
import queue
import time
import traceback
from typing import Callable, List, Sequence

__all__ = ["spawn_ranks"]


def _rank_main(fn, rank, world_size, init_method, args, results, threads):
    import torch
    if threads:
        torch.set_num_threads(threads)
    try:
        out = fn(rank, world_size, init_method, *args)
        results.put((rank, True, out))
    except BaseException:                      # report, then exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        from . import comm
        comm.destroy()


def spawn_ranks(fn: Callable, world_size: int, store: str,
                args: Sequence = (), timeout_s: float = 600.0,
                threads: int = 1) -> List:
    """Run `fn(rank, world_size, init_method, *args)` in `world_size` fresh
    processes (start method "spawn", so a child imports only what `fn`'s
    module imports) and return their results in rank order.
    `init_method` is "file://<store>" (the file must not exist yet; its
    directory must).  Each child runs with `threads` intra-op threads.
    Raises with the failing rank's traceback if any rank raises or dies,
    and TimeoutError if the ranks have not all returned within
    `timeout_s`; the remaining ranks are ended either way."""
    import torch.multiprocessing as mp
    if os.path.exists(store):
        raise ValueError(f"store file {store} exists already")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"file://{os.path.abspath(store)}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, tuple(args),
                               results, threads))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, error = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world_size and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(got))
                raise TimeoutError(f"ranks {missing} did not finish within "
                                   f"{timeout_s:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # let a dying rank's report arrive before blaming it
                    try:
                        rank, ok, out = results.get(timeout=5.0)
                    except queue.Empty:
                        error = (f"rank {dead[0]} exited with code "
                                 f"{procs[dead[0]].exitcode} and no report")
                        continue
                else:
                    continue
            if ok:
                got[rank] = out
            else:
                error = f"rank {rank} failed:\n{out}"
        if error is not None:
            raise RuntimeError(error)
        return [got[r] for r in range(world_size)]
    finally:
        done = error is None and len(got) == world_size
        for p in procs:
            p.join(timeout=30 if done else 0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
