"""Spawn ranks of one process group from a parent process: the CPU tests
and chip_smoke.py run their multi-process checks through `spawn`.

    results = spawn(fn, world=2, args=(...), timeout=120)

Each rank runs `fn(rank, *args)` in a fresh interpreter (the "spawn"
start method: a child re-imports the module that holds `fn`, so keep
rank bodies in modules that import no JAX) and returns its picklable
result (pickled by value); `spawn` returns them in rank order, or raises with the failing
rank's traceback, or kills every rank when `timeout` seconds pass.

`init="file"` starts each rank's process group itself, over a FileStore
in a temporary directory (no TCP); `init="env"` gives the ranks
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR=localhost, MASTER_PORT) and leaves the start to `fn`, as a
CLI's `maybe_initialize_multihost` does. `threads` torch threads a rank
keep ranks that share a host's cores from waiting on each other's
spinning threads. `device` is "cuda" unless the caller asks for the CPU
(`device="cpu"`, as the CPU tests do), as in
`mesh.initialize_multihost`.
"""
from __future__ import annotations

import os
import pickle
import queue
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, init, store, env, threads, device, args,
               out):
    import torch

    from xlxmert_tpu_torch.parallel import mesh as pmesh

    os.environ.update(env)
    if threads:
        torch.set_num_threads(threads)
    try:
        if init == "file":
            pmesh.initialize_multihost(f"file://{store}", world, rank,
                                       device=device, timeout=120)
        # pickled here, by value: the queue would pass tensors through
        # shared memory that dies with this process
        out.put((rank, "ok", pickle.dumps(fn(rank, *args))))
    except Exception:  # reported to the parent with its traceback
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if pmesh.initialized():
            try:
                torch.distributed.destroy_process_group()
            except Exception:
                pass


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          timeout: float = 300.0, init: str = "file",
          threads: Optional[int] = 1, device: str = "cuda") -> List[Any]:
    """Run `fn(rank, *args)` on `world` ranks; their results in rank
    order. With init="file" each rank starts its group on `device`: the
    card (NCCL, or gloo where ranks share one) unless the caller asks for
    the CPU (gloo)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port() if init == "env" else None
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = []
        for r in range(world):
            env = {"LOCAL_RANK": str(r)}
            if init == "env":
                env.update(RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_WORLD_SIZE=str(world),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port))
            p = ctx.Process(target=_rank_main,
                            args=(fn, r, world, init, store, env, threads,
                                  device, tuple(args), out))
            p.start()
            procs.append(p)
        results, errors = {}, []
        try:
            deadline = time.time() + timeout
            while len(results) + len(errors) < world:
                left = deadline - time.time()
                if left <= 0:
                    raise TimeoutError(
                        f"{world - len(results) - len(errors)} of {world} "
                        f"ranks did not finish within {timeout:.0f}s")
                try:
                    r, status, value = out.get(timeout=min(left, 5.0))
                except queue.Empty:
                    dead = [p for p in procs
                            if not p.is_alive() and p.exitcode not in (0,)]
                    if dead and not errors:
                        raise RuntimeError(
                            f"a rank died with exit code {dead[0].exitcode}")
                    continue
                if status == "ok":
                    results[r] = pickle.loads(value)
                else:
                    errors.append(f"rank {r}:\n{value}")
                    break
        finally:
            done = len(results) == world
            for p in procs:
                p.join(timeout=10 if done else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]
