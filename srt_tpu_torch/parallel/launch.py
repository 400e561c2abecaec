"""Start a world of ranks on one machine: ``spawn_world``.

Each rank is a process started with the ``spawn`` method (a forked child
cannot use a CUDA context its parent made, nor threads its parent ran),
joined to the others through ``init_distributed`` on a ``FileStore`` in
``workdir`` (no port to pick, so concurrent worlds never clash).  The
world runs under one time limit: a rank that fails or outlives it ends
the world, every rank is killed, and the call raises.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import torch


def _rank_main(fn, rank, world_size, args, workdir, backend, device,
               timeout, threads):
    from srt_tpu_torch.parallel.mesh import init_distributed
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        init_distributed(f"file://{workdir}/store", world_size, rank,
                         backend=backend, device=device, timeout=timeout)
        out = fn(rank, world_size, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(fn, world_size: int, args=(), *, workdir: str,
                backend: str = None, device=None, timeout: float = 120.0,
                threads: int = 0):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    and return their results in rank order.

    ``fn`` is a module-level function (it is pickled by name), and its
    result must survive ``torch.save``.  ``workdir`` is a directory of
    this world's own (made if missing): the store and the results go
    there, and what an earlier world left there is removed first.  ``backend`` and
    ``device`` go to ``init_distributed`` (default: NCCL on the card,
    gloo with ``device="cpu"``; two ranks on one card need gloo).
    ``timeout`` (seconds) bounds the whole world and each rank's
    rendezvous and collectives; ``threads`` > 0 sets each rank's torch
    threads.  Raises ``RuntimeError`` when a rank fails (its traceback in
    the message) and ``TimeoutError`` when the world outlives
    ``timeout``; every rank is stopped first."""
    os.makedirs(workdir, exist_ok=True)
    # A store or results left by a world that was killed would be read as
    # this world's.
    for name in ["store"] + [f"rank{r}.{ext}" for r in range(world_size)
                             for ext in ("pt", "err")]:
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, tuple(args), workdir, backend, device, timeout,
        threads)) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world_size} ranks ran past "
                                   f"{timeout} s")
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        errs = []
        for r in failed:
            path = os.path.join(workdir, f"rank{r}.err")
            text = ""
            if os.path.exists(path):
                with open(path) as f:
                    text = f.read()
            errs.append(f"rank {r} exit {procs[r].exitcode}\n{text}")
        raise RuntimeError("\n".join(errs))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world_size)]
