"""Process start (counterpart of ``aat_tpu/parallel/distributed.py``).

The JAX package runs one process per host over every local chip; the port
runs one process per device, as ``torchrun`` starts them:

    torchrun --nproc-per-node 4 -m aat_tpu_torch.scripts.train --mesh-dp 4 ...

:func:`initialize` reads torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (or its arguments),
joins the process group and returns the rank's device, ``cuda:<local
rank>`` unless the caller names another. The backend is NCCL for a CUDA
device and gloo for the CPU, or the one the caller names; a failure to
join raises. One process without an address is a no-op.

:func:`launch` starts the ranks of a function in fresh processes on this
machine (the tests and ``chip_smoke.py`` use it): each rank calls
``fn(rank, world_size, port, *args)`` and its return value comes back to
the caller in rank order.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import queue
import socket
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None, device=None,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device. Arguments left
    out come from torchrun's environment; ``device`` defaults to
    ``cuda:<LOCAL_RANK>`` (pass ``"cpu"``, or ``"cuda:0"`` for every rank
    on one card); ``backend`` to ``"nccl"`` on CUDA, ``"gloo"`` on the CPU."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank))
    device = torch.device(device if device is not None else f"cuda:{local_rank}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f'{device} requested but no CUDA device is available; '
                               'pass device="cpu" to run on the CPU over gloo')
        torch.cuda.set_device(device)
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size <= 1 and init_method is None:
        logger.info("single-process run; no process group")
        return device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    logger.info("process group %s: rank %d of %d on %s", backend, rank, world_size, device)
    return device


def world() -> tuple:
    """(rank, world size) of the initialized group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(fn, rank, world_size, port, args, results):
    try:
        results.put((rank, True, fn(rank, world_size, port, *args)))
    except BaseException:  # reported to the launcher, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: Sequence = (), timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, port, *args)`` in ``world_size`` fresh
    processes (``spawn``; ``fn`` and ``args`` must pickle) and return their
    results in rank order. ``port`` is a free port on localhost for
    ``initialize(init_method=f"tcp://localhost:{port}")``. A rank that
    raises, or a run longer than ``timeout`` seconds, raises here, and every
    rank is stopped before this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_run_rank, args=(fn, r, world_size, port, tuple(args), results),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    out, failures = {}, []
    try:
        for _ in range(world_size):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"launch: {world_size - len(out) - len(failures)} rank(s) "
                                   f"gave no result within {timeout} s") from None
            if ok:
                out[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
                break
        if failures:
            raise RuntimeError("launch: a rank failed\n" + "\n".join(failures))
    finally:
        for p in procs:
            p.join(timeout=10 if not failures and len(out) == world_size else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world_size)]
