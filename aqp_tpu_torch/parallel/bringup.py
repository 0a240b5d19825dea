"""Multi-process bring-up on torch.distributed (counterpart of
aqp_tpu/parallel/bringup.py).

One process per rank.  `initialize_distributed` joins this process to the
group from its arguments or the environment:

  AQP_COORDINATOR  host:port of rank 0's store (default: single-process)
  AQP_NUM_PROCS    total process count
  AQP_PROC_ID      this process's rank

With a card present the group dispatches CUDA tensors to NCCL and CPU
tensors to gloo (backend "cpu:gloo,cuda:nccl"), and the rank takes card
rank % cards; without one it is gloo alone.  NCCL refuses two ranks on one
card, so one host with one card runs one rank.

`spawn_ranks` runs a function on every rank of a group of processes that
it starts on this host (the CPU tests' gloo ranks, the weak-scaling
study): each brought up on a free localhost port, each result returned in
rank order, a failed or hung rank raising in the caller.
"""

from __future__ import annotations

import atexit
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

DEFAULT_COORDINATOR = "localhost:12321"
DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Idempotent torch.distributed bring-up; returns the world size.

    Returns 1 without side effects when neither the arguments nor the
    environment ask for a multi-process run (no coordinator, at most one
    process), so single-card flows never pay for it.  Otherwise the
    group's store is a TCP store at the coordinator (tcp:// init), and a
    rank that cannot reach it, or a collective that waits longer,
    raises after `timeout_s`."""
    coordinator = coordinator or os.environ.get("AQP_COORDINATOR")
    num_processes = num_processes or int(
        os.environ.get("AQP_NUM_PROCS", "0")) or None
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("AQP_PROC_ID", "-1")))
    if not coordinator and (num_processes is None or num_processes <= 1):
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    rank = max(0, process_id)
    card = torch.cuda.is_available()
    if card:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if card else "gloo",
        init_method=f"tcp://{coordinator or DEFAULT_COORDINATOR}",
        world_size=num_processes or 1, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, tasks, results,
               timeout_s: float) -> None:
    try:
        if not torch.cuda.is_available():
            # one thread a rank: ranks are the parallelism, and spinning
            # intra-op threads of several ranks starve each other
            torch.set_num_threads(1)
        args = tasks.get(timeout=timeout_s)
        initialize_distributed(f"127.0.0.1:{port}", world, rank, timeout_s)
        value = fn(rank, world, *args)
        results.put((rank, True, value))
    except BaseException as e:  # reported: the caller stops every rank
        results.put((rank, False, traceback.format_exc()))
        if not isinstance(e, Exception):
            raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]     # the started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def _stop_forkserver() -> None:
    """Stop spawn_ranks's forkserver and wait for it to exit: left alone,
    it outlives this process by seconds."""
    from multiprocessing import forkserver
    forkserver._forkserver._stop()


def spawn_ranks(fn: Callable, world: int, args: Sequence = (),
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(rank, world, *args) in `world` new processes (forkserver
    start method) that form one group on a free localhost port; returns each
    rank's value (picklable) in rank order.  `fn` must be importable by
    name.  Raises RuntimeError with the rank's traceback when a rank
    fails, TimeoutError when the ranks are not done within `timeout_s`
    (bring-up included); either way every rank is stopped."""
    import multiprocessing as mp

    # forkserver: each rank is forked from a server process that is single
    # threaded and imported torch once (not from this process, whose
    # threads make fork unsafe), so a rank starts in a fraction of the
    # seconds a fresh interpreter takes to import torch
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed",
                                "aqp_tpu_torch.parallel.bringup"])
    atexit.unregister(_stop_forkserver)     # registered once
    atexit.register(_stop_forkserver)
    # the arguments go through a queue, not the processes' own arguments:
    # a start writes those to the child's pipe and waits until the child,
    # done importing, reads them, so large ones would start the ranks one
    # after another
    tasks, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, rank, world, port, tasks, results, timeout_s))
        for rank in range(world)]
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        for _ in procs:
            tasks.put(tuple(args))
        while len(out) < world:
            try:
                rank, ok, value = results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(
                    f"{world - len(out)} of {world} ranks did not finish "
                    f"within {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
    finally:
        _stop(procs)
    return [out[r] for r in range(world)]
