"""Process groups and ranks: what ``jax.devices()`` and
``jax_num_cpu_devices`` give the JAX package for free.

A JAX program drives every device of its mesh from one controller. A torch
program runs one process per rank, and the ranks meet in a process group:

* :func:`backend_for` picks the backend: NCCL when each rank has a GPU of
  its own, gloo for CPU ranks and for several ranks that share one card
  (NCCL refuses two ranks on one GPU);
* :func:`init_from_env` joins the group that ``torchrun`` describes in the
  environment (``torchrun --nproc-per-node=<GPUs> script.py``);
* :func:`init_from_store` joins a group whose ranks meet through a
  ``FileStore`` in a directory: no port to choose or collide over;
* :func:`spawn` starts N ranks with the ``spawn`` start method, runs
  ``fn(device, *args)`` on each, joins every rank under one time limit and
  returns their results in rank order. A rank that raises, dies or hangs
  makes it kill the others and raise with that rank's traceback. Every
  rank leaves its group with ``destroy_process_group``.

``fn`` must be importable by name (a module-level function of this
package): a spawned rank starts from a fresh interpreter and imports the
module that defines it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist

__all__ = ["backend_for", "rank_device", "init_from_env", "init_from_store",
           "spawn"]

INIT_TIMEOUT_S = 60.0   # a rank waits this long for the others, per op


def backend_for(device_type: str, world_size: int) -> str:
    """"nccl" when every rank has a GPU of its own, else "gloo"."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of a rank: GPU ``local_rank`` modulo the GPUs (ranks that
    outnumber the cards share them), or the CPU; a CUDA rank makes it the
    current device."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank needs a GPU and "
                           "torch.cuda.is_available() is false")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_from_env(device_type: str = "cuda", *,
                  timeout_s: float = INIT_TIMEOUT_S) -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    returns this rank's device."""
    world = int(os.environ["WORLD_SIZE"])
    dev = rank_device(device_type, int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(device_type, world),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def init_from_store(store_dir: str, rank: int, world_size: int,
                    device_type: str = "cuda", *,
                    timeout_s: float = INIT_TIMEOUT_S) -> torch.device:
    """Join a group of ``world_size`` ranks that meet through the file
    ``store_dir/store`` (every rank passes the same directory; the file must
    not exist before the first rank arrives); returns this rank's device."""
    dev = rank_device(device_type, rank)
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dist.init_process_group(backend_for(device_type, world_size),
                            store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _rank_main(fn, rank: int, world_size: int, device_type: str,
               store_dir: str, timeout_s: float):
    """One spawned rank: read its arguments from ``store_dir``, join the
    group, run ``fn``, leave; the result or the traceback goes to a file in
    ``store_dir`` that the parent reads."""
    if device_type == "cpu":
        # N CPU ranks stand for N devices; each takes one core
        torch.set_num_threads(1)
    try:
        with open(os.path.join(store_dir, f"args_{rank}.pkl"), "rb") as f:
            args = pickle.load(f)
        dev = init_from_store(store_dir, rank, world_size, device_type,
                              timeout_s=timeout_s)
        result = fn(dev, *args)
        with open(os.path.join(store_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(store_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *, device_type: str = "cuda", args=(),
          rank_args=None, timeout_s: float = 600.0,
          init_timeout_s: float = INIT_TIMEOUT_S, store_dir=None) -> list:
    """Run ``fn(device, *args, *rank_args[rank])`` on ``world_size`` spawned
    ranks in one process group (:func:`backend_for`'s backend; CPU ranks
    run with one intra-op thread each) and return the ranks' results in
    rank order.

    The ranks meet through a ``FileStore`` in a fresh directory under
    ``store_dir`` (default: the system's temporary directory). All of them
    must end within ``timeout_s``; ``init_timeout_s`` bounds each
    rendezvous and collective. When a rank raises or exits non-zero, the
    others are killed and ``RuntimeError`` carries that rank's traceback;
    a rank still running at the limit is killed and reported as hung."""
    if world_size < 1:
        raise ValueError(f"world_size {world_size} < 1")
    if rank_args is not None and len(rank_args) != world_size:
        raise ValueError(f"{len(rank_args)} rank_args for {world_size} ranks")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_", dir=store_dir) as tmp:
        # arguments go through files: a start writes its pickle into the
        # child's pipe, which blocks past the pipe's buffer until that child
        # has imported its modules, and the ranks would start one by one
        for r in range(world_size):
            with open(os.path.join(tmp, f"args_{r}.pkl"), "wb") as f:
                pickle.dump((*args, *(rank_args[r] if rank_args else ())), f)
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, device_type, tmp, init_timeout_s),
            name=f"rank{r}") for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            failed = None
            live = list(procs)
            while live and failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                for s in wait([p.sentinel for p in live], timeout=left):
                    p = next(q for q in live if q.sentinel == s)
                    p.join()
                    live.remove(p)
                    if p.exitcode != 0 and failed is None:
                        failed = procs.index(p)
            hung = [procs.index(p) for p in live]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        if failed is not None:
            err = os.path.join(tmp, f"error_{failed}.txt")
            why = (open(err).read() if os.path.exists(err) else
                   f"exit code {procs[failed].exitcode}, no traceback")
            raise RuntimeError(f"rank {failed} of {world_size} failed:\n{why}")
        if hung:
            raise RuntimeError(f"ranks {hung} of {world_size} still ran "
                               f"after {timeout_s} s and were killed")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
