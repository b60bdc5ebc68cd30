"""Start the ranks of a sharded run: ``spawn(fn, ranks, backend, device)``.

Each rank is a process with one ``torch.distributed`` default group. The
caller names the backend and the device, always:

* ``backend="nccl"`` where each rank has its own card (``device="cuda"``:
  rank r on ``cuda:r``); NCCL refuses two ranks on one card;
* ``backend="gloo"`` on the CPU (``device="cpu"``), and for several ranks
  sharing one card (``device="cuda:0"``): gloo's collectives take CUDA
  tensors through host memory.

A rank asked for a card that it does not find raises; nothing falls back to
another device or backend. The rendezvous is a ``file://`` store in a fresh
temporary directory, so concurrent runs (parallel test workers) never
collide on a port. Under ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` in the environment) the process is already one rank:
``spawn`` joins the group through ``env://`` and runs ``fn`` in place.

``fn(rank, *args)`` must be a module-level function (the ranks import its
module). ``args`` and each rank's return value go through files of the
run's temporary directory (``torch.save``: tensors, numpy arrays and plain
Python values), not through the pipe that starts a rank: a few hundred KB
of arguments pickled into it took 9 s to reach 4 ranks on a sandboxed
host. The results come back as ``{rank: value}``. The ranks are forked
from ``multiprocessing``'s fork server, which imports torch once for all
of them and lives until this process exits.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
_RANK_DEVICE: Optional[torch.device] = None


def rank_device() -> torch.device:
    """This rank's device, as :func:`spawn` (or :func:`init_rank`) set it."""
    if _RANK_DEVICE is None:
        raise RuntimeError("rank_device: this process was not started by "
                           "parallel.launch.spawn / init_rank; name the device")
    return _RANK_DEVICE


def _device_of(device, rank: int, ranks: int, backend: str,
               local_rank: Optional[int] = None) -> torch.device:
    """The device of ``rank``: ``"cpu"``, one shared card (``"cuda:i"``) or a
    card a rank (``"cuda"``: the card of the rank's ``local_rank``, default
    its rank)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: use 'gloo'")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: asked for {device} and CUDA is not available")
    if dev.index is None:  # a card a rank
        index = rank if local_rank is None else local_rank
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device='cuda' puts a rank on each card: rank {rank} "
                               f"wants card {index} of {torch.cuda.device_count()}")
        return torch.device("cuda", index)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank}: no {dev}")
    if backend == "nccl" and ranks > 1:
        raise ValueError("NCCL takes one rank a card: several ranks on one card need "
                         "backend='gloo'")
    return dev


def init_rank(backend: str, device, rank: int, ranks: int, init_method: str,
              timeout_s: float = 900.0, local_rank: Optional[int] = None) -> torch.device:
    """Join the default group as ``rank`` of ``ranks`` on ``device``; returns
    the rank's device (also :func:`rank_device`)."""
    global _RANK_DEVICE
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    dev = _device_of(device, rank, ranks, backend, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE = dev
    return dev


def _entry(rank: int, fn: Callable, ranks: int, backend: str, device, init_method: str,
           out_dir: str, timeout_s: float) -> None:
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    init_rank(backend, device, rank, ranks, init_method, timeout_s)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def under_torchrun() -> bool:
    return all(key in os.environ for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def spawn(fn: Callable, ranks: int, backend: str, device, args: tuple = (),
          timeout_s: float = 900.0) -> dict:
    """Run ``fn(rank, *args)`` on ``ranks`` ranks of a ``backend`` group on
    ``device`` and return ``{rank: result}``; a rank that raises ends the
    others and raises here. Under ``torchrun`` this process is one rank:
    ``fn`` runs here and only its own result is returned."""
    if under_torchrun():
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world != ranks:
            raise ValueError(f"torchrun started {world} ranks, the run asks for {ranks}")
        if not dist.is_initialized():
            init_rank(backend, device, rank, world, "env://", timeout_s,
                      local_rank=int(os.environ.get("LOCAL_RANK", rank)))
        return {rank: fn(rank, *args)}
    import multiprocessing

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="rla4mor_ranks_")
    try:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        # the ranks fork from a server process that imported torch once (it
        # starts clean: no CUDA context, no threads of this process)
        multiprocessing.get_context("forkserver").set_forkserver_preload(["torch", __name__])
        mp.start_processes(_entry, args=(fn, ranks, backend, device, init_method, tmp,
                                         timeout_s),
                           nprocs=ranks, join=True, start_method="forkserver")
        return {r: torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(ranks)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
