"""Device meshes over ``torch.distributed`` process groups.

Counterpart of ``rla4mor_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised default
process group, one rank a mesh position, with the DoF axis ``"dof"`` and,
optionally, a parameter-batch axis ``"mu"``. Where the JAX package shards
one array over the mesh and lets its compiler place the collectives, each
rank here holds its own rows and the port's sharded code calls the
collectives itself, through the helpers below: every rank of a group calls
them in the same order.

On a gloo group a CUDA tensor is copied to host memory, reduced or
gathered there and copied back, explicitly: gloo takes host memory (on an
H100 machine with torch 2.x, an ``all_reduce`` of a CUDA tensor on gloo
aborted the process with ``writev ... Bad address``). ``COMM`` counts each
collective, its host seconds (on gloo the call returns when it is done, so
its host time is its cost; on NCCL the call only enqueues) and the host
copies.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: collectives by kind, their host seconds and the host copies of
#: point-to-point transfers (reset by :func:`reset_comm`)
COMM = {"calls": collections.Counter(), "seconds": 0.0, "host_copies": 0}


def reset_comm() -> None:
    COMM["calls"].clear()
    COMM["seconds"] = 0.0
    COMM["host_copies"] = 0


def make_mesh(axis_names: Tuple[str, ...] = ("dof",),
              shape: Optional[Tuple[int, ...]] = None, device=None):
    """A ``DeviceMesh`` over the initialised default group: ``shape``
    (default: every rank on the first axis) with ``axis_names``, e.g.
    ``("dof",)`` or ``("dof", "mu")``. Rank r sits at the row-major
    position of r. ``device``: the rank's device (default: the one
    :func:`~rla4mor_tpu_torch.parallel.launch.spawn` set, else the current
    card; it picks the mesh's device type only)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks with "
                           "parallel.launch.spawn or torchrun")
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"make_mesh: shape {shape} over axes {axis_names} does not "
                         f"hold the {world} ranks")
    if device is None:
        from rla4mor_tpu_torch.parallel.launch import rank_device

        device = rank_device()
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axis_names)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    names = list(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    return int(mesh.size(names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's position along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis`` (its group rank
    is its position there)."""
    return mesh.get_group(axis)


def row_range(n_rows: int, mesh, axis: str = "dof") -> Tuple[int, int]:
    """[r0, r1): this rank's equal share of ``n_rows`` rows along ``axis``."""
    p = axis_size(mesh, axis)
    if n_rows % p:
        raise ValueError(f"row_range: {n_rows} rows do not split over {p} ranks of {axis!r}")
    share = n_rows // p
    i = axis_index(mesh, axis)
    return i * share, (i + 1) * share


def _timed(kind: str, fn):
    t0 = time.perf_counter()
    out = fn()
    COMM["seconds"] += time.perf_counter() - t0
    COMM["calls"][kind] += 1
    return out


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through host memory for ``group`` (a CUDA tensor on
    a gloo group)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``: the returned tensor (``t`` itself, made
    contiguous, unless it went through host memory)."""
    if _staged(t, group):
        host = t.detach().cpu()
        _timed("all_reduce", lambda: dist.all_reduce(host, group=group))
        COMM["host_copies"] += 2
        return host.to(t.device)
    t = t.contiguous()
    _timed("all_reduce", lambda: dist.all_reduce(t, group=group))
    return t


def all_gather(t: torch.Tensor, group) -> list:
    """``t`` of every rank of ``group``, in group-rank order."""
    staged = _staged(t, group)
    src = t.detach().cpu() if staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _timed("all_gather", lambda: dist.all_gather(out, src, group=group))
    if staged:
        COMM["host_copies"] += 2
        return list(torch.stack(out).to(t.device).unbind(0))  # one copy back
    return out


def all_gather_rows(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    return torch.cat(all_gather(t, group), dim=dim)


def exchange(t: torch.Tensor, peer: int, group) -> torch.Tensor:
    """``t`` sent to group rank ``peer``, and ``peer``'s tensor of the same
    shape received. On gloo a CUDA tensor is copied to host memory and back
    (gloo's point-to-point moves host memory), counted in
    ``COMM["host_copies"]``."""
    dst = dist.get_global_rank(group, peer)
    staged = _staged(t, group)
    send = t.detach().cpu() if staged else t.contiguous()
    recv = torch.empty_like(send)

    def run():
        req = dist.isend(send, dst, group=group)
        dist.recv(recv, dst, group=group)
        req.wait()

    _timed("exchange", run)
    if staged:
        COMM["host_copies"] += 2
        return recv.to(t.device)
    return recv


def gather_batch(values: torch.Tensor, mesh, axis: str = "mu") -> torch.Tensor:
    """Each rank's (B / p, ...) share of a batch along ``axis`` gathered into
    the whole (B, ...) batch on every rank."""
    if axis_size(mesh, axis) == 1:
        return values
    return all_gather_rows(values, axis_group(mesh, axis))


def batch_share(count: int, mesh, axis: str = "mu") -> slice:
    """This rank's rows of a batch of ``count`` split along ``axis``; the
    batch must be a multiple of the axis."""
    p = axis_size(mesh, axis)
    if count % p:
        raise ValueError(f"a batch of {count} does not split over the {p} ranks of "
                         f"{axis!r}; pad it to a multiple (serve.pad_batch)")
    share = count // p
    i = axis_index(mesh, axis)
    return slice(i * share, (i + 1) * share)


def describe(mesh) -> str:
    """'dof=2 x mu=1' style summary of a mesh."""
    names: Sequence[str] = mesh.mesh_dim_names
    return " x ".join(f"{a}={axis_size(mesh, a)}" for a in names)
