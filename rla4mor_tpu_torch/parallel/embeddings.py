"""Mesh-sharded embeddings.

Counterpart of ``rla4mor_tpu/parallel/embeddings.py``: the sharded sketches
of ``parallel/sharded_sketch.py`` behind the embedding methods, so a
reductor or the greedy driver sketches its rank's rows of a DoF-sharded
block directly. ``apply`` takes this rank's rows and returns the whole
(k, m) sketch on every rank; ``apply_blocked`` is the one-device oracle of
the same operator on the whole columns; ``matrix`` the explicit (k, n)
operator. The operator is a function of the seed (or of a carried plan)
only, not of the rank count.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from rla4mor_tpu_torch.parallel import mesh as pm
from rla4mor_tpu_torch.parallel.sharded_sketch import (
    flat_shard_rows,
    gaussian_block,
    gaussian_sketch_blocked,
    gaussian_sketch_sharded,
    srht_sketch_sharded,
    srht_sketch_sharded_flat,
)


def _fresh_seed(seed: Optional[int]) -> int:
    return int(np.random.randint(0, 2**31 - 1)) if seed is None else int(seed)


@dataclass(frozen=True)
class ShardedGaussianEmbedding:
    """Gaussian l2 -> l2 embedding across the ``axis`` of ``mesh``: the
    canonical N(0, 1/k) Omega of ``seed``, each rank drawing its column
    block. ``source_dim`` splits evenly over the axis; rank i holds rows
    ``[i n / p, (i + 1) n / p)``."""

    range_dim: int
    source_dim: int
    mesh: Any
    seed: int = 0
    axis: str = "dof"
    dtype: Any = None

    def __post_init__(self):
        if self.source_dim % pm.axis_size(self.mesh, self.axis):
            raise ValueError(f"ShardedGaussianEmbedding: n={self.source_dim} does not split "
                             f"over {pm.axis_size(self.mesh, self.axis)} ranks")

    @property
    def n_local(self) -> int:
        return self.source_dim // pm.axis_size(self.mesh, self.axis)

    def with_seed(self, seed: Optional[int]):
        return dataclasses.replace(self, seed=_fresh_seed(seed))

    def _in(self, U) -> torch.Tensor:
        U = torch.as_tensor(U)
        return U if self.dtype is None else U.to(self.dtype)

    def apply(self, U, mu=None, row_offset: Optional[int] = None):
        """Sketch of this rank's rows U ((n_local,) or (n_local, m))."""
        return gaussian_sketch_sharded(self.seed, self.range_dim, self._in(U), self.mesh,
                                       self.axis, row_offset=row_offset)

    def apply_blocked(self, U):
        """One-device oracle on the whole columns (Omega in the mesh's blocks)."""
        return gaussian_sketch_blocked(self.seed, self.range_dim, self._in(U),
                                       pm.axis_size(self.mesh, self.axis))

    def matrix(self, device=None) -> torch.Tensor:
        p = pm.axis_size(self.mesh, self.axis)
        dt = torch.float64 if self.dtype is None else self.dtype
        return torch.cat([gaussian_block(self.seed, self.range_dim, self.n_local, b, dt,
                                         device) for b in range(p)], dim=1)

    def apply_adjoint(self, V, mu=None):
        """This rank's rows of Omega^H V ((k,) or (k, cols) replicated ->
        (n_local,) or (n_local, cols)): the rank's Omega block only, Omega
        never held whole."""
        V = self._in(V)
        block = gaussian_block(self.seed, self.range_dim, self.n_local,
                               pm.axis_index(self.mesh, self.axis), V.dtype, V.device)
        return block.conj().T @ V


@dataclass(frozen=True)
class ShardedSrhtEmbedding:
    """Sharded SRHT (the canonical operator of ``ops/fwht.py`` /
    ``SrhtEmbedding``): ``variant="flat"`` (default) sums the ranks' kernel
    shares with one ``all_reduce``; ``variant="butterfly"`` runs the local
    FWHT and the pair exchanges, and needs a power-of-two padded length.
    Rank i's rows are those of :func:`flat_shard_rows`'s layout unless
    ``apply`` is given the ``row_offset`` of its rows (the flat variant).
    ``plan``: (signs (n,), sampling (k,)), default the seed's."""

    range_dim: int
    source_dim: int
    mesh: Any
    seed: int = 0
    axis: str = "dof"
    variant: str = "flat"
    plan: Any = None

    def __post_init__(self):
        if self.variant not in ("flat", "butterfly"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.plan is None:
            from rla4mor_tpu_torch.ops.fwht import _srht_plan

            signs, sampling, _ = _srht_plan(self.seed, self.source_dim, self.range_dim)
            object.__setattr__(self, "plan", (signs, sampling))

    @classmethod
    def from_plan(cls, signs, sampling, mesh, axis: str = "dof", variant: str = "flat",
                  device=None) -> "ShardedSrhtEmbedding":
        """The embedding of a given plan: ``signs`` (n,) +-1 and ``sampling``
        (k,) rows of [0, 2^ceil(log2 n)) (e.g. the JAX package's
        ``ops.fwht._srht_plan``, for parity), kept on ``device`` in the
        kernel's types."""
        signs = torch.as_tensor(np.array(signs)).to(device=device, dtype=torch.int8)
        sampling = torch.as_tensor(np.array(sampling)).to(device=device, dtype=torch.int32)
        return cls(int(sampling.shape[0]), int(signs.shape[0]), mesh, axis=axis,
                   variant=variant, plan=(signs, sampling))

    def to(self, device) -> "ShardedSrhtEmbedding":
        """The plan on ``device`` in the kernel's types (int8, int32)."""
        signs, sampling = self.plan
        return dataclasses.replace(self, plan=(signs.to(device, torch.int8).contiguous(),
                                               sampling.to(device, torch.int32).contiguous()))

    def with_seed(self, seed: Optional[int]):
        return dataclasses.replace(self, seed=_fresh_seed(seed), plan=None)

    @property
    def layout(self) -> tuple[int, int]:
        """(n_phys, R) of the padded flat layout (:func:`flat_shard_rows`)."""
        return flat_shard_rows(self.source_dim, self.mesh, self.axis)

    def apply(self, U, mu=None, row_offset: Optional[int] = None):
        """Sketch of this rank's rows U ((rows,) or (rows, m)), whole on every
        rank."""
        U = torch.as_tensor(U)
        signs, sampling = self.plan
        if self.variant == "butterfly":
            if row_offset is not None:
                raise ValueError("the butterfly SRHT takes the flat layout's equal shares")
            return srht_sketch_sharded(U, self.range_dim, self._padded_signs(U.device),
                                       sampling, self.mesh, self.axis)
        return srht_sketch_sharded_flat(U, self.range_dim, signs, sampling, self.mesh,
                                        self.source_dim, self.axis, row_offset)

    def _padded_signs(self, device) -> torch.Tensor:
        signs = self.plan[0].to(device)
        n_phys, _ = self.layout
        return torch.cat([signs, signs.new_zeros(n_phys - self.source_dim)])

    def apply_blocked(self, U):
        """One-device oracle on the whole (n,) or (n, m) columns."""
        from rla4mor_tpu_torch.ops.srht_cuda import srht_onepass

        U = torch.as_tensor(U)
        signs, sampling = self.plan
        single = U.dim() == 1
        out = srht_onepass(U[:, None] if single else U, self.range_dim,
                           signs.to(U.device), sampling)
        return out[:, 0] if single else out

    def matrix(self, device=None) -> torch.Tensor:
        """The explicit (k, n) operator in float64."""
        from rla4mor_tpu_torch.ops.fwht import ceil_log2, srht_rows

        signs, sampling = self.plan
        plan = (signs.cpu(), sampling.cpu().long(), ceil_log2(self.source_dim))
        return srht_rows(plan, self.source_dim, self.range_dim, device=device or "cpu")
