"""DoF-sharded random sketching over a mesh of ranks.

Counterpart of ``rla4mor_tpu/parallel/sharded_sketch.py``. Each rank holds
a contiguous range of the rows of the sketched columns and computes its
(k, m) share of the sketch; one ``all_reduce`` over the ``"dof"`` group
sums the shares, so every rank ends with the whole sketch.

* Gaussian: the rank draws its column block of the canonical Omega of the
  seed (``ops/seeding.py``, in column chunks) and multiplies its rows. The
  result is ``GaussianEmbedding(k, n, seed).random_matrix() @ x`` for any
  rank count, up to the order of the sums. Omega is drawn on the host in
  float64, which at millions of rows a rank bounds the sketch's time.
* SRHT, flat (the main path): the rank applies the one-pass kernel of
  ``ops/srht_cuda.py`` to its rows with their global block index
  (``block_offset``), against the canonical plan of the seed (or a
  carried one). A range that starts inside a kernel block (2^11 rows) takes
  one more launch on that block's head, zero-padded in front. Any row
  partition works: the zero-padded layout of :func:`flat_shard_rows` (the
  JAX package's) and the stencil slab's node rows alike.
* SRHT, butterfly: the rank's local FWHT, then log2(ranks) pair exchanges
  with rank i xor 2^s (through host memory on gloo, counted by
  ``parallel/mesh.py``), then the sampled rows, one ``all_reduce``.

Without a mesh the functions are the one-device sketches of the same
operators.
"""

from __future__ import annotations

import math

import torch

from rla4mor_tpu_torch.ops.fwht import ceil_log2, fwht
from rla4mor_tpu_torch.ops.seeding import gaussian_cols
from rla4mor_tpu_torch.parallel import mesh as pm

# the one-pass SRHT's block length, 2^min(11, d); the kernel's is 2^11
_R_LOG = 11


def gaussian_block(seed: int, k: int, block_size: int, block_index: int,
                   dtype=torch.float64, device=None) -> torch.Tensor:
    """(k, block_size) column block ``block_index`` of the canonical Omega,
    scaled 1/sqrt(k): drawn in float64 on the CPU (as
    ``GaussianEmbedding.random_matrix``), then cast and moved."""
    omega = gaussian_cols(seed, k, block_index * block_size, block_size, torch.float64)
    return omega.to(device=device, dtype=dtype)


def gaussian_sketch_blocked(seed: int, k: int, x: torch.Tensor,
                            n_blocks: int) -> torch.Tensor:
    """Omega @ x with Omega generated in ``n_blocks`` column blocks."""
    n = x.shape[0]
    if n % n_blocks:
        raise ValueError(f"gaussian_sketch_blocked: {n} rows in {n_blocks} blocks")
    bs = n // n_blocks
    out = x.new_zeros((k,) + tuple(x.shape[1:]))
    for b in range(n_blocks):
        out = out + gaussian_block(seed, k, bs, b, x.dtype, x.device) @ x[b * bs:(b + 1) * bs]
    return out


def gaussian_sketch_sharded(seed: int, k: int, x: torch.Tensor, mesh=None,
                            axis: str = "dof", max_omega_elems: int = 1 << 26,
                            row_offset: int | None = None) -> torch.Tensor:
    """Omega @ x for this rank's rows ``x`` of the sketched columns.

    The rank's Omega strip (columns ``[row_offset, row_offset + len(x))``,
    default ``axis_index * len(x)``, equal shares) is generated in column
    chunks of at most ``max_omega_elems`` entries (widths halved from the
    strip's while even) and accumulated chunk by chunk, as the JAX
    package's shard does; one ``all_reduce`` over ``axis`` sums the ranks'
    shares. Without a mesh: the whole sketch on one device."""
    n_local = x.shape[0]
    if row_offset is None:
        row_offset = pm.axis_index(mesh, axis) * n_local
    width = n_local
    while width * k > max_omega_elems and width % 2 == 0:
        width //= 2
    acc = x.new_zeros((k,) + tuple(x.shape[1:]))
    for j in range(n_local // width):
        omega = gaussian_cols(seed, k, row_offset + j * width, width, torch.float64)
        acc = acc + omega.to(device=x.device, dtype=x.dtype) @ x[j * width:(j + 1) * width]
    if mesh is not None:
        acc = pm.all_reduce(acc, pm.axis_group(mesh, axis))
    return acc


def flat_shard_rows(n: int, mesh=None, axis: str = "dof", block: int | None = None
                    ) -> tuple[int, int]:
    """(n_phys, R) of the zero-padded whole-R-block row layout of the flat
    sharded SRHT for a true length ``n`` (the JAX package's): blocks of R =
    2^min(11, d) rows, shrunk until each rank of ``axis`` holds one, and
    rounded up to a multiple of the axis size. Rank i holds the padded rows
    ``[i n_phys / p, (i + 1) n_phys / p)``."""
    n_devices = pm.axis_size(mesh, axis)
    d = ceil_log2(max(n, 1))
    R = (1 << min(_R_LOG, d)) if block is None else block
    if R & (R - 1):
        raise ValueError(f"flat_shard_rows: block {R} is not a power of two")
    while R > 1 and -(-n // R) < n_devices:
        R //= 2
    b_total = -(-(-(-n // R)) // n_devices) * n_devices
    return b_total * R, R


def srht_partial(x: torch.Tensor, k: int, signs: torch.Tensor, sampling: torch.Tensor,
                 row0: int) -> torch.Tensor:
    """(k, m) share of rows ``[row0, row0 + len(x))`` of a longer vector in
    its SRHT, in the sums' dtype: one-pass kernel launches
    (``srht_onepass`` with ``block_offset``) on the range, split where it
    starts inside a 2^11-row block: that block's head, zero-padded in front,
    takes a launch of its own. ``signs`` are x's rows' signs."""
    from rla4mor_tpu_torch.ops.srht_cuda import accumulator_dtype, srht_onepass

    R = 1 << _R_LOG
    n, m = x.shape
    acc = accumulator_dtype(x.dtype)
    out = None
    lead = row0 % R
    if lead and n:
        h = min(n, R - lead)
        head = x.new_zeros((lead + h, m))
        head[lead:] = x[:h]
        head_signs = signs.new_zeros(lead + h)
        head_signs[lead:] = signs[:h]
        out = srht_onepass(head, k, head_signs, sampling, acc, block_offset=row0 // R)
        x, signs, row0 = x[h:], signs[h:], row0 + h
    if x.shape[0]:
        part = srht_onepass(x, k, signs, sampling, acc, block_offset=row0 // R)
        out = part if out is None else out + part
    return x.new_zeros((k, m), dtype=acc) if out is None else out


def srht_sketch_sharded_flat(x: torch.Tensor, k: int, signs: torch.Tensor,
                             sampling: torch.Tensor, mesh, n: int, axis: str = "dof",
                             row_offset: int | None = None) -> torch.Tensor:
    """Flat sharded SRHT of this rank's rows ``x`` ((rows,) or (rows, m)),
    one ``all_reduce`` of a (k, m) share; result in x's dtype, whole on
    every rank.

    ``signs`` (n,) and ``sampling`` (k,) are the whole plan (every rank
    holds it; ``sampling`` rows of [0, 2^ceil(log2 n))). ``row_offset``:
    the global index of x's first row; by default the layout of
    :func:`flat_shard_rows` (rank i's padded rows start at i n_phys / p, and
    x must hold n_phys / p of them). Rows at or past the true length ``n``
    (the layout's zero tail) are not read."""
    single = x.dim() == 1
    xm = x[:, None] if single else x
    if row_offset is None:
        n_phys, _ = flat_shard_rows(n, mesh, axis)
        p = pm.axis_size(mesh, axis)
        if xm.shape[0] * p != n_phys:
            raise ValueError(f"srht_sketch_sharded_flat: {xm.shape[0]} rows a rank; the "
                             f"flat layout of n={n} holds {n_phys // p}")
        row_offset = pm.axis_index(mesh, axis) * xm.shape[0]
    valid = max(0, min(xm.shape[0], n - row_offset))
    sg = signs[row_offset:row_offset + valid].to(xm.device)
    out = srht_partial(xm[:valid], k, sg, sampling, row_offset)
    if mesh is not None:
        out = pm.all_reduce(out, pm.axis_group(mesh, axis))
    out = out.to(x.dtype)
    return out[:, 0] if single else out


def srht_blocked(k: int, x: torch.Tensor, signs: torch.Tensor,
                 sampling: torch.Tensor) -> torch.Tensor:
    """One-device oracle of the sharded SRHT: sqrt(n/k) P H D x by the FWHT
    along axis 0, n = len(x) a power of two (pre-padded; ``signs`` zero on
    the padding)."""
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"srht_blocked: n={n} is not a power of two (pre-pad it)")
    single = x.dim() == 1
    xm = x[:, None] if single else x
    y = xm * signs.to(device=x.device, dtype=x.dtype)[:, None]
    y = fwht(y.T, normalize=True).T
    out = math.sqrt(n / k) * y[sampling.to(device=x.device, dtype=torch.int64)]
    return out[:, 0] if single else out


def srht_sketch_sharded(x: torch.Tensor, k: int, signs: torch.Tensor,
                        sampling: torch.Tensor, mesh, axis: str = "dof") -> torch.Tensor:
    """Butterfly sharded SRHT of this rank's equal share ``x`` of a
    power-of-two n = len(x) ranks (a power of two): the rank's signs and
    FWHT, then log2(ranks) pair exchanges with rank i xor 2^s (H = H_ranks
    (x) H_local, rank index major), the sampled rows gathered by one
    ``all_reduce``. ``signs`` (n,) whole, zero past the true length."""
    p = pm.axis_size(mesh, axis)
    c = p.bit_length() - 1
    if 1 << c != p:
        raise ValueError(f"srht_sketch_sharded: {p} ranks is not a power of two")
    single = x.dim() == 1
    xm = x[:, None] if single else x
    n_local = xm.shape[0]
    n = n_local * p
    if n & (n - 1):
        raise ValueError(f"srht_sketch_sharded: n={n} is not a power of two")
    b = pm.axis_index(mesh, axis)
    group = None if mesh is None else pm.axis_group(mesh, axis)
    d = signs[b * n_local:(b + 1) * n_local].to(device=xm.device, dtype=xm.dtype)
    y = fwht((xm * d[:, None]).T, normalize=True).T
    for s in range(c):
        other = pm.exchange(y, b ^ (1 << s), group)
        y = y + other if (b >> s) & 1 == 0 else other - y
    y = y * (2.0 ** (-c / 2.0))
    samp = sampling.to(device=xm.device, dtype=torch.int64)
    mine = (samp // n_local == b).to(y.dtype)
    out = y[samp % n_local] * mine[:, None]
    if group is not None:
        out = pm.all_reduce(out, group)
    out = math.sqrt(n / k) * out
    return out[:, 0] if single else out
