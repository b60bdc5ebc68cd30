"""Random embeddings (oblivious l2 -> l2 and U -> l2 subspace embeddings).

Counterpart of ``rla4mor_tpu/ops/embeddings.py``: the Gaussian,
Rademacher, sparse-sign, block and streamed Gaussian, identity, SRHT and
hardware-PRNG Gaussian embeddings. Contract: an embedding Theta wraps an
optional ``sqrt_product`` Q with Q^H Q = R; ``apply(U) = Omega (Q U)`` where
Omega is the l2 -> l2 random matrix; ``matrix()`` is the (k, n) map Omega Q.

An embedding lives on an explicit ``device``. Its random operator is drawn
from explicit CPU generators (``ops/seeding.py``) and moved there, or carried
across from the JAX package (``from_matrix``, ``SrhtEmbedding.from_plan``,
``SparseSignEmbedding.from_plan``), which is how the parity tests hold the
two packages to the same operator. ``complex_dtype=True`` makes Omega itself
complex where the JAX package does (Gaussian and its block / streamed
forms, Rademacher) and switches the SRHT's dimension formula to its complex
constants (its Omega stays real); complex data goes through any embedding.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from rla4mor_tpu_torch.core.linops import LinOp, matmul
from rla4mor_tpu_torch.ops import dims as _dims
from rla4mor_tpu_torch.ops import seeding
from rla4mor_tpu_torch.ops.fwht import Plan, _srht_plan, ceil_log2, srht, srht_rows
from rla4mor_tpu_torch.ops.gaussian_cuda import (
    DEFAULT_BLOCK_ROWS,
    gaussian_omega,
    gaussian_sketch,
)
from rla4mor_tpu_torch.ops.srht_cuda import srht_onepass
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device


class Embedding(LinOp):
    """Base class. ``range_dim`` = k, ``source_dim`` = n (U-space)."""

    def __init__(self, range_dim: int, source_dim: int, seed: int = 0,
                 sqrt_product: Optional[LinOp] = None, device=None, dtype=None,
                 complex_dtype: bool = False):
        if sqrt_product is not None and sqrt_product.source_dim != source_dim:
            raise ValueError("sqrt_product does not act on the source space")
        self.range_dim = int(range_dim)
        self.source_dim = int(source_dim)
        self.seed = int(seed)
        self.sqrt_product = sqrt_product
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.complex_dtype = bool(complex_dtype)
        self._omega = None
        self._theta = None

    @property
    def omega_dtype(self) -> torch.dtype:
        """Dtype of Omega: the working dtype, complex for ``complex_dtype``."""
        if self.complex_dtype and not self.dtype.is_complex:
            return torch.promote_types(self.dtype, torch.complex64)
        return self.dtype

    def fields(self) -> dict:
        """The scalar fields that, with the class, name the operator (what a
        checkpoint fingerprints): sizes, seed, ``complex_dtype`` and the
        subclass's own (:meth:`_extra_fields`)."""
        return {"range_dim": self.range_dim, "source_dim": self.source_dim,
                "seed": self.seed, "complex_dtype": self.complex_dtype,
                **self._extra_fields()}

    def _extra_fields(self) -> dict:
        return {}

    def _replace(self, **changes) -> "Embedding":
        """The same family with ``changes`` to :meth:`fields`, drawn anew."""
        kw = {**self.fields(), **changes}
        return type(self)(kw.pop("range_dim"), kw.pop("source_dim"), kw.pop("seed"),
                          self.sqrt_product, self.device, self.dtype, **kw)

    # the a-priori dimension formula ``make`` uses (ops/dims.py)
    _dim_kind = "gaussian"

    @classmethod
    def make(cls, source_dim, sqrt_product=None, range_dim=None, epsilon=None,
             delta=None, oblivious_dim=None, seed=0, device=None, dtype=None,
             complex_dtype=False, **extra):
        """Embedding of sketch size ``range_dim``, or of the a-priori bound
        for (epsilon, delta, oblivious_dim); ``extra`` are the family's own
        fields (``s``, ``max_block_size``, ``block_cols``, ...)."""
        k = _dims.resolve_dim(cls._dim_kind, source_dim, range_dim, epsilon, delta,
                              oblivious_dim, complex_dtype)
        return cls(k, source_dim, seed, sqrt_product, device, dtype,
                   complex_dtype=complex_dtype, **extra)

    def with_seed(self, seed: Optional[int]) -> "Embedding":
        """Same family and sizes, fresh randomness drawn from ``seed``."""
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        return self._replace(seed=seed)

    def with_range_dim(self, range_dim: int) -> "Embedding":
        """Same family and seed at sketch size ``range_dim`` (the
        ``reduce_adaptive`` doubling)."""
        return self._replace(range_dim=int(range_dim))

    @property
    def l2_dim(self) -> int:
        """Dimension of the intermediate l2 space (= Q's range)."""
        return (self.sqrt_product.range_dim if self.sqrt_product is not None
                else self.source_dim)

    # whether ``apply_random`` takes ``out_dtype`` (``CastInputOp`` asks)
    emits_out_dtype = False

    def _in(self, X) -> torch.Tensor:
        """X on the embedding's device: real data in the working dtype, but a
        bfloat16 / float16 tensor (the bf16 offline mode's input) in its
        own, which products then promote as the JAX package's do."""
        if isinstance(X, torch.Tensor) and X.dtype in (torch.bfloat16, torch.float16):
            return X.to(self.device)
        return as_tensor(X, self.device, self.dtype)

    def _apply_q(self, U) -> torch.Tensor:
        if self.sqrt_product is None:
            return self._in(U)
        return self._in(self.sqrt_product.apply(U))

    def apply_random(self, X) -> torch.Tensor:
        """l2 -> l2 sketch Omega @ X, X (l2_dim,) or (l2_dim, b)."""
        return matmul(self.random_matrix_cached(), self._in(X))

    def apply(self, U, mu=None) -> torch.Tensor:
        return self.apply_random(self._apply_q(U))

    def apply_adjoint(self, V, mu=None):
        """Theta^H V = Q^H (Omega^H V)."""
        W = matmul(self.random_matrix_cached().conj().T, self._in(V))
        if self.sqrt_product is None:
            return W
        return self._in(self.sqrt_product.apply_adjoint(W))

    def random_matrix(self) -> torch.Tensor:
        """The (k, l2_dim) l2 -> l2 matrix Omega."""
        raise NotImplementedError

    def random_matrix_cached(self) -> torch.Tensor:
        if self._omega is None:
            self._omega = self.random_matrix()
        return self._omega

    def matrix(self) -> torch.Tensor:
        """The (k, n) U -> l2 matrix Theta = Omega Q."""
        if self._theta is None:
            om = self.random_matrix_cached()
            if self.sqrt_product is None:
                self._theta = om
            else:  # Theta = (Q^H Omega^H)^H
                self._theta = self._in(
                    self.sqrt_product.apply_adjoint(om.conj().T)).conj().T.resolve_conj()
        return self._theta

    def source_array(self) -> torch.Tensor:
        """Theta^H (n, k): the rows of Theta as U-space vectors."""
        return self.matrix().conj().T.resolve_conj()

    def range_array(self) -> torch.Tensor:
        """Theta^T (n, k)."""
        return self.matrix().T


class DenseEmbedding(Embedding):
    """A family that applies its Omega as an explicit (k, l2_dim) matrix,
    drawn from the seed or carried in (:meth:`from_matrix`)."""

    @classmethod
    def from_matrix(cls, omega, sqrt_product=None, seed=0, device=None, dtype=None,
                    **extra) -> "DenseEmbedding":
        """Embedding with a given (k, l2_dim) Omega (e.g. the JAX package's
        ``random_matrix()``, for parity); a complex Omega makes a
        ``complex_dtype`` embedding."""
        omega = np.array(omega)
        k, l2 = omega.shape
        n = sqrt_product.source_dim if sqrt_product is not None else l2
        emb = cls(k, n, seed, sqrt_product, device, dtype,
                  complex_dtype=np.iscomplexobj(omega), **extra)
        emb._omega = as_tensor(omega, emb.device, emb.omega_dtype)
        return emb


class GaussianEmbedding(DenseEmbedding):
    """Omega with iid N(0, 1/k) entries (complex ones with E|w|^2 = 1/k for
    ``complex_dtype``), drawn on the canonical tile grid (``ops/seeding.py``)
    or carried in with :meth:`from_matrix`. :class:`BlockGaussianEmbedding`
    and :class:`StreamedGaussianEmbedding` at the same seed name the same
    operator."""

    def _draw_dtype(self) -> torch.dtype:
        return torch.complex128 if self.complex_dtype else torch.float64

    def random_matrix(self):
        # cast on the host: the device holds Omega once, in its own dtype
        omega = seeding.gaussian_matrix(self.seed, self.range_dim, self.l2_dim,
                                        self._draw_dtype(), "cpu")
        return omega.to(self.device, self.omega_dtype)


class RademacherEmbedding(DenseEmbedding):
    """Omega with iid +-1/sqrt(k) entries, or (s1 + i s2)/sqrt(2k) for
    ``complex_dtype``: the Gaussian's second moments from sign bits, drawn
    on the tile grid (``seeding.rademacher_matrix``) or carried in with
    :meth:`from_matrix`."""

    def random_matrix(self):
        k = self.range_dim
        signs = seeding.rademacher_matrix(self.seed, k, self.l2_dim, self.complex_dtype)
        if self.complex_dtype:  # (s1 + i s2) / sqrt(2k), formed on the host
            omega = torch.complex(signs[0].double(), signs[1].double()) / math.sqrt(2 * k)
        else:
            omega = signs.double() / math.sqrt(k)
        return omega.to(self.device, self.omega_dtype)


class SparseSignEmbedding(Embedding):
    """s-sparse sign embedding (Clarkson-Woodruff / OSNAP): each column of
    Omega has s entries +-1/sqrt(s) at uniform rows (repeats add), applied
    by a scatter-add (``index_add_``) in O(s n m). Omega is real: a
    ``complex_dtype`` is refused, complex data goes through. The plan
    ``(rows, signs)``, each (l2_dim, s), comes from the seed
    (``seeding.sparse_sign_plan``) or is carried in with :meth:`from_plan`.
    On the card ``index_add_`` adds with atomics, so the last bits of a
    sketch vary from run to run."""

    def __init__(self, range_dim, source_dim, seed=0, sqrt_product=None,
                 device=None, dtype=None, complex_dtype=False, s: int = 8,
                 plan=None):
        if complex_dtype:
            raise ValueError("SparseSignEmbedding draws real signs; complex data "
                             "through it works: use GaussianEmbedding for a "
                             "complex Omega")
        super().__init__(range_dim, source_dim, seed, sqrt_product, device, dtype)
        self.s = int(s)
        if plan is None:
            plan = seeding.sparse_sign_plan(self.seed, self.l2_dim, self.range_dim, self.s)
        rows, signs = (torch.as_tensor(p if isinstance(p, torch.Tensor) else np.array(p))
                       for p in plan)
        if tuple(rows.shape) != (self.l2_dim, self.s) or rows.shape != signs.shape:
            raise ValueError(f"sparse-sign plan {tuple(rows.shape)} is not "
                             f"({self.l2_dim}, {self.s})")
        if int(rows.min()) < 0 or int(rows.max()) >= self.range_dim:
            raise ValueError("sparse-sign rows must lie in [0, k)")
        self.plan = (rows.to(self.device, torch.int64), signs.to(self.device, torch.int8))

    def _extra_fields(self):
        return {"s": self.s}

    @classmethod
    def from_plan(cls, rows, signs, range_dim, sqrt_product=None, seed=0,
                  device=None, dtype=None) -> "SparseSignEmbedding":
        """Embedding with a given plan: ``rows`` (l2_dim, s) in [0, k) and
        ``signs`` (l2_dim, s) +-1 (e.g. the JAX package's ``_plan()``)."""
        rows = np.asarray(rows)
        n = sqrt_product.source_dim if sqrt_product is not None else rows.shape[0]
        return cls(range_dim, n, seed, sqrt_product, device, dtype, s=rows.shape[1],
                   plan=(rows, signs))

    def _values(self, dtype) -> torch.Tensor:
        """(l2_dim, s) entries signs / sqrt(s) in ``dtype``."""
        return self.plan[1].to(dtype) / math.sqrt(self.s)

    def apply_random(self, X):
        """Omega @ X by one scatter-add of the (l2_dim s, m) signed copies of
        X's rows (a complex X as its real and imaginary parts)."""
        X = self._in(X)
        single = X.dim() == 1
        Xm = X[:, None] if single else X
        if Xm.shape[0] != self.l2_dim:
            raise ValueError(f"input has {Xm.shape[0]} rows, embedding n={self.l2_dim}")
        Xr = torch.view_as_real(Xm).flatten(1) if Xm.is_complex() else Xm
        vals = self._values(Xr.dtype)[..., None] * Xr[:, None, :]      # (n, s, w)
        out = Xr.new_zeros((self.range_dim, Xr.shape[1]))
        out.index_add_(0, self.plan[0].reshape(-1), vals.reshape(-1, Xr.shape[1]))
        if Xm.is_complex():
            out = torch.view_as_complex(out.reshape(self.range_dim, -1, 2).contiguous())
        return out[:, 0] if single else out

    def random_matrix(self):
        rows, _ = self.plan
        cols = torch.arange(self.l2_dim, device=self.device)[:, None].expand_as(rows)
        out = torch.zeros((self.range_dim, self.l2_dim), dtype=self.dtype, device=self.device)
        return out.index_put_((rows.reshape(-1), cols.reshape(-1)),
                              self._values(self.dtype).reshape(-1), accumulate=True)


class BlockGaussianEmbedding(GaussianEmbedding):
    """The Gaussian embedding generated and applied in row blocks of at
    most ``max_block_size`` rows: block b is rows ``[b B, b B + size_b)`` of
    the canonical Omega (``seeding.gaussian_rows``), so at the same seed its
    ``random_matrix`` is :class:`GaussianEmbedding`'s, bit for bit, and a
    block never needs the whole Omega. A carried Omega (``from_matrix``)
    is cut into the same blocks."""

    def __init__(self, range_dim, source_dim, seed=0, sqrt_product=None, device=None,
                 dtype=None, complex_dtype=False, max_block_size: int = 128):
        super().__init__(range_dim, source_dim, seed, sqrt_product, device, dtype,
                         complex_dtype)
        self.max_block_size = int(max_block_size)

    def _extra_fields(self):
        return {"max_block_size": self.max_block_size}

    @property
    def block_sizes(self) -> tuple:
        m, r = divmod(self.range_dim, self.max_block_size)
        return tuple([self.max_block_size] * m + ([r] if r else []))

    @property
    def n_blocks(self) -> int:
        return len(self.block_sizes)

    def random_block(self, b: int) -> torch.Tensor:
        """(block_size, l2_dim) rows of Omega for block b."""
        r0 = b * self.max_block_size
        r1 = r0 + self.block_sizes[b]
        if self._omega is not None:
            return self._omega[r0:r1]
        rows = seeding.gaussian_rows(self.seed, self.l2_dim, r0, r1, self._draw_dtype())
        return (rows / math.sqrt(self.range_dim)).to(self.device, self.omega_dtype)

    def block_source_array(self, b: int) -> torch.Tensor:
        """(n, block_size) columns (Omega_b Q)^H: block b of Theta's rows as
        U-space vectors."""
        rb = self.random_block(b).conj().T.resolve_conj()
        if self.sqrt_product is None:
            return rb
        return self._in(self.sqrt_product.apply_adjoint(rb))

    def apply_random(self, X):
        X = self._in(X)
        return torch.cat([matmul(self.random_block(b), X) for b in range(self.n_blocks)])

    def random_matrix(self):
        return torch.cat([self.random_block(b) for b in range(self.n_blocks)])


class StreamedGaussianEmbedding(GaussianEmbedding):
    """The Gaussian embedding applied by streaming column strips of Omega:
    strip b, columns ``[b W, (b + 1) W)`` (W = ``block_cols``, a multiple of
    ``seeding.TILE_N``), is drawn on the host from the canonical tiles,
    scaled as :class:`GaussianEmbedding` scales them, copied to the device
    and multiplied into the (k, m) accumulator, while a host thread draws
    strip b + 1. Device memory holds one strip and the accumulator, never
    the (k, n) Omega; ``random_matrix`` is the Gaussian's whole matrix. A
    carried Omega (``from_matrix``) is streamed the same way."""

    def __init__(self, range_dim, source_dim, seed=0, sqrt_product=None, device=None,
                 dtype=None, complex_dtype=False, block_cols: int = 1 << 16):
        if block_cols % seeding.TILE_N:
            raise ValueError(f"block_cols={block_cols} is not a multiple of "
                             f"TILE_N={seeding.TILE_N}")
        super().__init__(range_dim, source_dim, seed, sqrt_product, device, dtype,
                         complex_dtype)
        self.block_cols = int(block_cols)

    def _extra_fields(self):
        return {"block_cols": self.block_cols}

    def _strip(self, c0: int, width: int, dtype) -> torch.Tensor:
        """Scaled (k, width) strip of Omega at column c0, on the host."""
        if self._omega is not None:
            return self._omega[:, c0:c0 + width].to(dtype)
        k = self.range_dim
        cols = seeding.gaussian_cols_unscaled(self.seed, k, c0, width, self._draw_dtype())
        return (cols / math.sqrt(k)).to(dtype)

    def apply_random(self, X):
        X = self._in(X)
        single = X.dim() == 1
        Xm = X[:, None] if single else X
        n, W = self.l2_dim, self.block_cols
        if Xm.shape[0] != n:
            raise ValueError(f"input has {Xm.shape[0]} rows, embedding n={n}")
        dt = torch.promote_types(self.omega_dtype, Xm.dtype)
        acc = Xm.new_zeros((self.range_dim, Xm.shape[1]), dtype=dt)
        starts = range(0, n, W)
        with ThreadPoolExecutor(1) as pool:
            draws = [pool.submit(self._strip, c0, min(W, n - c0), dt) for c0 in starts[:2]]
            for b, c0 in enumerate(starts):
                strip = draws[b].result().to(self.device)
                draws[b] = None
                if b + 2 < len(starts):  # the host draws ahead while the card multiplies
                    c2 = starts[b + 2]
                    draws.append(pool.submit(self._strip, c2, min(W, n - c2), dt))
                acc += strip @ Xm[c0:c0 + strip.shape[1]].to(dt)
                del strip
        return acc[:, 0] if single else acc


class IdentityEmbedding(Embedding):
    """Theta = Q: maps U to l2 w.r.t. the product, no randomness."""

    def __init__(self, source_dim, sqrt_product=None, seed=0, device=None,
                 dtype=None):
        l2 = sqrt_product.range_dim if sqrt_product is not None else source_dim
        super().__init__(l2, source_dim, seed, sqrt_product, device, dtype)

    def apply_random(self, X):
        return self._in(X)

    def apply(self, U, mu=None):
        return self._apply_q(U)

    def apply_adjoint(self, V, mu=None):
        if self.sqrt_product is None:
            return self._in(V)
        return self._in(self.sqrt_product.apply_adjoint(V))

    def random_matrix(self):
        return torch.eye(self.l2_dim, dtype=self.dtype, device=self.device)

    def with_seed(self, seed):
        return self  # deterministic operator: redrawing is a no-op

    def with_range_dim(self, range_dim):
        if int(range_dim) != self.range_dim:
            raise ValueError(
                "IdentityEmbedding has no adjustable sketch size: its range "
                f"dim is fixed to the l2 dim {self.range_dim}")
        return self


class SrhtEmbedding(Embedding):
    """Subsampled randomised Hadamard transform (semantics in ops/fwht.py).

    ``apply_random`` dispatches as the JAX package does, at another size:
    for n >= 2^15 (``_ONEPASS_MIN_DIM``), and for pre-blocked ``(m, B, R)``
    input, the sketch is the one-pass SRHT of ``ops/srht_cuda.py`` — the
    hand-written kernel on a CUDA tensor; below, the Kronecker FWHT of
    ``ops/fwht.py``. The JAX package's 2^16 weighs the TPU kernel's compile
    time; at (36,481, 250) on an H100 80GB HBM3 (700 W) the kernel took
    0.087 ms and the FWHT route 1.06 ms (``chip_smoke.py``'s ``[estim]``
    SRHT row, ``fwht_ms``).
    bfloat16 / float16 input keeps its dtype (the bf16 offline mode);
    ``out_dtype`` picks the result's.
    """

    _ONEPASS_MIN_DIM = 1 << 15
    emits_out_dtype = True

    def __init__(self, range_dim, source_dim, seed=0, sqrt_product=None,
                 device=None, dtype=None, complex_dtype: bool = False,
                 plan: Optional[Plan] = None):
        super().__init__(range_dim, source_dim, seed, sqrt_product, device, dtype,
                         complex_dtype)
        if plan is None:
            plan = _srht_plan(self.seed, self.l2_dim, self.range_dim)
        rademacher, sampling, d = plan
        if rademacher.shape != (self.l2_dim,) or sampling.shape != (self.range_dim,):
            raise ValueError("SRHT plan does not match (n, k)")
        if d != ceil_log2(self.l2_dim) or int(sampling.max()) >= 1 << d:
            raise ValueError("SRHT sampling must lie in [0, 2^ceil(log2 n))")
        # the plan lives on the device once, in the kernel's types (int8
        # signs, int32 sampled rows < 2^31); every sketch reuses it as it is
        self.plan = (rademacher.to(self.device, torch.int8).contiguous(),
                     sampling.to(self.device, torch.int32).contiguous(), int(d))

    # ``complex_dtype`` switches the dimension formula to its complex
    # constants (a = 2) only: Omega (sign flips and Hadamard rows) stays
    # real, and complex data goes through it exactly
    _dim_kind = "srht"

    @classmethod
    def from_plan(cls, n, k, signs, sampling, sqrt_product=None, seed=0,
                  device=None, dtype=None) -> "SrhtEmbedding":
        """Embedding with a given plan: ``signs`` (n,) +-1 and ``sampling``
        (k,) rows of [0, 2^ceil(log2 n)) (e.g. the JAX package's
        ``ops.fwht._srht_plan``, for parity). ``n`` is the l2 dimension."""
        plan = (torch.as_tensor(np.array(signs)).to(torch.int8),
                torch.as_tensor(np.array(sampling)).to(torch.int64),
                ceil_log2(n))
        source = sqrt_product.source_dim if sqrt_product is not None else n
        return cls(k, source, seed, sqrt_product, device, dtype, plan=plan)

    @property
    def blocked_shape(self):
        """(B, R) of the blocked rows layout: B = ceil(n / R) blocks of
        R = 2^min(11, d) entries (``to_blocked``)."""
        n = self.l2_dim
        R = 1 << min(11, ceil_log2(n))
        return -(-n // R), R

    def to_blocked(self, X) -> torch.Tensor:
        """Columns (n, m) or (n,) -> zero-padded rows layout (m, B, R)."""
        X = self._in(X)
        if X.dim() == 1:
            X = X[:, None]
        n, m = X.shape
        B, R = self.blocked_shape
        out = X.new_zeros((m, B * R))
        out[:, :n] = X.T
        return out.reshape(m, B, R)

    def _onepass(self, x_cols: torch.Tensor, out_dtype=None) -> torch.Tensor:
        rademacher, sampling, _ = self.plan
        return srht_onepass(x_cols, self.range_dim, rademacher, sampling, out_dtype)

    def apply_random(self, X, out_dtype=None):
        """Sketch of X: (n,) -> (k,), (n, m) -> (k, m), blocked (m, B, R)
        with zero tail -> (k, m).

        ``out_dtype`` (default: X's dtype) is the result's dtype; the
        one-pass kernel writes it from its float32 sums, so bf16 input asked
        for float32 output is rounded once, on the way in. A real
        ``out_dtype`` on complex data promotes (never drops the imaginary
        part). The small-n FWHT computes in X's dtype, upcast first where
        ``out_dtype`` is wider."""
        X = self._in(X)
        if out_dtype is not None and X.is_complex():
            out_dtype = torch.promote_types(out_dtype, X.dtype)
        n = self.l2_dim
        if X.dim() == 3:
            m = X.shape[0]
            if tuple(X.shape[1:]) != self.blocked_shape:
                raise ValueError(f"blocked input {tuple(X.shape)} is not "
                                 f"(m, {self.blocked_shape})")
            B, R = self.blocked_shape
            # (m, B, R) -> (n, m) strided view: read in place by the kernel
            return self._onepass(X.reshape(m, B * R)[:, :n].T, out_dtype)
        single = X.dim() == 1
        Xm = X[:, None] if single else X
        if Xm.shape[0] != n:
            raise ValueError(f"input has {Xm.shape[0]} rows, embedding n={n}")
        if n >= self._ONEPASS_MIN_DIM:
            out = self._onepass(Xm, out_dtype)
        else:
            if out_dtype is not None and out_dtype.itemsize > Xm.dtype.itemsize:
                Xm = Xm.to(out_dtype)
            out = srht(Xm.T, self.range_dim, self.plan).T
            if out_dtype is not None:
                out = out.to(out_dtype)
        return out[:, 0] if single else out

    def random_matrix(self):
        return srht_rows(self.plan, self.l2_dim, self.range_dim,
                         dtype=torch.float64, device=self.device).to(self.dtype)


class HwPrngGaussianEmbedding(Embedding):
    """Gaussian (or Rademacher) embedding whose Omega is drawn inside the
    sketch kernel (``ops/gaussian_cuda.py``) and is never stored: it lives
    in registers, consumed by FMAs for narrow X (the small branch) or as
    each thread's tensor-core fragments for wider X (the tiled branch).

    Bitstream contract (``ops/philox.py``): the operator is determined by
    ``(seed, range_dim, block_rows, dist)``. Strip b (columns
    ``[b W, (b + 1) W)`` of Omega, W = ``block_rows``) is drawn by
    Philox4x32-10 under the key ``(seed mod 2^32, b)`` in the draw order of
    the JAX package's TPU kernel: Box-Muller pairs of 64-row draws for
    ``k % 128 == 0``, cos halves otherwise, sign bits for
    ``dist="rademacher"``. The same seed names another Omega than
    :class:`GaussianEmbedding`, and another than the JAX package's
    ``HwPrngGaussianEmbedding``, whose TPU hardware bits exist only on a
    TPU. Real only: the sketch and ``random_matrix`` are float32.
    """

    def __init__(self, range_dim, source_dim, seed=0, sqrt_product=None,
                 device=None, dtype=None, complex_dtype: bool = False,
                 block_rows: int = DEFAULT_BLOCK_ROWS, dist: str = "normal"):
        super().__init__(range_dim, source_dim, seed, sqrt_product, device, dtype,
                         complex_dtype)
        if self.dtype.is_complex or self.complex_dtype:
            raise TypeError("HwPrngGaussianEmbedding is real-only (the kernel "
                            "draws real float32 strips); use GaussianEmbedding "
                            "for complex data")
        self.block_rows = int(block_rows)
        self.dist = dist

    def _extra_fields(self):
        return {"block_rows": self.block_rows, "dist": self.dist}

    def apply_random(self, X):
        """Omega @ X in float32: (l2_dim,) -> (k,), (l2_dim, m) -> (k, m)."""
        return gaussian_sketch(self._in(X), self.range_dim, self.seed,
                               self.block_rows, self.dist)

    def random_matrix(self):
        """The (k, l2_dim) Omega: the strips side by side, cut to l2_dim and
        scaled by 1/sqrt(k) in float32 (one launch of the Omega kernel on
        the card), then held in the working dtype."""
        return gaussian_omega(self.range_dim, self.l2_dim, self.seed, self.block_rows,
                              self.dist, device=self.device).to(self.dtype)


class VectorizedEmbedding(LinOp):
    """Sketch of a whole (rows, cols) matrix: its C-order flattening (index
    ``i_row * cols + i_col``) through ``embedding``, whose source dimension
    is rows * cols."""

    def __init__(self, embedding: Embedding, rows: int, cols: int):
        if embedding.source_dim != rows * cols:
            raise ValueError(f"embedding acts on {embedding.source_dim} entries, "
                             f"not {rows} x {cols}")
        self.embedding = embedding
        self.rows, self.cols = int(rows), int(cols)
        self.source_dim = self.rows * self.cols
        self.range_dim = embedding.range_dim

    @property
    def seed(self) -> int:
        return self.embedding.seed

    def with_seed(self, seed) -> "VectorizedEmbedding":
        return VectorizedEmbedding(self.embedding.with_seed(seed), self.rows, self.cols)

    def with_range_dim(self, range_dim) -> "VectorizedEmbedding":
        return VectorizedEmbedding(self.embedding.with_range_dim(range_dim),
                                   self.rows, self.cols)

    def apply_matrix(self, M) -> torch.Tensor:
        """(k,) sketch of the (rows, cols) matrix M."""
        M = torch.as_tensor(M)
        if tuple(M.shape) != (self.rows, self.cols):
            raise ValueError(f"matrix {tuple(M.shape)} is not ({self.rows}, {self.cols})")
        return self.embedding.apply(M.reshape(-1))

    def apply(self, U, mu=None):
        return self.embedding.apply(U)

    def apply_adjoint(self, V, mu=None):
        return self.embedding.apply_adjoint(V)

    def matrix(self):
        return self.embedding.matrix()


# the reference's name
EmbeddingVectorized = VectorizedEmbedding
