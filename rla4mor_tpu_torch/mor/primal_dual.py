"""Primal-dual sketched RB: dual-corrected outputs and an output indicator.

Counterpart of ``rla4mor_tpu/mor/primal_dual.py``. For a single-output FOM
s(mu) = c(mu) u(mu) the dual problem is A(mu)^H z = c(mu)^H, and the
dual-weighted residual correction

    s_c(mu) = c u_r + z_r^H (b(mu) - A(mu) u_r)

has s - s_c = (z - z_r)^H A (u - u_r): a product of the two errors. Both are
estimated by the sketched residuals, giving the indicator
eta_s = eta_pr eta_du. Online everything is dense-affine (the projections
Z^H b and Z^H A V), so :class:`CorrectedOutputROM` evaluates one Mu or a
batched one, like the stationary ROM.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch

from rla4mor_tpu_torch.core.affine import AffineOp, as_affine, project
from rla4mor_tpu_torch.core.linops import HostSparseOp, to_numpy
from rla4mor_tpu_torch.core.parameters import Mu, conj_coefficient, mu_stack
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.stationary import StationaryFOM, StationaryROM
from rla4mor_tpu_torch.mor.sketched_reductor import SketchedReductor
from rla4mor_tpu_torch.ops.embeddings import Embedding
from rla4mor_tpu_torch.utils.logger import get_logger


def dual_fom(fom: StationaryFOM) -> StationaryFOM:
    """The dual problem A(mu)^H z = c(mu)^H as a :class:`StationaryFOM`:
    the host sparse terms conjugate-transposed, the coefficients
    conjugated, the rhs c(mu)^H."""
    of = as_affine(fom.output_functional)
    if of.range_dim != 1:
        raise ValueError("dual correction supports single outputs")
    op = as_affine(fom.operator)
    terms = []
    for t in op.terms:
        S = getattr(t, "S", None)
        if S is None:
            raise TypeError("dual_fom needs host-sparse operator terms (HostSparseOp)")
        terms.append(HostSparseOp(sps.csr_matrix(S.conj().T), device=fom.device,
                                  dtype=fom.dtype))
    dual_op = AffineOp(tuple(terms), tuple(conj_coefficient(c) for c in op.coefficients))
    return StationaryFOM(operator=dual_op, rhs=of.H, products=fom.products,
                         parameter_space=fom.parameter_space, name=fom.name + "_dual",
                         device=fom.device, dtype=fom.dtype)


class CorrectedOutputROM:
    """Primal ROM, dual ROM and the offline correction projections."""

    def __init__(self, rom_pr: StationaryROM, rom_du: StationaryROM, rhs_z, op_zv):
        self.rom_pr = rom_pr
        self.rom_du = rom_du
        self.rhs_z = rhs_z    # (T_b, r_z, 1) AffineDense: Z^H b
        self.op_zv = op_zv    # (T, r_z, r_v) AffineDense: Z^H A V

    def output_plain(self, mu: Mu) -> torch.Tensor:
        return self.rom_pr.output(self.rom_pr.solve(mu), mu)[..., 0]

    def output_corrected(self, mu: Mu):
        """(s_c, eta_s): the dual-corrected output and the residual-product
        indicator; () each for one Mu, (B,) for a batch."""
        u_r = self.rom_pr.solve(mu)
        z_r = self.rom_du.solve(mu)
        s = self.rom_pr.output(u_r, mu)[..., 0]
        res = self.rhs_z.assemble_vec(mu) - self.op_zv.apply(u_r, mu)
        dt = torch.promote_types(z_r.dtype, res.dtype)
        corr = (z_r.to(dt).conj() * res.to(dt)).sum(dim=-1)
        eta_pr = self.rom_pr.error_estimator.estimate_error(u_r, mu)
        eta_du = self.rom_du.error_estimator.estimate_error(z_r, mu)
        return s + corr, eta_pr * eta_du


class PrimalDualReductor:
    """Two sketched reductors (primal on (A, b), dual on (A^H, c^H)) and the
    corrected-output ROM. ``extend(mu)`` solves both problems at mu and
    extends both bases; ``extend_primal`` / ``extend_dual`` take given
    solutions. Without ``embedding_dual`` the dual embedding is the primal
    one at seed + 77."""

    def __init__(self, fom: StationaryFOM, embedding_primal: Embedding,
                 embedding_dual: Optional[Embedding] = None,
                 embedding_online: Optional[Embedding] = None,
                 product: Optional[Product] = None, log_level: int = 20):
        self.fom = fom
        self.fom_dual = dual_fom(fom)
        self.primal = SketchedReductor(fom, embedding_primal=embedding_primal,
                                       embedding_online=embedding_online, product=product,
                                       orthonormalize=True, log_level=log_level)
        emb_du = (embedding_dual if embedding_dual is not None
                  else embedding_primal.with_seed(embedding_primal.seed + 77))
        self.dual = SketchedReductor(self.fom_dual, embedding_primal=emb_du,
                                     embedding_online=embedding_online, product=product,
                                     orthonormalize=True, log_level=log_level)
        self.logger = get_logger("mor.primal_dual", log_level)

    def extend(self, mu: Mu) -> None:
        self.primal.extend_basis(self.fom.solve(mu), mu=mu)
        self.dual.extend_basis(self.fom_dual.solve(mu), mu=mu)

    def extend_primal(self, U, mu=None) -> None:
        self.primal.extend_basis(U, mu=mu)

    def extend_dual(self, Z, mu=None) -> None:
        self.dual.extend_basis(Z, mu=mu)

    def reduce(self, seed=None) -> CorrectedOutputROM:
        rom_pr = self.primal.reduce(seed=seed)
        rom_du = self.dual.reduce(seed=None if seed is None else seed + 1000)
        Z, V = self.dual.rb, self.primal.rb
        return CorrectedOutputROM(rom_pr, rom_du, project(self.fom.rhs, Z, None),
                                  project(self.fom.operator, Z, V))


def output_greedy(fom: StationaryFOM, reductor: PrimalDualReductor, training_set,
                  max_extensions: int = 10, atol: float = 0.0, rtol: float = 0.0,
                  online_seed: int = 0, log_level: int = 20):
    """Goal-oriented greedy: extend the primal and dual bases at the worst
    output indicator eta_s = eta_pr eta_du (one batched evaluation over the
    training set a sweep). Returns ``(rom, history)``."""
    logger = get_logger("mor.output_greedy", log_level)
    history = {"selected_mus": [], "max_indicators": []}
    mus_batched = mu_stack(list(training_set))

    mu0 = training_set[0]
    reductor.extend(mu0)
    history["selected_mus"].append(mu0)
    first_max = None
    rom = reductor.reduce(seed=online_seed)
    for it in range(1, max_extensions):
        etas = to_numpy(rom.output_corrected(mus_batched)[1])
        imax = int(np.argmax(etas))
        emax = float(etas[imax])
        history["max_indicators"].append(emax)
        if first_max is None:
            first_max = emax
        logger.info("output-greedy it=%d basis=%d max_eta_s=%.3e", it,
                    reductor.primal.basis_size, emax)
        if emax <= atol or (rtol and emax <= rtol * first_max):
            break
        mu = training_set[imax]
        reductor.extend(mu)
        history["selected_mus"].append(mu)
        rom = reductor.reduce(seed=online_seed + it)
    return rom, history
