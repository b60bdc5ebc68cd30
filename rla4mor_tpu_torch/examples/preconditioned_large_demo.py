"""Sketched preconditioner selection on the matrix-free thermal block, one device.

The port's counterpart of ``examples/preconditioned_large_demo.py``: the
sketched-HS preconditioner selector of ``precond/`` driven end to end on
``StencilThermalBlock((2, 2), 1024)``, n = 1,050,625 DoF:

* ``nrb`` MG-CG snapshots, orthonormalised into the reduced basis U;
* the ``ur_ur`` key: Gaussian Sigma and Omega of range 2r, and a
  ``VectorizedEmbedding`` with an inner Gaussian of range 4r;
* an SRHT residual embedding of range ``k_res`` (its rows, built once by
  ``source_array``);
* ``ndir`` directions P_i = A(mu_i)^-1 as ``RecycledCGInverseOp``
  (deflated, warm-started MG-CG, tol 1e-7, maxiter 300) on the interior
  (:class:`InteriorInverse`): no factorisation ever touches the operator;
* the online stage ``PreconditionedReductor.solve_batch`` over ``nmu``
  parameters (HS estimator, least-squares selection and ROM solve, each
  one batched call), beside a per-parameter loop.

It uses the port's V-cycle, whose coarse right-hand side is P^T r (the JAX
package's P^T r / 4 is not mesh-independent: ROADMAP.md queue 3).

    python -m rla4mor_tpu_torch.examples.preconditioned_large_demo
    python -m rla4mor_tpu_torch.examples.preconditioned_large_demo --cpu --grid 64
"""

from __future__ import annotations

import argparse
import time

import torch

from rla4mor_tpu_torch.core.linops import LinOp


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device: torch.device) -> float:
    """Time of one call of ``fn`` in ms: CUDA events on a card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def make_embeddings(r: int, n: int, k_res: int, device, dtype=None) -> dict:
    """The demo's seeded embeddings: Sigma and Omega (Gaussian, range 2r),
    Gamma (a VectorizedEmbedding of the (2r, 2r) matrices, inner Gaussian of
    range 4r) and the SRHT residual embedding of range ``k_res``."""
    from rla4mor_tpu_torch.ops import GaussianEmbedding, SrhtEmbedding, VectorizedEmbedding

    kw = dict(device=device, dtype=dtype)
    return {
        "sigma": GaussianEmbedding.make(r, range_dim=2 * r, seed=10, **kw),
        "omega": GaussianEmbedding.make(r, range_dim=2 * r, seed=11, **kw),
        "vec": VectorizedEmbedding(
            GaussianEmbedding.make(4 * r * r, range_dim=4 * r, seed=12, **kw),
            rows=2 * r, cols=2 * r),
        "residual": SrhtEmbedding.make(n, range_dim=k_res, seed=13, **kw),
    }


class InteriorInverse(LinOp):
    """A direction A(mu)^-1 of the masked stencil, applied to the interior
    part of its input: ``inverse`` (the CG) gets the input with the
    Dirichlet ring zeroed. The stencil is zero on the ring, in and out, so a
    right-hand side with ring entries has no solution, and CG on it fails
    (on the CPU at grid 64 MG-CG reached NaN after 97 iterations). The
    residual rows of the embedding and the Gaussian Omega have ring entries.
    This is the pseudo-inverse (zero on the ring), self-adjoint as the
    inverse is. ``solves`` and ``last_iters`` are the CG's."""

    def __init__(self, inverse: LinOp, mask: torch.Tensor):
        self.inverse = inverse
        self.mask = mask.reshape(-1)
        self.source_dim = self.range_dim = inverse.source_dim

    @property
    def solves(self) -> int:
        return self.inverse.solves

    @property
    def last_iters(self) -> int:
        return self.inverse.last_iters

    def apply(self, U, mu=None):
        U = torch.as_tensor(U).to(self.mask)
        return self.inverse.apply(U * (self.mask if U.dim() == 1 else self.mask[:, None]))

    apply_adjoint = apply


def direction(st, mu, precond: str = "mg", m_max: int = 16) -> InteriorInverse:
    """P = A(mu)^-1 on the interior: a ``RecycledCGInverseOp`` on flattened
    grids, the stencil at mu preconditioned by the V-cycle of its
    coefficients (``"mg"``) or by its diagonal (``"jacobi"``), tol 1e-7,
    maxiter 300."""
    from rla4mor_tpu_torch.core import RecycledCGInverseOp
    from rla4mor_tpu_torch.models.stencil import interior_mask

    shape = st.solution_shape
    if precond == "mg":
        from rla4mor_tpu_torch.models.multigrid import make_vcycle

        cycle = make_vcycle(st.kappa(mu))

        def M(r):
            return cycle(r.reshape(shape)).reshape(-1)
    elif precond == "jacobi":
        diag = st.jacobi_diag(mu).reshape(-1)

        def M(r):
            return r / diag
    else:
        raise ValueError(f"unknown precond {precond!r}")
    cg_op = RecycledCGInverseOp(
        lambda v: st.apply(mu, v.reshape(shape)).reshape(-1), st.n_nodes ** 2,
        precond=M, tol=1e-7, maxiter=300, m_max=m_max, dtype=st.dtype, device=st.device)
    return InteriorInverse(cg_op, interior_mask(st.n_nodes, st.dtype, st.device))


def run(grid: int = 1024, nrb: int = 5, ndir: int = 3, nmu: int = 64, k_res: int = 200,
        device=None, dtype=None, precond: str = "mg", embeddings=None, mus=None,
        log=print) -> dict:
    """Build the FOM, the reduced basis and the reductor, add ``ndir``
    directions, run the online stage over ``nmu`` parameters (and a loop
    over 8 of them), and compare 3 of its ROM solutions with MG-CG; returns
    what was built and measured.

    ``embeddings`` (keys of :func:`make_embeddings`) and ``mus`` (keys
    ``"rb"``, ``"dir"``, ``"online"``: lists of Mu) replace the seeded ones
    (the parity tests carry the JAX package's). ``precond`` preconditions
    the snapshot solves, the directions and the truth solves alike."""
    from rla4mor_tpu_torch.core import (
        ONE,
        AffineOp,
        DenseOp,
        ParameterSpace,
        gram_schmidt,
        mu_stack,
    )
    from rla4mor_tpu_torch.models.stationary import StationaryFOM
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
    from rla4mor_tpu_torch.precond import PreconditionedReductor
    from rla4mor_tpu_torch.utils.config import resolve_device

    device = resolve_device(device)
    st = StencilThermalBlock((2, 2), grid, dtype=dtype, device=device)
    n = st.n_nodes ** 2
    space = ParameterSpace.make({"diffusion": st.n_terms}, 0.1, 1.0)
    fom = StationaryFOM(
        st.affine_operator(),
        AffineOp((DenseOp(st.rhs().reshape(-1, 1), device=device, dtype=st.dtype),), (ONE,)),
        parameter_space=space, device=device)
    log(f"device={device} grid {st.n_nodes}x{st.n_nodes}: n = {n} DoF, {st.dtype}, "
        f"precond {precond}")
    mus = dict(mus or {})
    for name, count, seed in (("rb", nrb, 0), ("dir", ndir, 1), ("online", nmu, 2)):
        if name not in mus:
            mus[name] = space.sample_randomly(count, seed=seed, device=device,
                                              dtype=st.dtype)

    def solve_fom(mu):
        return st.solve_cg_result(mu, tol=1e-7, maxiter=400, precond=precond).x.reshape(-1)

    out = {"st": st, "fom": fom, "n": n, "space": space, "mus": mus}
    _sync(device)
    t0 = time.perf_counter()
    U = gram_schmidt(torch.stack([solve_fom(m) for m in mus["rb"]], dim=1))
    _sync(device)
    out["snapshot_s"] = time.perf_counter() - t0
    r = U.shape[1]
    log(f"{r} MG-CG snapshots + Gram-Schmidt: {out['snapshot_s']:.3f} s")

    emb = make_embeddings(r, n, k_res, device, st.dtype)
    emb.update(embeddings or {})
    t0 = time.perf_counter()
    red = PreconditionedReductor(
        fom=fom, reduced_basis=U,
        source_bases={"ur_ur": U}, range_bases={"ur_ur": U},
        source_embeddings={"ur_ur": emb["sigma"]},
        range_embeddings={"ur_ur": emb["omega"]},
        vec_embeddings={"ur_ur": emb["vec"]},
        residual_embedding=emb["residual"], stable_galerkin=True, log_level=30)
    _sync(device)
    out["reductor_s"] = time.perf_counter() - t0
    log(f"reductor (residual rows {tuple(red.prom._res_cols.shape)}): "
        f"{out['reductor_s']:.3f} s")
    out.update(U=U, reductor=red, embeddings=emb, directions=[], add_s=[])

    for i, mu_i in enumerate(mus["dir"]):
        P = direction(st, mu_i, precond)
        t0 = time.perf_counter()
        red.add_preconditioner(P, mu_i)
        _sync(device)
        out["add_s"].append(time.perf_counter() - t0)
        out["directions"].append(P)
        log(f"direction {i}: added in {out['add_s'][-1]:.3f} s, {P.solves} RecycledCG "
            f"solves, last solve {P.last_iters} iterations")

    batch = mu_stack(mus["online"])
    red.solve_batch(batch, "ur_ur")  # warm-up
    us, ys, rnorms = red.solve_batch(batch, "ur_ur")
    out.update(us=us, ys=ys, rnorms=rnorms)
    out["batch_ms"] = timed_ms(lambda: red.solve_batch(batch, "ur_ur"), device)
    loop = mus["online"][:8]
    out["loop_ms"] = timed_ms(lambda: [red.solve(m, "ur_ur") for m in loop], device)
    log(f"online stage over {len(mus['online'])} parameters: batched "
        f"{out['batch_ms']:.4f} ms; per-parameter loop over {len(loop)}: "
        f"{out['loop_ms']:.4f} ms ({out['loop_ms'] / max(1, len(loop)):.4f} ms each)")

    out["errors"] = []
    for m, u_r in zip(mus["online"][:3], us[:3]):
        u_true = solve_fom(m)
        u_rom = U @ u_r.to(U)
        out["errors"].append(float(torch.linalg.vector_norm(u_rom - u_true)
                                   / torch.linalg.vector_norm(u_true)))
    log("relative ROM errors against MG-CG: "
        + " ".join(f"{e:.4e}" for e in out["errors"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64)")
    ap.add_argument("--grid", type=int, default=1024,
                    help="num_intervals (a power of two for multigrid)")
    ap.add_argument("--nrb", type=int, default=5)
    ap.add_argument("--ndir", type=int, default=3)
    ap.add_argument("--nmu", type=int, default=64)
    ap.add_argument("--k-res", type=int, default=200)
    ap.add_argument("--precond", choices=["mg", "jacobi"], default="mg")
    args = ap.parse_args(argv)
    run(args.grid, args.nrb, args.ndir, args.nmu, args.k_res,
        device="cpu" if args.cpu else None, precond=args.precond)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
