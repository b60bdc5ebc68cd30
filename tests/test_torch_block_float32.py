"""A float32 sketched reductor fed a near-dependent block of snapshots,
held against the JAX package's float32 reductor (CPU).

``chip_smoke.py``'s ``[hwprng block]`` path sketches 12 random snapshots of
the thermal block in one block (the tiled Gaussian kernel on the card) into
a float32 reductor. Their sketch is conditioned at about 1.4e5, past
float32: the 12th orthogonalised direction is rounding noise. A reductor
that keeps it gives a ROM whose exact dual residual is up to hundreds of
times b's and whose estimate is a small fraction of it, in the JAX package
(x64 off, as on its TPU) as in the port. ``truncation_rtol`` drops that
column in both, at the JAX package's setting for a float32 offline stage,
about sqrt(eps) = 3.45e-4, and at the path's 1e-3 (at 512 intervals the
12th direction is 3.4e-4 of its column, on the edge of the first), and the
ROM passes the path's checks. Thermal block 2x2 at 32 intervals (n = 961),
snapshots solved once by the port's FOM in float64 and handed to both
packages as float32, Omega (k = 256, over the h1_0 sqrt factor) carried
from the JAX side.

Tolerances: the estimates and the exact residuals of the two packages
agree to 1e-3 of their largest (float32 reductions in other orders); the
path's checks are its own (outputs 5e-2, estimate / exact in [0.5, 2]).

Run as a script (``python tests/test_torch_block_float32.py --grid 128``)
it prints the readings at a given grid; ``--port-only`` leaves the JAX
package out and sketches with the path's own ``HwPrngGaussianEmbedding``
(seed 1), for grids where the JAX FOM is too large for the host.
"""

import argparse
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import rla4mor_tpu.ops.embeddings as jemb  # noqa: E402
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM  # noqa: E402
from rla4mor_tpu.mor import SketchedReductor as JaxReductor  # noqa: E402

import rla4mor_tpu_torch.ops.embeddings as temb  # noqa: E402
from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt  # noqa: E402
from rla4mor_tpu_torch.models import ThermalBlockFOM  # noqa: E402
from rla4mor_tpu_torch.mor import SketchedReductor  # noqa: E402

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

GRID, K, SNAPSHOTS = 32, 256, 12
RTOLS_F32 = (3e-4, 1e-3)  # the JAX package's float32 setting; the path's


def dual_residual(fom, u, mu) -> float:
    """||A(mu) u - b(mu)||_{R^-1}, float64 on the host."""
    r = fom.assemble_sparse(mu) @ u - fom.assemble_rhs(mu)
    return float(np.sqrt(max(r @ fom.h1_0_product.inv.apply_host(r), 0.0)))


def setup(grid: int, with_jax: bool = True) -> dict:
    """Both FOMs (the JAX one with x64 off), [hwprng block]'s snapshot
    parameters (seeds 4 and 5 of the parameter space, 6 each) solved by the
    port in float64, and the carried Omega (without JAX: the path's
    embedding)."""
    fom = ThermalBlockFOM((2, 2), grid, device="cpu")
    mus = [fom.parameter_space.sample_randomly(6, seed=s, device="cpu") for s in (4, 5)]
    U = torch.cat([fom.solve_many(m) for m in mus], dim=1).float()
    if not with_jax:
        te = temb.HwPrngGaussianEmbedding.make(
            fom.solution_dim, sqrt_product=fom.h1_0_product.sqrt, range_dim=K, seed=1,
            device="cpu", dtype=torch.float32)
        return {"fom": fom, "U": U, "te": te}
    with jax.enable_x64(False):
        jfom = JaxFOM((2, 2), grid)
        je = jemb.GaussianEmbedding.make(fom.solution_dim, sqrt_product=jfom.h1_0_product.sqrt,
                                         range_dim=K, seed=1)
        omega = np.asarray(je.random_matrix())
    te = temb.GaussianEmbedding.from_matrix(omega, sqrt_product=fom.h1_0_product.sqrt,
                                            device="cpu", dtype=torch.float32)
    return {"fom": fom, "jfom": jfom, "U": U, "je": je, "te": te}


def readings(s: dict, rtol: float) -> dict:
    """Both reductors, extended by the snapshots in one block, reduced; at
    4 held-out parameters each ROM's output error against the FOM, its
    estimate, the exact dual residual of its reconstruction and that
    residual over b's dual norm."""
    fom, U = s["fom"], s["U"]
    red = SketchedReductor(fom, embedding_primal=s["te"], product=fom.h1_0_product,
                           truncation_rtol=rtol, log_level=30)
    red.extend_basis_blocked(U, max_block_size=64)
    rom = red.reduce(seed=0)
    with_jax = "jfom" in s
    with jax.enable_x64(False):
        jred = None if not with_jax else JaxReductor(s["jfom"], embedding_primal=s["je"],
                           product=s["jfom"].h1_0_product, truncation_rtol=rtol, log_level=30)
        if with_jax:
            jred.extend_basis_blocked(jnp.asarray(U.numpy()), max_block_size=64)
            jrom = jred.reduce(seed=0)
    out_vec = fom.output_functional.stack[0, 0].double().numpy()
    held = fom.parameter_space.sample_randomly(4, seed=1, device="cpu")
    rows = {"port": [], "jax": []} if with_jax else {"port": []}
    b_dual = []
    for mu in held:
        b_dual.append(dual_residual(fom, np.zeros(fom.solution_dim), mu))
        s_fom = float(out_vec @ fom.solve_host(mu))
        y = rom.solve(mu)
        u = red.reconstruct(y).double().numpy()
        rows["port"].append((abs(float(rom.output(y, mu)[0]) - s_fom) / abs(s_fom),
                             float(rom.estimate_error(mu, y)), dual_residual(fom, u, mu)))
        if not with_jax:
            continue
        with jax.enable_x64(False):
            jmu = {"diffusion": jnp.asarray(mu["diffusion"].numpy(), jnp.float32)}
            jy = jrom.solve(jmu)
            s_rom = float(np.asarray(jrom.output(jy, jmu)).ravel()[0])
            est = float(jrom.estimate_error(jmu, jy))
            ju = np.asarray(jred.reconstruct(jy), np.float64)
        rows["jax"].append((abs(s_rom - s_fom) / abs(s_fom), est, dual_residual(fom, ju, mu)))
    out = {"basis": {"port": red.basis_size}}
    if with_jax:
        out["basis"]["jax"] = int(jred.rb.shape[1])
    for side, r in rows.items():
        r = np.array(r)
        out[side] = {"out_rel_err": r[:, 0], "estimate": r[:, 1], "exact": r[:, 2],
                     "est_over_true": r[:, 1] / r[:, 2], "exact_over_b": r[:, 2] / b_dual}
    su = s["te"].apply(U)
    sv = torch.linalg.svdvals(su.double())
    out["cond"] = float(sv[0] / sv[-1])
    # each column's orthogonalised sketch over its norm: what truncation_rtol cuts
    R = gram_schmidt(su, return_R=True)[1]
    out["ratios"] = (R.diagonal().abs() / torch.linalg.vector_norm(R, dim=0)).tolist()
    return out


@pytest.fixture(scope="module")
def block():
    return setup(GRID)


@pytest.mark.parametrize("rtol", RTOLS_F32)
def test_float32_block_truncated_like_jax(block, rtol):
    """Both packages drop the same near-dependent column, agree with each
    other, and the ROM passes the path's checks."""
    r = readings(block, rtol)
    assert r["cond"] > 1e5
    assert r["basis"]["port"] == r["basis"]["jax"] == SNAPSHOTS - 1
    for key in ("estimate", "exact"):
        p, j = r["port"][key], r["jax"][key]
        assert np.abs(p - j).max() <= 1e-3 * np.abs(j).max()
    for side in ("port", "jax"):
        assert r[side]["out_rel_err"].max() <= 5e-2
        assert np.all((r[side]["est_over_true"] >= 0.5) & (r[side]["est_over_true"] <= 2.0))


def test_float32_block_kept_whole_fails_in_both(block):
    """truncation_rtol = 0 keeps every column: in the JAX package as in the
    port the estimate is then far below the exact residual (the cause the
    path's setting answers)."""
    r = readings(block, 0.0)
    assert r["basis"]["port"] == r["basis"]["jax"] == SNAPSHOTS
    for side in ("port", "jax"):
        assert np.all(r[side]["est_over_true"] < 0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--port-only", action="store_true")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    s = setup(args.grid, with_jax=not args.port_only)
    for rtol in (0.0, *RTOLS_F32):
        r = readings(s, rtol)
        print(f"grid={args.grid} n={s['fom'].solution_dim} cond={r['cond']:.3e} "
              f"truncation_rtol={rtol} basis={r['basis']} "
              f"ratios={[f'{v:.2e}' for v in r['ratios']]}")
        for side in r["basis"]:
            print(f"  {side}: out_rel_err_max={r[side]['out_rel_err'].max():.3e} "
                  f"est_over_true={np.round(r[side]['est_over_true'], 4).tolist()} "
                  f"exact_over_b={[f'{v:.3e}' for v in r[side]['exact_over_b']]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
