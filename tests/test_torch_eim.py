"""EIM, DEIM and MDEIM (``mor/eim.py``), the host bump family
(``models/bump_host.py``) and the EIM / MDEIM files held against the JAX
package (f64, CPU).

The greedies select by argmax: where two candidates tie to the last bit
(mirrored entries of a symmetric family), the pick follows rounding. The
port's residual update rounds the product before subtracting, as the JAX
package's eager update does, so on the same data both select the same
points and snapshots; the bump field itself differs from XLA's in the last
bit of some entries (another ``exp``), so the MDEIM parity runs on the JAX
package's field, carried into the port's fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from rla4mor_tpu.core.parameters import ParameterSpace as JaxSpace
from rla4mor_tpu.models import bump_host as jbump
from rla4mor_tpu.models.stencil_nonaffine import gaussian_bump_field as jax_bump_field
from rla4mor_tpu.mor import eim as jeim
from rla4mor_tpu.mor import serialization as jser

from rla4mor_tpu_torch.models import bump_host as tbump
from rla4mor_tpu_torch.mor import eim as teim
from rla4mor_tpu_torch.mor import serialization as tser

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def low_rank_plus_noise(n=300, m=30, rank=6, noise=1e-2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, rank)) @ rng.standard_normal((rank, m))
            + noise * rng.standard_normal((n, m)))


def bump_snapshots(n=400, m=60, seed=2):
    """1-d Gaussian-bump fields on [0, 1] (``tests/test_eim.py``'s family)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, n)
    cols = []
    for _ in range(m):
        c, w = rng.uniform(0.25, 0.75), rng.uniform(0.08, 0.25)
        cols.append(1.0 + 9.0 * np.exp(-((x - c) ** 2) / (2 * w * w)))
    return np.stack(cols, axis=1)


def assert_interpolants_equal(t, j, tol=1e-12):
    assert (t.n_terms, t.n_reserve) == (j.n_terms, j.n_reserve)
    assert t.snapshot_ids == tuple(j.snapshot_ids)
    assert t.triangular == j.triangular
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    assert rel(t.basis, j.basis) < tol
    assert rel(t.interp_matrix, j.interp_matrix) < tol
    assert rel(t.sup_errors, np.asarray(j.sup_errors)) < tol


GREEDY_CASES = [dict(tol=1e-8), dict(tol=0.05, reserve=4), dict(max_terms=10, reserve=2),
                dict(tol=1e-3, relative=False), dict(tol=10.0, reserve=3)]


@pytest.mark.parametrize("kw", GREEDY_CASES, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_eim_greedy_matches_jax(kw):
    """The host loop on a low-rank-plus-noise G (300 x 30): the same points,
    snapshots, active / reserve split, and basis and history to 1e-12; with
    the stopping tol, reserve, max_terms, an absolute tol and the tol met
    before any term (all reserve)."""
    G = low_rank_plus_noise()
    t = teim.eim_greedy(torch.tensor(G), **kw)
    assert_interpolants_equal(t, jeim.eim_greedy(jnp.asarray(G), **kw))


def test_eim_greedy_zero_field():
    """An all-zero training set: one arbitrary point and a zero basis, as in
    the JAX package, from the host loop and the device greedy alike."""
    G = np.zeros((50, 7))
    j = jeim.eim_greedy(jnp.asarray(G), reserve=2)
    for t in (teim.eim_greedy(torch.tensor(G), reserve=2),
              teim.eim_greedy_device(torch.tensor(G), reserve=2)):
        assert_interpolants_equal(t, j)
    G[3, 2] = 2.0  # rank one: the reserve steps find an exactly-zero residual
    j = jeim.eim_greedy(jnp.asarray(G), tol=1e-12, reserve=2)
    assert_interpolants_equal(teim.eim_greedy(torch.tensor(G), tol=1e-12, reserve=2), j)
    assert_interpolants_equal(teim.eim_greedy_device(torch.tensor(G), tol=1e-12, reserve=2), j)


@pytest.mark.parametrize("kw", [dict(tol=1e-6, reserve=3), dict(tol=1e-12, max_terms=12)])
def test_eim_greedy_device_matches_host(kw):
    """The device greedy (argmax indices kept on the device, one host read
    a chunk) equals the host loop bit for bit at chunks 1, 5 and 512, and
    the JAX package's ``eim_greedy_device`` at chunk 5."""
    G = torch.tensor(bump_snapshots())
    host = teim.eim_greedy(G, **kw)
    for chunk in (1, 5, 512):
        dev = teim.eim_greedy_device(G, chunk=chunk, **kw)
        assert dev.snapshot_ids == host.snapshot_ids
        assert torch.equal(dev.points, host.points) and torch.equal(dev.basis, host.basis)
        assert dev.sup_errors == host.sup_errors and dev.n_reserve == host.n_reserve
    # the JAX device greedy is one compiled scan, whose fused arithmetic
    # rounds unlike its eager host loop: the late basis columns (residuals
    # normalised from 1e-6 of the field) drift, so the interpolants'
    # action is compared, as tests/test_eim.py does
    t = teim.eim_greedy_device(G, chunk=5, **kw)
    j = jeim.eim_greedy_device(jnp.asarray(G.numpy()), chunk=5, **kw)
    assert t.snapshot_ids == tuple(j.snapshot_ids) and t.n_reserve == j.n_reserve
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    H = bump_snapshots(m=25, seed=5)
    assert rel(t.interpolate(torch.tensor(H)), j.interpolate(jnp.asarray(H))) < 1e-8
    assert rel(t.sup_errors, np.asarray(j.sup_errors)) < 1e-7


def test_eim_greedy_scan_continues_from_its_carry():
    """8 scan steps, then 4 more from the returned residuals, pick the host
    loop's 12 points; the scan's outputs equal the JAX scan's; the
    caller's G is left as it was unless ``inplace``."""
    G = torch.tensor(bump_snapshots())
    G0 = G.clone()
    B, pts, ids, sups, R = teim.eim_greedy_scan(G, 8)
    assert torch.equal(G, G0) and B.shape == (G.shape[0], 8)
    B2, pts2, *_ = teim.eim_greedy_scan(R, 4)
    ref = teim.eim_greedy(G, tol=0.0, max_terms=12)
    assert torch.equal(torch.cat([pts, pts2]), ref.points)
    jB, jpts, jids, jsups, jR = jeim.eim_greedy_scan(jnp.asarray(G.numpy()), 8)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert rel(B, jB) < 1e-12 and rel(sups, jsups) < 1e-12 and rel(R, jR) < 1e-12
    teim.eim_greedy_scan(G, 2, inplace=True)
    assert not torch.equal(G, G0)


def test_eim_rebuild_matches_jax():
    """The rebuild from a prescribed snapshot sequence equals the JAX
    package's, and on the greedy's own sequence reproduces the greedy."""
    G = bump_snapshots()
    ref = teim.eim_greedy(torch.tensor(G), tol=1e-6, reserve=3)
    G_sel = G[:, list(ref.snapshot_ids)]
    t = teim.eim_rebuild(torch.tensor(G_sel), n_reserve=3)
    assert_interpolants_equal(t, jeim.eim_rebuild(jnp.asarray(G_sel), n_reserve=3))
    assert torch.equal(t.points, ref.points) and rel(t.basis, ref.basis) < 1e-12
    with pytest.raises(ValueError, match="exactly interpolated"):
        teim.eim_rebuild(torch.tensor(np.concatenate([G_sel[:, :2], 0 * G_sel[:, :1]], axis=1)))


def test_interpolant_methods_match_jax():
    """``coefficients`` (one field and columns), ``error_indicator``,
    ``interpolate``, ``reconstruct`` and ``truncate`` on held-out fields,
    to 1e-12; ``to`` keeps points and basis; the indicator is a lower bound
    on the true sup error."""
    G, H = bump_snapshots(), bump_snapshots(m=12, seed=77)
    j = jeim.eim_greedy(jnp.asarray(G), tol=1e-6, reserve=4)
    t = teim.eim_greedy(torch.tensor(G), tol=1e-6, reserve=4)
    tp, jp = t.points.numpy(), np.asarray(j.points)
    M = t.n_terms
    assert rel(t.coefficients(torch.tensor(H[tp[:M], 0])), j.coefficients(H[jp[:M], 0])) < 1e-12
    assert rel(t.coefficients(torch.tensor(H[tp[:M]])), j.coefficients(H[jp[:M]])) < 1e-12
    ind = t.error_indicator(torch.tensor(H[tp]))
    assert rel(ind, j.error_indicator(jnp.asarray(H[jp]))) < 1e-9  # a difference of O(1) values
    assert rel(t.interpolate(torch.tensor(H)), j.interpolate(jnp.asarray(H))) < 1e-12
    theta = torch.tensor(np.random.RandomState(1).standard_normal(M))
    assert rel(t.reconstruct(theta), j.reconstruct(jnp.asarray(theta.numpy()))) < 1e-12
    assert_interpolants_equal(t.truncate(M - 3, 2), j.truncate(M - 3, 2))
    true_sup = (t.interpolate(torch.tensor(H)) - torch.tensor(H)).abs().amax(dim=0)
    assert torch.all(ind <= true_sup * (1 + 1e-10))
    t32 = t.to(dtype=torch.float32)
    assert torch.equal(t32.points, t.points) and t32.basis.dtype == torch.float32
    with pytest.raises(ValueError, match="reserve"):
        t.truncate(M).error_indicator(torch.tensor(H[tp[:M], 0]))


def test_deim_matches_jax():
    """``deim_points`` on a seeded orthonormal basis, and ``deim`` with its
    default POD cut: the same points, and the POD
    singular values and interpolation to 1e-8. The POD is each package's
    ``eigh`` of the snapshots' Gram matrix (the method of snapshots), whose
    trailing modes agree only to about eps s_0^2 / s_q^2; the basis signs
    are ``eigh``'s too, so the coefficients are compared through
    ``interpolate``."""
    U = np.linalg.qr(np.random.default_rng(5).standard_normal((80, 3)))[0]
    np.testing.assert_array_equal(teim.deim_points(torch.tensor(U)).numpy(),
                                  np.asarray(jeim.deim_points(jnp.asarray(U))))
    # rank 3 under noise 1e-9: the default cut (1e-7 s_0) keeps the 3 modes
    G = low_rank_plus_noise(n=80, m=20, rank=3, noise=1e-9, seed=1)
    H = low_rank_plus_noise(n=80, m=4, rank=3, noise=0.0, seed=1)
    t, j = teim.deim(torch.tensor(G)), jeim.deim(jnp.asarray(G))
    assert not t.triangular and t.n_terms == j.n_terms == 3
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    assert rel(t.sup_errors, np.asarray(j.sup_errors)) < 1e-8
    assert rel(t.interpolate(torch.tensor(H)), j.interpolate(jnp.asarray(H))) < 1e-8
    assert teim.deim(torch.tensor(G), modes=5).n_terms == 5  # a count turns the cut off


def test_theta_coefficients_share_one_solve():
    """The coefficients of one Mu share one solve (a batched Mu gives one
    row each), and equal the interpolant's coefficients."""
    G = torch.tensor(bump_snapshots())
    t = teim.eim_greedy(G, tol=1e-6)
    calls = []

    def entries(mu):
        calls.append(1)
        return mu["g"]

    coeffs = teim.theta_coefficients(t, entries)
    g = G[t.active_points, :3].T.contiguous()  # (3, M) batch
    batched = {"g": g}
    vals = torch.stack([c(batched) for c in coeffs], dim=-1)
    assert len(calls) == 1 and vals.shape == (3, t.n_terms)
    assert rel(vals, t.coefficients(g.mT).mT) < 1e-14
    one = {"g": g[1]}
    assert rel(torch.stack([c(one) for c in coeffs]), vals[1]) < 1e-12 and len(calls) == 2


# -- MDEIM and the host bump family ------------------------------------------

NX = 8


@pytest.fixture(scope="module")
def bump_pair():
    """The JAX package's ``bump_host_fom(nx=8)`` and the port's on the same
    field values and training draws (the JAX package's field and random
    bumps carried into the port's fit in place of its own): the 4^3 grid
    and 20 random bumps, 84 snapshots of the 64-dimensional family (the
    JAX fit assembles each with an eager field, 10-15 ms)."""
    jfom = jbump.bump_host_fom(nx=NX, n_train_per_dim=4, n_train_random=20)
    draws = JaxSpace.make({"bump": 3}).sample_randomly(20, key=tbump.TRAIN_SEED)
    field = jax_bump_field()

    def carried(mu, X, Y):  # one row of a batched Mu at a time
        b = np.asarray(mu["bump"])
        rows = [field({"bump": jnp.asarray(r)}, jnp.asarray(X.numpy()), jnp.asarray(Y.numpy()))
                for r in b.reshape(-1, 3)]
        return torch.tensor(np.stack(rows).reshape(b.shape[:-1] + tuple(X.shape)))

    def jax_draws(space, count, seed=0, device=None, dtype=None):
        assert (count, seed) == (20, tbump.TRAIN_SEED)
        return [{"bump": torch.tensor(np.asarray(m["bump"]))} for m in draws]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbump, "gaussian_bump_field", lambda **kw: carried)
        mp.setattr(tbump.ParameterSpace, "sample_randomly", jax_draws)
        tfom = tbump.bump_host_fom(nx=NX, n_train_per_dim=4, n_train_random=20, device="cpu")
    return jfom, tfom, draws


def _mu_pair(row):
    return {"bump": jnp.asarray(row)}, {"bump": torch.tensor(row)}


def test_bump_host_fom_matches_jax(bump_pair):
    """n_terms, points and magic positions equal; each term matrix, theta,
    indicator and the assembled surrogate at held-out parameters to 1e-12;
    the FOM's solve to 1e-10; ``bump_coercivity`` equal, one parameter and a
    batch."""
    jfom, tfom, _ = bump_pair
    jo, to = jfom.mdeim_op, tfom.mdeim_op
    assert to.n_terms == jo.n_terms and to.interpolant.n_reserve == jo.interpolant.n_reserve
    np.testing.assert_array_equal(to.interpolant.points.numpy(), np.asarray(jo.interpolant.points))
    np.testing.assert_array_equal(to.magic_rows, jo.magic_rows)
    np.testing.assert_array_equal(to.magic_cols, jo.magic_cols)
    for q in (0, to.n_terms // 2, to.n_terms - 1):
        assert abs(to.term_matrix(q) - jo.term_matrix(q)).max() < 1e-12
    rows = np.random.RandomState(4).uniform(0, 1, (3, 3))
    for row in rows:
        jmu, tmu = _mu_pair(row)
        A = jfom.exact_assemble(jmu)
        assert abs(tfom.exact_assemble(tmu) - A).max() == 0.0
        th = to.theta_from_matrix(A)
        assert rel(th, jo.theta_from_matrix(A)) < 1e-12
        assert abs(to.indicator_from_matrix(A) - jo.indicator_from_matrix(A)) < 1e-12
        assert abs(to.assemble(th) - jo.assemble(jo.theta_from_matrix(A))).max() < 1e-12
        assert rel(tfom.solve(tmu), jfom.solve(jmu)) < 1e-10
        assert rel(tbump.bump_coercivity(tfom)(tmu), jbump.bump_coercivity(jfom)(jmu)) < 1e-14
    batch = {"bump": torch.tensor(rows)}
    alpha = tbump.bump_coercivity(tfom)(batch)
    assert alpha.shape == (3,)
    assert rel(alpha, [float(jbump.bump_coercivity(jfom)(_mu_pair(r)[0])) for r in rows]) < 1e-14
    # the surrogate's thetas on a batched Mu: one row a parameter
    theta_b = torch.stack([c(batch) for c in tfom.operator.coefficients], dim=-1)
    theta_1 = torch.stack([c(_mu_pair(rows[2])[1]) for c in tfom.operator.coefficients])
    assert rel(theta_b[2], theta_1) < 1e-12


def test_bump_host_fom_own_field():
    """With the port's own field (its last bit differs from XLA's at some
    entries) at the default training draws: the MDEIM reproduces the exact
    operator to its tol at training parameters, and the sparse terms
    satisfy the affine identity sum_q theta_q A_q = the assembled
    surrogate."""
    fom = tbump.bump_host_fom(nx=NX, n_train_per_dim=4, n_train_random=20, device="cpu")
    op = fom.mdeim_op
    mu = {"bump": torch.tensor([0.45, 0.55, 0.5])}  # held out
    A = fom.exact_assemble(mu)
    th = op.theta_from_matrix(A)
    direct = sum(float(th[q]) * op.term_matrix(q) for q in range(op.n_terms))
    assert abs(direct - op.assemble(th)).max() < 1e-12
    grid_mu = {"bump": torch.tensor([0.0, 1.0 / 3.0, 1.0])}  # a 4^3 training point
    A = fom.exact_assemble(grid_mu)
    assert abs(op.assemble(op.theta_from_matrix(A)) - A).max() < 1e-6 * abs(A).max()


def test_mdeim_rejects_another_pattern_and_leaves_the_callers_matrices():
    """A snapshot on another sparsity pattern is refused; unsorted CSR
    snapshots are canonicalised on a copy (``tests/test_mdeim.py:183``)."""
    fom = tbump.bump_host_fom(nx=NX, n_train_per_dim=2, n_train_random=0, device="cpu")
    A = fom.exact_assemble({"bump": torch.tensor([0.2, 0.4, 0.6])})
    with pytest.raises(ValueError, match="sparsity pattern"):
        teim.mdeim([A, sps.eye(A.shape[0], format="csr")])
    mats = []
    for row in np.random.RandomState(3).uniform(0, 1, (8, 3)):
        B = fom.exact_assemble({"bump": torch.tensor(row)})
        P = sps.eye(B.shape[0], format="csr")
        C = (P @ B @ P).tocsr()
        C.has_sorted_indices = False  # force the canonicalisation path
        mats.append(C)
    before = [(m.indices.copy(), m.data.copy()) for m in mats]
    op = teim.mdeim(mats, tol=0.2, reserve=1)
    assert op.interpolant.n_reserve == 1
    op.entries_from_matrix(mats[0])
    op.indicator_from_matrix(mats[1])
    for m, (idx, data) in zip(mats, before):
        np.testing.assert_array_equal(m.indices, idx)
        np.testing.assert_array_equal(m.data, data)


def test_eim_files_cross_packages(bump_pair, tmp_path):
    """The port loads the JAX package's EIM interpolant and MDEIM operator
    files, and the JAX loaders read the port's: every field equal."""
    jfom, tfom, _ = bump_pair
    G = bump_snapshots()
    j = jeim.eim_greedy(jnp.asarray(G), tol=1e-6, reserve=3)
    t = teim.eim_greedy(torch.tensor(G), tol=1e-6, reserve=3)
    jser.save_eim_interpolant(j, tmp_path / "j.npz")
    tser.save_eim_interpolant(t, tmp_path / "t.npz")
    assert_interpolants_equal(tser.load_eim_interpolant(tmp_path / "j.npz", device="cpu"), j)
    assert_interpolants_equal(t, jser.load_eim_interpolant(tmp_path / "t.npz"))
    jser.save_mdeim_operator(jfom.mdeim_op, tmp_path / "jm.npz")
    tser.save_mdeim_operator(tfom.mdeim_op, tmp_path / "tm.npz")
    for back, ref in ((tser.load_mdeim_operator(tmp_path / "jm.npz"), jfom.mdeim_op),
                      (jser.load_mdeim_operator(tmp_path / "tm.npz"), tfom.mdeim_op)):
        assert back.shape == ref.shape and back.n_terms == ref.n_terms
        np.testing.assert_array_equal(back.indices, ref.indices)
        np.testing.assert_array_equal(back.magic_rows, ref.magic_rows)
        A = jfom.exact_assemble({"bump": jnp.asarray([0.3, 0.6, 0.4])})
        assert rel(back.theta_from_matrix(A), ref.theta_from_matrix(A)) < 1e-14
