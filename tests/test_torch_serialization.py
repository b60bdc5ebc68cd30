"""Reductor checkpoints of the port (``mor/serialization.py``): round trips,
a greedy resumed from a checkpoint, and the guards against resuming with
other operators, held to the JAX package's checkpoint contract
(``tests/test_serialization.py``), float64 on the CPU.

* Round trip: the restored state is bit-equal, its ROM equal to 1e-14.
* Resume: a greedy stopped after half its extensions, saved, loaded into a
  fresh reductor and finished picks the uninterrupted run's parameters and
  gives its ROM to 1e-12 (plain and padded reductor).
* Refusals: another seed, fingerprint (class or any scalar field),
  projection or seed derivation, including a checkpoint the JAX package
  wrote (its seeds name threefry operators, not the port's).
"""

import numpy as np
import pytest
import torch

import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch.models import ThermalBlockFOM, helmholtz_fom
from rla4mor_tpu_torch.mor import (
    PaddedSketchedReductor,
    SketchedReductor,
    load_padded_reductor_state,
    load_reductor_state,
    rb_greedy,
    rb_greedy_no_retrace,
    save_padded_reductor,
    save_reductor,
)
from rla4mor_tpu_torch.mor.serialization import _embedding_fingerprint

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fom():
    return ThermalBlockFOM((2, 2), 16, device="cpu")


def _embeddings(fom, seed=3, cls=temb.GaussianEmbedding, **kw):
    n = fom.solution_dim
    theta = cls.make(n, sqrt_product=fom.h1_0_product.sqrt, range_dim=60, seed=seed,
                     device="cpu", **kw)
    phi = temb.GaussianEmbedding.make(60, range_dim=30, seed=4, device="cpu")
    return theta, phi


def _plain(fom, projection="galerkin", **kw):
    theta, phi = _embeddings(fom, **kw)
    return SketchedReductor(fom, embedding_primal=theta, embedding_online=phi,
                            product=fom.h1_0_product, projection=projection, log_level=30)


def _padded(fom, **kw):
    theta, phi = _embeddings(fom, **kw)
    return PaddedSketchedReductor(fom, embedding_primal=theta, embedding_online=phi,
                                  product=fom.h1_0_product, r_max=6, log_level=30)


def _same_rom(a, b, tol):
    for name in ("lhs", "rhs"):
        x, y = getattr(a, name).stack, getattr(b, name).stack
        assert (x - y).abs().max() <= tol * y.abs().max(), name
    for name in ("lhs", "rhs"):
        x, y = getattr(a.error_estimator, name).stack, getattr(b.error_estimator, name).stack
        assert (x - y).abs().max() <= tol * y.abs().max(), name


def test_reductor_round_trip(fom, tmp_path):
    """save_reductor / load_reductor_state restore srb, rb, the affine
    stacks with their coefficients, the output and the basis parameters
    exactly; the ROMs reduced with one seed agree to 1e-14."""
    red = _plain(fom)
    mus = fom.parameter_space.sample_randomly(4, seed=0, device="cpu")
    for mu in mus:
        red.extend_basis(fom.solve(mu), mu=mu)
    save_reductor(red, tmp_path / "red.npz")
    red2 = _plain(fom)
    load_reductor_state(red2, tmp_path / "red.npz")
    assert torch.equal(red.srb, red2.srb) and torch.equal(red.rb, red2.rb)
    for name in ("residual_lhs", "residual_rhs", "output_functional"):
        a, b = getattr(red, name), getattr(red2, name)
        assert torch.equal(a.stack, b.stack) and a.coefficients == b.coefficients
    assert [m["diffusion"].tolist() for m in red2.mu_basis] == \
        [m["diffusion"].tolist() for m in mus]
    _same_rom(red.reduce(seed=11), red2.reduce(seed=11), 1e-14)


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
def test_greedy_resumed_from_a_checkpoint(fom, tmp_path, padded):
    """A weak greedy of 6 extensions against one stopped after 3, saved,
    loaded into a fresh reductor and resumed to 6: the same parameters in
    the same order, and ROMs equal to 1e-12 (``rb_greedy`` with
    ``SketchedReductor``; ``rb_greedy_no_retrace`` with the padded one)."""
    make, greedy = (_padded, rb_greedy_no_retrace) if padded else (_plain, rb_greedy)
    save, load = ((save_padded_reductor, load_padded_reductor_state) if padded
                  else (save_reductor, load_reductor_state))
    train = fom.parameter_space.sample_randomly(30, seed=5, device="cpu")
    whole = greedy(fom, make(fom), train, max_extensions=6, log_level=30)
    first = make(fom)
    greedy(fom, first, train, max_extensions=3, log_level=30)
    save(first, tmp_path / "half.npz")
    resumed = make(fom)
    load(resumed, tmp_path / "half.npz")
    assert resumed.basis_size == 3
    rest = greedy(fom, resumed, train, max_extensions=6, log_level=30)
    picks = lambda r: [m["diffusion"].tolist() for m in r.selected_mus]  # noqa: E731
    assert picks(rest) == picks(whole) and len(picks(whole)) == 6
    _same_rom(rest.rom, whole.rom, 1e-12)


def test_loaders_refuse_other_operators(fom, tmp_path):
    """Another seed, embedding class, scalar field (sketch size, complex
    Omega, block size) or projection is refused with its reason; so is a
    checkpoint of another seed derivation. The matching reductor loads."""
    red = _plain(fom)
    mu = fom.parameter_space.sample_randomly(1, seed=0, device="cpu")[0]
    red.extend_basis(fom.solve(mu), mu=mu)
    path = tmp_path / "guard.npz"
    save_reductor(red, path)
    with pytest.raises(ValueError, match="seed_primal"):
        load_reductor_state(_plain(fom, seed=7), path)
    for other in (_plain(fom, cls=temb.SrhtEmbedding), _plain(fom, complex_dtype=True),
                  _plain(fom, cls=temb.BlockGaussianEmbedding)):
        with pytest.raises(ValueError, match="does not match"):
            load_reductor_state(other, path)
    with pytest.raises(ValueError, match="projection"):
        load_reductor_state(_plain(fom, projection="minres"), path)
    d = dict(np.load(path))
    d["seed_derivation"] = np.asarray("tile-v1")
    np.savez(tmp_path / "other.npz", **d)
    with pytest.raises(ValueError, match="seed derivation 'tile-v1'"):
        load_reductor_state(_plain(fom), tmp_path / "other.npz")
    pad = _padded(fom)
    pad.extend_basis(fom.solve(mu), mu=mu)
    save_padded_reductor(pad, tmp_path / "pad.npz")
    with pytest.raises(ValueError, match="seed_primal"):
        load_padded_reductor_state(_padded(fom, seed=8), tmp_path / "pad.npz")
    ok = _plain(fom)
    load_reductor_state(ok, path)
    assert ok.basis_size == 1


def test_checkpoint_written_by_the_jax_package_is_refused(tmp_path):
    """A checkpoint that the JAX package's ``save_reductor`` wrote (same FOM,
    same seeds, same fingerprint fields) is refused by its seed-derivation
    tag, never resumed with the port's operators."""
    import rla4mor_tpu.mor as jmor
    from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
    from rla4mor_tpu.ops import GaussianEmbedding as JaxGaussian

    jfom = JaxFOM((2, 2), 8)
    theta = JaxGaussian.make(jfom.solution_dim, sqrt_product=jfom.h1_0_product.sqrt,
                             range_dim=60, seed=3)
    jred = jmor.SketchedReductor(jfom, embedding_primal=theta,
                                 embedding_online=JaxGaussian.make(60, range_dim=30, seed=4),
                                 product=jfom.h1_0_product, log_level=30)
    jred.extend_basis(jfom.solve(jfom.parameter_space.sample_randomly(1, key=0)[0]))
    jmor.save_reductor(jred, tmp_path / "jax.npz")
    port = _plain(ThermalBlockFOM((2, 2), 8, device="cpu"))
    assert str(np.load(tmp_path / "jax.npz")["fingerprint_primal"]) == \
        _embedding_fingerprint(port.embedding_primal)
    with pytest.raises(ValueError, match="seed derivation 'tile-v1'"):
        load_reductor_state(port, tmp_path / "jax.npz")


@pytest.mark.parametrize("cls, field, value", [
    (temb.GaussianEmbedding, "range_dim", 61), (temb.GaussianEmbedding, "seed", 9),
    (temb.GaussianEmbedding, "complex_dtype", True), (temb.RademacherEmbedding, "seed", 9),
    (temb.SparseSignEmbedding, "s", 4), (temb.BlockGaussianEmbedding, "max_block_size", 16),
    (temb.StreamedGaussianEmbedding, "block_cols", 8192), (temb.SrhtEmbedding, "seed", 9),
    (temb.HwPrngGaussianEmbedding, "block_rows", 1024),
    (temb.HwPrngGaussianEmbedding, "dist", "rademacher"),
])
def test_fingerprint_covers_every_field(cls, field, value):
    """Each scalar field of each embedding class enters the fingerprint: the
    same class with one field changed fingerprints differently, and the
    fingerprint names the class and holds every field."""
    e = cls.make(300, range_dim=60, seed=3, device="cpu")
    fp = _embedding_fingerprint(e)
    assert set(e.fields()) <= set(__import__("json").loads(fp)) and cls.__name__ in fp
    assert _embedding_fingerprint(e._replace(**{field: value})) != fp


def test_expression_coefficients_are_refused(tmp_path):
    """The file format names constant, projection and product coefficients;
    the Helmholtz family's -k^2 + i c k (an ``ExpressionCoefficient``) raises
    TypeError, as in the JAX package (checkpoint the thermal block)."""
    hfom = helmholtz_fom(8, device="cpu")
    theta = temb.GaussianEmbedding.make(hfom.solution_dim, sqrt_product=hfom.h1_0_product.sqrt,
                                        range_dim=40, seed=1, complex_dtype=True, device="cpu")
    red = SketchedReductor(hfom, embedding_primal=theta, product=hfom.h1_0_product,
                           projection="minres", log_level=30)
    red.extend_basis(hfom.solve({"wavenumber": torch.tensor([5.0], dtype=torch.float64)}))
    with pytest.raises(TypeError, match="cannot serialize coefficient"):
        save_reductor(red, tmp_path / "helmholtz.npz")
