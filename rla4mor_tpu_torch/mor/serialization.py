"""ROM files and reductor checkpoints.

Counterpart of ``rla4mor_tpu/mor/serialization.py`` for stationary ROMs and
the sketched reductors:

* ``save_rom`` / ``load_rom``: a standalone ROM in the JAX package's
  format: :class:`StationaryROM` (``kind = "stationary"``, ``aux = [ls,
  ls_rcond]``), ``InstationaryROM`` (``"instationary"``, ``aux = [dt, nt,
  theta]`` and the arrays ``mass_r``, ``u0_r``, ``est_mass``) and the
  corrected-output composites (``"corrected_output"``,
  ``"instationary_corrected_output"``: their parts nested under ``pr__`` /
  ``du__``). The file is one ``.npz``; each affine block (``lhs``, ``rhs``,
  ``out``, ``est_lhs``, ``est_rhs``, ...) is its term stack
  ``<name>__stack`` and its coefficient specs ``<name>__coeffs`` as JSON. It
  reads with numpy and json only, so either package loads the other's
  files. A ROM file holds no seeds; ``seed_derivation`` is written as the
  JAX package expects it.
* ``save_reductor`` / ``load_reductor_state`` (:class:`SketchedReductor`)
  and ``save_padded_reductor`` / ``load_padded_reductor_state``
  (:class:`PaddedSketchedReductor`): the sketched state (sketched basis,
  basis, affine residual stacks, output, basis parameters), the embeddings'
  seeds and fingerprints and the projection, so a greedy run can stop and
  resume. A seed names the port's operator (``ops/seeding.py``'s
  ``torch.Generator`` tiles), not the JAX package's threefry one: the port
  writes and accepts only its own derivation tag,
  ``SEED_DERIVATION_CHECKPOINT``, and refuses a checkpoint of the JAX
  package's (``"tile-v1"``), whose seeds would regenerate other operators.
  The loaders also refuse another seed, another embedding fingerprint
  (class and every scalar field, :meth:`Embedding.fields`) and another
  projection. A coefficient the file format cannot name (an
  ``ExpressionCoefficient``, e.g. the Helmholtz family's) raises
  ``TypeError``, as in the JAX package.
* ``save_instationary_reductor`` / ``load_instationary_reductor_state``
  and ``save_primal_dual_reductor`` / ``load_primal_dual_reductor_state``:
  the time-dependent reductors' bases (``reduce()`` rebuilds the rest from
  the FOM), with the port's tag and the embeddings' seeds and fingerprints
  (and the output kind), so a POD-greedy run can resume;
* ``save_eim_interpolant`` / ``load_eim_interpolant`` and
  ``save_mdeim_operator`` / ``load_mdeim_operator``: the non-affine
  surrogates' offline results, under the JAX package's keys, so either
  package loads the other's files. They hold no seed and no tag.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rla4mor_tpu_torch.core.affine import AffineDense
from rla4mor_tpu_torch.core.parameters import (
    Coefficient,
    ConstantCoefficient,
    ProductCoefficient,
    ProjectionCoefficient,
)
from rla4mor_tpu_torch.models.stationary import ResidualErrorEstimator, StationaryROM
from rla4mor_tpu_torch.utils.config import resolve_device

# the JAX package's tag, which its ROM files carry (they hold no seeds)
SEED_DERIVATION = "tile-v1"
# the port's seed -> operator derivation (ops/seeding.py); bump it whenever
# that derivation changes, so that no stored seed names another operator
SEED_DERIVATION_CHECKPOINT = "torch-generator-tile-v1"


def _coeff_to_spec(c: Coefficient):
    if isinstance(c, ConstantCoefficient):
        return {"kind": "const", "value": c.value}
    if isinstance(c, ProjectionCoefficient):
        return {"kind": "proj", "key": c.key, "index": c.index}
    if isinstance(c, ProductCoefficient):
        return {"kind": "prod", "factors": [_coeff_to_spec(f) for f in c.factors]}
    raise TypeError(f"cannot serialize coefficient {c!r}")


def _coeff_from_spec(spec) -> Coefficient:
    if spec["kind"] == "const":
        return ConstantCoefficient(spec["value"])
    if spec["kind"] == "proj":
        return ProjectionCoefficient(spec["key"], spec["index"])
    if spec["kind"] == "prod":
        return ProductCoefficient(tuple(_coeff_from_spec(f) for f in spec["factors"]))
    raise ValueError(spec)


def _save_affine(d: dict, prefix: str, op: Optional[AffineDense]) -> None:
    if op is None:
        return
    d[f"{prefix}__stack"] = op.stack.detach().cpu().numpy()
    d[f"{prefix}__coeffs"] = json.dumps([_coeff_to_spec(c) for c in op.coefficients])


def _load_affine(d, prefix: str, device, dtype) -> Optional[AffineDense]:
    if f"{prefix}__stack" not in d:
        return None
    coeffs = [_coeff_from_spec(s) for s in json.loads(str(d[f"{prefix}__coeffs"]))]
    stack = torch.as_tensor(d[f"{prefix}__stack"]).to(device=device)
    if dtype is not None:
        stack = stack.to(dtype)
    return AffineDense(stack, tuple(coeffs))


def save_rom(rom, path) -> None:
    """Persist a :class:`StationaryROM`, an ``InstationaryROM`` or a
    corrected-output composite (``CorrectedOutputROM``,
    ``InstationaryCorrectedOutputROM``) standalone: no FOM, no basis."""
    np.savez_compressed(path, seed_derivation=SEED_DERIVATION, **_rom_fields(rom))


def _rom_fields(rom) -> dict:
    """A ROM as the JAX package's flat ``.npz`` fields (a composite's parts
    nested under the key prefixes ``pr__`` / ``du__``)."""
    from rla4mor_tpu_torch.models.instationary import InstationaryROM
    from rla4mor_tpu_torch.models.instationary_primal_dual import (
        InstationaryCorrectedOutputROM,
    )
    from rla4mor_tpu_torch.mor.primal_dual import CorrectedOutputROM

    d: dict = {}

    def arr(key, x):
        if x is not None:
            d[key] = _numpy(x)

    if isinstance(rom, StationaryROM):
        d["kind"] = "stationary"
        d["aux"] = np.asarray([rom.ls, rom.ls_rcond], np.float64)
        _save_affine(d, "lhs", rom.lhs)
        _save_affine(d, "rhs", rom.rhs)
        _save_affine(d, "out", rom.output_functional)
        if rom.error_estimator is not None:
            _save_affine(d, "est_lhs", rom.error_estimator.lhs)
            _save_affine(d, "est_rhs", rom.error_estimator.rhs)
    elif isinstance(rom, InstationaryROM):
        d["kind"] = "instationary"
        d["aux"] = np.asarray([rom.dt, rom.nt, rom.time_theta], np.float64)
        arr("mass_r", rom.mass_r)
        arr("u0_r", rom.u0_r)
        arr("est_mass", rom.est_mass)
        _save_affine(d, "lhs", rom.lhs)
        _save_affine(d, "rhs", rom.rhs_r)
        _save_affine(d, "est_lhs", rom.est_lhs)
        _save_affine(d, "est_rhs", rom.est_rhs)
        _save_affine(d, "out", rom.output_functional)
    elif isinstance(rom, CorrectedOutputROM):
        d["kind"] = "corrected_output"
        d["aux"] = np.asarray([], np.float64)
        _nest(d, "pr", rom.rom_pr)
        _nest(d, "du", rom.rom_du)
        _save_affine(d, "rhs_z", rom.rhs_z)
        _save_affine(d, "op_zv", rom.op_zv)
    elif isinstance(rom, InstationaryCorrectedOutputROM):
        d["kind"] = "instationary_corrected_output"
        d["aux"] = np.asarray([], np.float64)
        d["output_kind"] = rom.output_kind
        _nest(d, "pr", rom.rom_pr)
        arr("mass_zz", rom.mass_zz)
        arr("mass_zv", rom.mass_zv)
        arr("est_mass_z", rom.est_mass_z)
        _save_affine(d, "lhs_zz", rom.lhs_zz)
        _save_affine(d, "l_z", rom.l_z)
        _save_affine(d, "rhs_z", rom.rhs_z)
        _save_affine(d, "op_zv", rom.op_zv)
        _save_affine(d, "est_lhs_z", rom.est_lhs_z)
        _save_affine(d, "est_l", rom.est_l)
    else:
        raise TypeError(f"save_rom: unsupported ROM type {type(rom)!r}")
    return d


def _nest(d: dict, prefix: str, rom) -> None:
    for key, value in _rom_fields(rom).items():
        d[f"{prefix}__{key}"] = value


def load_rom(path, device=None, dtype=None):
    """Load a ROM written by either package's ``save_rom``: stationary,
    instationary, and the two corrected-output kinds (the wave and
    semilinear kinds are not ported). Tensors go to ``device``, in the
    file's dtype unless ``dtype`` is given."""
    dev = resolve_device(device)
    src = path if hasattr(path, "read") else Path(path)
    with np.load(src, allow_pickle=False) as d:
        stored = str(d["seed_derivation"]) if "seed_derivation" in d else "pre-v1"
        if stored != SEED_DERIVATION:
            raise ValueError(f"ROM file written under seed derivation {stored!r}, "
                             f"expected {SEED_DERIVATION!r}")
        return _rom_from_fields({key: d[key] for key in d.files}, dev, dtype)


def _rom_from_fields(d: dict, dev, dtype):
    from rla4mor_tpu_torch.models.instationary import InstationaryROM
    from rla4mor_tpu_torch.models.instationary_primal_dual import (
        InstationaryCorrectedOutputROM,
    )
    from rla4mor_tpu_torch.mor.primal_dual import CorrectedOutputROM

    kind = str(d["kind"])

    def arr(key):
        if key not in d:
            return None
        t = torch.as_tensor(d[key]).to(dev)
        return t if dtype is None else t.to(dtype)

    def affine(prefix):
        return _load_affine(d, prefix, dev, dtype)

    def nested(prefix):
        head = prefix + "__"
        return _rom_from_fields({k[len(head):]: v for k, v in d.items()
                                 if k.startswith(head)}, dev, dtype)

    if kind == "stationary":
        est = None
        if "est_lhs__stack" in d:
            est = ResidualErrorEstimator(affine("est_lhs"), affine("est_rhs"))
        ls, ls_rcond = d["aux"]
        return StationaryROM(affine("lhs"), affine("rhs"), output_functional=affine("out"),
                             error_estimator=est, ls=bool(ls), ls_rcond=float(ls_rcond))
    if kind == "instationary":
        dt, nt, th = d["aux"]
        return InstationaryROM(arr("mass_r"), affine("lhs"), affine("rhs"), arr("u0_r"),
                               float(dt), int(nt), est_mass=arr("est_mass"),
                               est_lhs=affine("est_lhs"), est_rhs=affine("est_rhs"),
                               output_functional=affine("out"), time_theta=float(th))
    if kind == "corrected_output":
        return CorrectedOutputROM(nested("pr"), nested("du"), affine("rhs_z"),
                                  affine("op_zv"))
    if kind == "instationary_corrected_output":
        return InstationaryCorrectedOutputROM(
            nested("pr"), arr("mass_zz"), affine("lhs_zz"), affine("l_z"),
            affine("rhs_z"), arr("mass_zv"), affine("op_zv"),
            est_mass_z=arr("est_mass_z"), est_lhs_z=affine("est_lhs_z"),
            est_l=affine("est_l"),
            output_kind=str(d["output_kind"]) if "output_kind" in d else "final")
    raise ValueError(f"load_rom: ROM kind {kind!r} is not ported")


# ---------------------------------------------------------------------------
# reductor checkpoints
# ---------------------------------------------------------------------------


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _embedding_fingerprint(e) -> str:
    """The operator's identity: class name and every scalar field (sizes,
    seed, ``complex_dtype``, block sizes, sparsity, dist, ...). The seed
    alone is not enough: two same-seed embeddings with other fields are
    other operators."""
    fields = e.fields() if hasattr(e, "fields") else {"seed": getattr(e, "seed", None)}
    scalars = {k: v for k, v in fields.items() if isinstance(v, (int, float, str, bool))}
    return json.dumps({"class": type(e).__name__, **dict(sorted(scalars.items()))})


def _save_mu_basis(d: dict, mu_basis) -> None:
    if not mu_basis:
        return
    keys = sorted(mu_basis[0].keys())
    d["mu_basis_keys"] = json.dumps(keys)
    for name in keys:
        d[f"mu_basis__{name}"] = np.stack([_numpy(torch.as_tensor(m[name]))
                                          for m in mu_basis])


def _load_mu_basis(d, device) -> list:
    if "mu_basis_keys" not in d:
        return []
    keys = json.loads(str(d["mu_basis_keys"]))
    count = d[f"mu_basis__{keys[0]}"].shape[0]
    return [{k: torch.as_tensor(d[f"mu_basis__{k}"][i]).to(device) for k in keys}
            for i in range(count)]


def _header(reductor) -> dict:
    """Derivation tag, seeds, fingerprints and projection of a checkpoint."""
    d = {"seed_derivation": SEED_DERIVATION_CHECKPOINT, "projection": reductor.projection}
    _embedding_header(d, "primal", reductor.embedding_primal)
    _embedding_header(d, "online", reductor.embedding_online)
    return d


def _embedding_header(d: dict, name: str, emb) -> None:
    """The seed and fingerprint of a checkpointed embedding (none kept:
    nothing written)."""
    if emb is not None:
        d[f"seed_{name}"] = emb.seed
        d[f"fingerprint_{name}"] = _embedding_fingerprint(emb)


def _check_seed_derivation(d) -> None:
    stored = str(d["seed_derivation"]) if "seed_derivation" in d else "pre-v1"
    if stored != SEED_DERIVATION_CHECKPOINT:
        raise ValueError(
            f"checkpoint was written under seed derivation {stored!r} but this "
            f"package uses {SEED_DERIVATION_CHECKPOINT!r}: the stored seeds would "
            "regenerate other embeddings than the ones that made the saved "
            "sketches; re-run the offline stage")


def _check_embedding(d, name: str, emb) -> None:
    """Seed and fingerprint guard of one checkpointed embedding (none kept:
    nothing to check)."""
    if emb is None:
        return
    if f"seed_{name}" in d and int(d[f"seed_{name}"]) != emb.seed:
        raise ValueError(
            f"checkpoint seed_{name}={int(d[f'seed_{name}'])} != reductor's "
            f"{emb.seed}: the stored sketches came from another embedding")
    key = f"fingerprint_{name}"
    if key in d and str(d[key]) != _embedding_fingerprint(emb):
        raise ValueError(
            f"checkpoint {name} embedding {str(d[key])} does not match the "
            f"reductor's {_embedding_fingerprint(emb)}: same-seed operators "
            "with other fields are other operators")


def _check_embeddings(d, reductor) -> None:
    """The guards of the sketched reductors' two embeddings."""
    _check_embedding(d, "primal", reductor.embedding_primal)
    _check_embedding(d, "online", reductor.embedding_online)


def _check_projection(d, reductor) -> None:
    stored = str(d["projection"]) if "projection" in d else None
    if stored is not None and stored != reductor.projection:
        raise ValueError(
            f"checkpoint was written under projection={stored!r} but the reductor "
            f"uses {reductor.projection!r}: resuming would switch the solve / "
            "estimate rule and the online seed schedule mid-run")


def _open_checked(path, reductor):
    d = np.load(Path(path), allow_pickle=False)
    _check_seed_derivation(d)
    _check_embeddings(d, reductor)
    _check_projection(d, reductor)
    return d


def save_reductor(reductor, path) -> None:
    """Persist the sketched state of a :class:`SketchedReductor`."""
    d = {**_header(reductor), "srb": _numpy(reductor.srb), "rb": _numpy(reductor.rb)}
    _save_affine(d, "residual_lhs", reductor.residual_lhs)
    _save_affine(d, "residual_rhs", reductor.residual_rhs)
    _save_affine(d, "output", reductor.output_functional)
    _save_mu_basis(d, reductor.mu_basis)
    np.savez_compressed(path, **d)


def load_reductor_state(reductor, path) -> None:
    """Restore the state :func:`save_reductor` wrote into a freshly made
    reductor over the same FOM and embeddings (on the reductor's device)."""
    dev = reductor.device
    with _open_checked(path, reductor) as d:
        reductor.srb = torch.as_tensor(d["srb"]).to(dev)
        reductor.rb = torch.as_tensor(d["rb"]).to(dev)
        reductor.residual_lhs = _load_affine(d, "residual_lhs", dev, None)
        reductor.residual_rhs = _load_affine(d, "residual_rhs", dev, None)
        reductor.output_functional = _load_affine(d, "output", dev, None)
        mu_basis = _load_mu_basis(d, dev)
    if mu_basis:
        reductor.mu_basis = mu_basis


def save_padded_reductor(reductor, path) -> None:
    """Persist a :class:`PaddedSketchedReductor`'s fixed-shape state: the
    padded buffers, fill counter, seeds and basis parameters."""
    st = reductor.state
    d = {**_header(reductor), "pad__srb": _numpy(st.srb), "pad__res_lhs": _numpy(st.res_lhs),
         "pad__out": _numpy(st.out), "pad__rb": _numpy(st.rb), "pad__ncols": _numpy(st.ncols)}
    _save_affine(d, "residual_rhs", reductor.residual_rhs)
    _save_mu_basis(d, reductor.mu_basis)
    np.savez_compressed(path, **d)


def load_padded_reductor_state(reductor, path) -> None:
    """Restore the state :func:`save_padded_reductor` wrote into a freshly
    made ``PaddedSketchedReductor`` (same FOM, embeddings and r_max)."""
    st, dev = reductor.state, reductor.device
    with _open_checked(path, reductor) as d:
        if d["pad__srb"].shape != tuple(st.srb.shape):
            raise ValueError(f"r_max / sketch dims mismatch: {d['pad__srb'].shape} vs "
                             f"{tuple(st.srb.shape)}")
        reductor.state = type(st)(*(torch.as_tensor(d[f"pad__{name}"]).to(dev)
                                    for name in st._fields))
        mu_basis = _load_mu_basis(d, dev)
    if mu_basis:
        reductor.mu_basis = mu_basis


def save_instationary_reductor(reductor, path) -> None:
    """Persist an ``InstationaryReductor``: its resumable state is the
    R-orthonormal basis (``reduce()`` rebuilds the rest from the FOM), with
    the embedding's seed and fingerprint, so a POD-greedy run can resume."""
    d = {"seed_derivation": SEED_DERIVATION_CHECKPOINT, "rb": _numpy(reductor.rb)}
    _embedding_header(d, "embedding", reductor.embedding)
    np.savez_compressed(path, **d)


def load_instationary_reductor_state(reductor, path) -> None:
    """Restore :func:`save_instationary_reductor`'s state into a freshly
    made reductor over the same FOM and embedding (on its device)."""
    with np.load(Path(path), allow_pickle=False) as d:
        _check_seed_derivation(d)
        _check_embedding(d, "embedding", reductor.embedding)
        reductor.rb = torch.as_tensor(d["rb"]).to(reductor.rb.device)


def save_primal_dual_reductor(reductor, path) -> None:
    """Persist an ``InstationaryPrimalDualReductor``: both bases, the output
    kind and both embeddings' seeds and fingerprints."""
    d = {"seed_derivation": SEED_DERIVATION_CHECKPOINT, "rb": _numpy(reductor.primal.rb),
         "rb_dual": _numpy(reductor.rb_dual), "output_kind": reductor.output_kind}
    _embedding_header(d, "embedding", reductor.primal.embedding)
    _embedding_header(d, "embedding_dual", reductor.embedding_dual)
    np.savez_compressed(path, **d)


def load_primal_dual_reductor_state(reductor, path) -> None:
    """Restore :func:`save_primal_dual_reductor`'s state into a freshly made
    reductor over the same FOM, embeddings and output kind."""
    with np.load(Path(path), allow_pickle=False) as d:
        _check_seed_derivation(d)
        stored = str(d["output_kind"]) if "output_kind" in d else "final"
        if stored != reductor.output_kind:
            raise ValueError(
                f"checkpoint was written under output_kind={stored!r} but the reductor "
                f"uses {reductor.output_kind!r}: rb_dual holds POD modes of another "
                "adjoint problem")
        _check_embedding(d, "embedding", reductor.primal.embedding)
        _check_embedding(d, "embedding_dual", reductor.embedding_dual)
        dev = reductor.rb_dual.device
        reductor.primal.rb = torch.as_tensor(d["rb"]).to(dev)
        reductor.rb_dual = torch.as_tensor(d["rb_dual"]).to(dev)


# ---------------------------------------------------------------------------
# EIM interpolants and MDEIM operators
# ---------------------------------------------------------------------------


def _eim_arrays(interp) -> dict:
    """An ``EimInterpolant`` as the JAX package's ``.npz`` fields (one
    site, shared by the MDEIM saver)."""
    return dict(
        basis=_numpy(interp.basis),
        points=_numpy(interp.points).astype(np.int32),
        interp_matrix=_numpy(interp.interp_matrix),
        triangular=np.asarray(interp.triangular),
        sup_errors=np.asarray(interp.sup_errors, np.float64),
        n_reserve=np.asarray(interp.n_reserve),
        snapshot_ids=np.asarray(interp.snapshot_ids, np.int64),
    )


def _eim_from(d, device, dtype):
    from rla4mor_tpu_torch.mor.eim import EimInterpolant

    def arr(name):
        t = torch.as_tensor(d[name]).to(device)
        return t if dtype is None else t.to(dtype)

    # the basis column-major, as the greedies build it
    basis = torch.as_tensor(np.ascontiguousarray(d["basis"].T)).to(device).T
    return EimInterpolant(
        basis=basis if dtype is None else basis.to(dtype),
        points=torch.as_tensor(d["points"]).to(device=device, dtype=torch.int64),
        interp_matrix=arr("interp_matrix"), triangular=bool(d["triangular"]),
        sup_errors=tuple(d["sup_errors"].tolist()), n_reserve=int(d["n_reserve"]),
        snapshot_ids=tuple(int(j) for j in d["snapshot_ids"]))


def save_eim_interpolant(interp, path) -> None:
    """An :class:`~rla4mor_tpu_torch.mor.eim.EimInterpolant` as ``.npz``,
    in the JAX package's format (either package loads the other's files).
    An interpolant holds no seed, so the file carries no derivation tag."""
    np.savez(Path(path), eim_version=np.asarray(1), **_eim_arrays(interp))


def load_eim_interpolant(path, device=None, dtype=None):
    """Load an interpolant written by either package, on ``device``, in the
    file's dtype unless ``dtype`` is given."""
    dev = resolve_device(device)
    with np.load(Path(path), allow_pickle=False) as d:
        if int(d["eim_version"]) != 1:
            raise ValueError("unknown EIM checkpoint version")
        return _eim_from(d, dev, dtype)


def save_mdeim_operator(op, path) -> None:
    """An :class:`~rla4mor_tpu_torch.mor.eim.MdeimOperator` (its
    interpolant and the shared CSR pattern) as ``.npz``, the JAX package's
    format."""
    np.savez(Path(path), mdeim_version=np.asarray(1), indices=op.indices, indptr=op.indptr,
             shape=np.asarray(op.shape), **_eim_arrays(op.interpolant))


def load_mdeim_operator(path):
    """Load an MDEIM operator written by either package (a host object:
    its interpolant on the CPU, in the file's dtype)."""
    from rla4mor_tpu_torch.mor.eim import MdeimOperator

    with np.load(Path(path), allow_pickle=False) as d:
        if int(d["mdeim_version"]) != 1:
            raise ValueError("unknown MDEIM checkpoint version")
        return MdeimOperator(_eim_from(d, torch.device("cpu"), None), d["indices"],
                             d["indptr"], tuple(int(s) for s in d["shape"]))
