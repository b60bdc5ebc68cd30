"""ROM files and reductor checkpoints.

Counterpart of ``rla4mor_tpu/mor/serialization.py`` for stationary ROMs and
the sketched reductors:

* ``save_rom`` / ``load_rom``: a standalone :class:`StationaryROM` in the
  JAX package's format. The file is one ``.npz``: ``kind = "stationary"``,
  ``aux = [ls, ls_rcond]``, and for each affine block (``lhs``, ``rhs``,
  ``out``, ``est_lhs``, ``est_rhs``) its term stack ``<name>__stack`` and
  coefficient specs ``<name>__coeffs`` as JSON. It reads with numpy and json
  only, so either package loads the other's files. A ROM file holds no
  seeds; ``seed_derivation`` is written as the JAX package expects it.
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


def save_rom(rom: StationaryROM, path) -> None:
    """Persist a :class:`StationaryROM` standalone (no FOM, no basis)."""
    if not isinstance(rom, StationaryROM):
        raise TypeError(f"save_rom: unsupported ROM type {type(rom)!r}")
    d: dict = {
        "seed_derivation": SEED_DERIVATION,
        "kind": "stationary",
        "aux": np.asarray([rom.ls, rom.ls_rcond], np.float64),
    }
    _save_affine(d, "lhs", rom.lhs)
    _save_affine(d, "rhs", rom.rhs)
    _save_affine(d, "out", rom.output_functional)
    if rom.error_estimator is not None:
        _save_affine(d, "est_lhs", rom.error_estimator.lhs)
        _save_affine(d, "est_rhs", rom.error_estimator.rhs)
    np.savez_compressed(path, **d)


def load_rom(path, device=None, dtype=None) -> StationaryROM:
    """Load a stationary ROM written by either package's ``save_rom``.

    Stacks go to ``device``, in the file's dtype unless ``dtype`` is given."""
    dev = resolve_device(device)
    src = path if hasattr(path, "read") else Path(path)
    with np.load(src, allow_pickle=False) as d:
        stored = str(d["seed_derivation"]) if "seed_derivation" in d else "pre-v1"
        if stored != SEED_DERIVATION:
            raise ValueError(f"ROM file written under seed derivation {stored!r}, "
                             f"expected {SEED_DERIVATION!r}")
        kind = str(d["kind"])
        if kind != "stationary":
            raise ValueError(f"load_rom: ROM kind {kind!r} is not ported yet")
        est = None
        est_lhs = _load_affine(d, "est_lhs", dev, dtype)
        if est_lhs is not None:
            est = ResidualErrorEstimator(est_lhs, _load_affine(d, "est_rhs", dev, dtype))
        ls, ls_rcond = d["aux"]
        return StationaryROM(
            _load_affine(d, "lhs", dev, dtype), _load_affine(d, "rhs", dev, dtype),
            output_functional=_load_affine(d, "out", dev, dtype),
            error_estimator=est, ls=bool(ls), ls_rcond=float(ls_rcond),
        )


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
    return {
        "seed_derivation": SEED_DERIVATION_CHECKPOINT,
        "seed_primal": reductor.embedding_primal.seed,
        "seed_online": reductor.embedding_online.seed,
        "fingerprint_primal": _embedding_fingerprint(reductor.embedding_primal),
        "fingerprint_online": _embedding_fingerprint(reductor.embedding_online),
        "projection": reductor.projection,
    }


def _check_seed_derivation(d) -> None:
    stored = str(d["seed_derivation"]) if "seed_derivation" in d else "pre-v1"
    if stored != SEED_DERIVATION_CHECKPOINT:
        raise ValueError(
            f"checkpoint was written under seed derivation {stored!r} but this "
            f"package uses {SEED_DERIVATION_CHECKPOINT!r}: the stored seeds would "
            "regenerate other embeddings than the ones that made the saved "
            "sketches; re-run the offline stage")


def _check_embeddings(d, reductor) -> None:
    """Seed and fingerprint guards shared by both loaders."""
    for name, emb in (("primal", reductor.embedding_primal),
                      ("online", reductor.embedding_online)):
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
