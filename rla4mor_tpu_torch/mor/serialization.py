"""Standalone ROM files for :class:`StationaryROM`, in the JAX package's format.

Counterpart of ``save_rom`` / ``load_rom`` in
``rla4mor_tpu/mor/serialization.py``, for stationary ROMs only. The file is
one ``.npz``: ``kind = "stationary"``, ``aux = [ls, ls_rcond]``, and for each
affine block (``lhs``, ``rhs``, ``out``, ``est_lhs``, ``est_rhs``) its term
stack ``<name>__stack`` and coefficient specs ``<name>__coeffs`` as JSON. It
reads with numpy and json only, so either package loads the other's files.
A ROM file holds no seeds; ``seed_derivation`` is written as the JAX package
expects it.
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

SEED_DERIVATION = "tile-v1"


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
