"""Device and dtype conventions of the PyTorch port.

Counterpart of ``rla4mor_tpu/utils/config.py``. The JAX package picks its
real dtype from the x64 flag: float64 in the CPU tests, float32 on its chip.
The port makes the same choice from the device a tensor lives on, and every
constructor takes an explicit ``device=``:

* CPU: float64 (the parity tests hold the port against the JAX package in
  f64);
* CUDA: float32, with TF32 switched off, so a float32 matrix product is an
  IEEE float32 product (TF32 keeps ~3 decimal digits, which would floor the
  sketched residual estimators).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; ``None`` means the CPU.

    A CUDA device turns TF32 off for matrix products and convolutions: the
    port's float32 contract is IEEE float32."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def default_dtype(device=None) -> torch.dtype:
    """Working real dtype on ``device``: float32 on CUDA, else float64."""
    return torch.float32 if resolve_device(device).type == "cuda" else torch.float64


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` (numpy array, tensor or number) as a tensor on ``device``.

    Real data is cast to ``dtype`` (default: :func:`default_dtype`);
    complex data keeps its imaginary part, at the matching complex width."""
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    t = torch.as_tensor(x)
    if t.is_complex() and not dt.is_complex:
        dt = torch.complex64 if dt == torch.float32 else torch.complex128
    return t.to(device=dev, dtype=dt)
