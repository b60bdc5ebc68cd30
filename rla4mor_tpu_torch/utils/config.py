"""Device and dtype conventions of the PyTorch port.

Counterpart of ``rla4mor_tpu/utils/config.py``. The JAX package picks its
real dtype from the x64 flag: float64 in the CPU tests, float32 on its chip.
The port makes the same choice from the device a tensor lives on:

* CUDA (the default: an entry point given no ``device`` runs on the current
  card): float32, with TF32 switched off, so a float32 matrix product is an
  IEEE float32 product (TF32 keeps ~3 decimal digits, which would floor the
  sketched residual estimators);
* CPU, only where a caller names it (``device="cpu"``): float64 (the parity
  tests hold the port against the JAX package in f64).
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; ``None`` means the current CUDA
    device, and raises without one (the CPU is used only when named).

    A CUDA device turns TF32 off for matrix products and convolutions: the
    port's float32 contract is IEEE float32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: rla4mor_tpu_torch runs on the GPU by default; "
                'pass device="cpu" to run on the CPU')
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
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


@functools.cache
def sm_count(dev_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``dev_index``, queried once."""
    return torch.cuda.get_device_properties(dev_index).multi_processor_count
