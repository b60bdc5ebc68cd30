"""rla4mor_tpu_torch — the PyTorch/CUDA port of ``rla4mor_tpu``.

The sketched reduced-basis main path on one NVIDIA GPU: thermal-block FOM
(host scipy) -> seeded SRHT sketch (a hand-written CUDA kernel for large n)
-> sketch-space Gram-Schmidt -> Galerkin / minres ROM with its sketched
residual estimator -> weak greedy -> batched serving; and at millions of
DoF the matrix-free stencil FOM solved by MG-CG on the card, sketched by
the same kernel, in the padded greedy step of ``parallel/driver.py``. The
JAX package ``rla4mor_tpu`` is the reference it is held against; this
package imports ``torch``, numpy and scipy, never ``jax``.

Subpackages mirror the JAX package's layout:

core     parameters, linear operators, affine algebra, products, Gram-Schmidt,
         device CG / BiCGStab
ops      embeddings, FWHT/SRHT, the one-pass SRHT kernel (csrc/), seeding
models   StationaryFOM / StationaryROM, thermal block, stencil thermal
         block, multigrid V-cycle
mor      sketched reductor, weak greedy, ROM files
parallel the padded greedy step and state_to_rom on one device
serve    batched online serving
examples the large-scale demo (entry point)
"""

__version__ = "0.1.0"
