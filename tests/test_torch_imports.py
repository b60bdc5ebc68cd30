"""Importing the PyTorch port pulls in no JAX (nor the JAX package, nor
scikit-learn) and compiles nothing: every module imports with ``jax`` and
``rla4mor_tpu`` blocked (an import of either raises), and so does
``tests/torch_parallel_ranks.py``, the module the sharded tests' spawned
ranks import."""

import os
import subprocess
import sys
from pathlib import Path

import torch

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

_CHILD = r"""
import importlib, os, pkgutil, subprocess, sys

import numpy, numpy.testing, scipy.sparse.linalg, torch  # third-party first

class Block:  # refuses jax and the JAX package: an import of either raises
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "rla4mor_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())

def refuse(*args, **kwargs):
    raise AssertionError(f"importing started a process: {args!r}")

subprocess.run = subprocess.Popen = subprocess.check_call = refuse

import rla4mor_tpu_torch as pkg

build = os.path.join(pkg.__path__[0], "_build")
before = sorted(os.listdir(build)) if os.path.isdir(build) else None
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "rla4mor_tpu_torch.")]
for name in names:
    importlib.import_module(name)
after = sorted(os.listdir(build)) if os.path.isdir(build) else None
# the rank side of the sharded tests, which each spawned rank imports
sys.path.insert(0, "tests")
import torch_parallel_ranks  # noqa: F401

from rla4mor_tpu_torch.utils import nvcc

assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert "rla4mor_tpu" not in sys.modules
assert "sklearn" not in sys.modules, sorted(m for m in sys.modules if "sklearn" in m)
assert before == after, (before, after)
assert nvcc.loaded() == ()
print(" ".join(names))
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 87  # every module of the slices
    assert {"rla4mor_tpu_torch.parallel.mesh",
            "rla4mor_tpu_torch.parallel.launch",
            "rla4mor_tpu_torch.parallel.embeddings",
            "rla4mor_tpu_torch.examples.multichip_dryrun",
            "rla4mor_tpu_torch.probes.parallel_probe",
            "rla4mor_tpu_torch.mor.uq",
            "rla4mor_tpu_torch.mor.optimize",
            "rla4mor_tpu_torch.examples.uq_demo",
            "rla4mor_tpu_torch.examples.optimize_demo",
            "rla4mor_tpu_torch.examples.online_serving_demo",
            "rla4mor_tpu_torch.examples.sketched_rb_demo",
            "rla4mor_tpu_torch.mor.scm_matfree",
            "rla4mor_tpu_torch.probes.bounds_probe",
            "rla4mor_tpu_torch.models.wave",
            "rla4mor_tpu_torch.models.wave_stencil",
            "rla4mor_tpu_torch.models.semilinear",
            "rla4mor_tpu_torch.mor.semilinear_reductor",
            "rla4mor_tpu_torch.examples.wave_demo",
            "rla4mor_tpu_torch.examples.semilinear_demo",
            "rla4mor_tpu_torch.core.graphs",
            "rla4mor_tpu_torch.models.instationary",
            "rla4mor_tpu_torch.models.instationary_stencil",
            "rla4mor_tpu_torch.models.instationary_primal_dual",
            "rla4mor_tpu_torch.mor.primal_dual",
            "rla4mor_tpu_torch.examples.large_scale_parabolic_demo",
            "rla4mor_tpu_torch.examples.instationary_demo",
            "rla4mor_tpu_torch.models.helmholtz",
            "rla4mor_tpu_torch.models.stencil_nonaffine",
            "rla4mor_tpu_torch.models.bump_host",
            "rla4mor_tpu_torch.mor.eim",
            "rla4mor_tpu_torch.mor.bounds",
            "rla4mor_tpu_torch.mor.scm",
            "rla4mor_tpu_torch.examples.helmholtz_demo",
            "rla4mor_tpu_torch.precond.preconditioned_reductor",
            "rla4mor_tpu_torch.precond.preconditioned_rom",
            "rla4mor_tpu_torch.core.image",
            "rla4mor_tpu_torch.core.rsvd",
            "rla4mor_tpu_torch.estim.lars",
            "rla4mor_tpu_torch.estim.manifold_distance",
            "rla4mor_tpu_torch.estim.recovery_map",
            "rla4mor_tpu_torch.examples.preconditioned_large_demo",
            "rla4mor_tpu_torch.examples.inverse_problems_demo"} <= names


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "rla4mor_tpu." not in src.replace(
        "rla4mor_tpu_torch", "")
