"""The certified-bounds flows on the card, one at a time, timed.

Runs the flows of ``examples/large_scale_demo.py`` and
``examples/large_scale_parabolic_demo.py`` with their bounds at the sizes
``chip_smoke.py`` runs them, and the inf-sup fit alone at grid 511
(262,144 DoF), printing the card (``nvidia-smi`` name and power limit), each
flow's log and one JSON line of its readings::

    python -m rla4mor_tpu_torch.probes.bounds_probe --flows advection lossy
    python -m rla4mor_tpu_torch.probes.bounds_probe --flows infsup511

Flows: ``advection`` and ``nonaffine`` (grid 2048, 8 weak-greedy steps,
MG, SRHT k = 256, then the bounds), ``parabolic`` (grid 1024, nt 50, 5
extensions, SRHT k = 128, then the bound), ``helmholtz`` (grid 255, 4
steps, then the inf-sup fit and the Weyl auto-fit), ``lossy`` (grid 255,
the bounds-only flow, MG-BiCGStab), ``infsup511`` (``MatrixFreeScmInfSup`` on
``StencilHelmholtz(511)``, the demo's settings, fit over 8 draws to at most
6 anchors). ``--grid`` overrides the grid of the inf-sup flows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

FLOWS = ("advection", "nonaffine", "parabolic", "helmholtz", "lossy", "infsup511")


def _summary(b: dict) -> dict:
    """The JSON-able readings of a bounds dict."""
    out = {}
    for key, v in b.items():
        if key in ("scm", "coercivity", "fom", "mus"):
            continue
        if isinstance(v, np.ndarray):
            v = v.tolist()
        out[key] = v
    return out


def run_flow(flow: str, device, grid=None, log=print) -> dict:
    from rla4mor_tpu_torch.examples import large_scale_demo as demo

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if flow in ("advection", "nonaffine"):
        res = demo.run(grid=2048, steps=8, k=256, precond="mg", sketch="srht", device=device,
                       select="greedy", family=flow, bounds=True, log=log)
        out = _summary(res["bounds"])
    elif flow == "parabolic":
        from rla4mor_tpu_torch.examples import large_scale_parabolic_demo as para
        from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

        res = para.run(grid=1024, nt=50, ext=5, k=128, precond="mg", device=device,
                       embedding=lambda n, k: SrhtEmbedding(k, n, seed=0, device=device),
                       bounds=True, log=log)
        out = _summary(res["bounds"])
        out["held_out"] = [{k: row[k] for k in ("bound", "error_M", "effectivity", "rel_err")}
                           for row in res["held_out"]]
    elif flow == "helmholtz":
        res = demo.run(grid=grid or 255, steps=4, k=256, precond="mg", sketch="srht",
                       device=device, select="greedy", family="helmholtz", bounds=True,
                       log=log)
        out = _summary(res["bounds"])
    elif flow == "lossy":
        res = demo.run(grid=grid or 255, family="lossy", precond="mg", device=device,
                       log=log)
        out = _summary(res)
    elif flow == "infsup511":
        from rla4mor_tpu_torch.models import StencilHelmholtz
        from rla4mor_tpu_torch.mor.scm_matfree import MatrixFreeScmInfSup

        fom = StencilHelmholtz(grid or 511, device=device)
        mus = fom.sample_parameters(8, 1)
        t1 = time.perf_counter()
        scm = MatrixFreeScmInfSup(fom, **demo.INFSUP_SCM)
        hist = scm.fit(mus, tol=demo.INFSUP_FIT_TOL, max_anchors=demo.INFSUP_MAX_ANCHORS)
        torch.cuda.synchronize()
        out = {"n": fom.n_nodes ** 2, "fit_s": time.perf_counter() - t1, "fit_history": hist,
               "certified": scm.certified, "diagnostics": scm.anchor_diagnostics,
               "lower": scm.tabulate(mus).tolist()}
        log(f"inf-sup fit at n = {out['n']}: {out['fit_s']:.1f}s, "
            f"{len(scm.scm.anchor_mus)} anchors, certified={scm.certified}; "
            f"{demo.defenses(scm.anchor_diagnostics)}")
    else:
        raise ValueError(f"unknown flow {flow!r}")
    torch.cuda.synchronize()
    out.update(flow=flow, wall_s=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flows", nargs="+", choices=FLOWS, default=list(FLOWS[:5]))
    ap.add_argument("--grid", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bounds_probe needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    from rla4mor_tpu_torch.utils.config import resolve_device

    device = resolve_device("cuda:0")
    torch.zeros(1, device=device)  # the context, before the memory statistics
    for flow in args.flows:
        torch.cuda.reset_peak_memory_stats(device)
        out = run_flow(flow, device, args.grid,
                       log=lambda line, f=flow: print(f"[{f}] {line}", flush=True))
        print(json.dumps(out, default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
