"""State estimation / inverse problems: recovery maps.

Counterpart of ``rla4mor_tpu/estim/recovery_map.py``: recover a full state
u from m linear observations w = W^H R u.

* PBDW: the (m + nv) saddle system [[G, CG], [CG^H, 0]] [eta; v] = [w; 0],
  then u = V v + W eta, for all observation columns in one solve.
* Dictionary recovery: the LASSO-LARS path over the cross-gramian
  dictionary, the observation-space correction of every path point, and the
  path point nearest the solution manifold. :meth:`DicRecoveryMap.compute_state_batched`
  does this for all columns in one batched call: the JAX package's
  ``jax.jit(jax.vmap(...))`` program (and its cache) is here a plain
  function of batched tensors.

Bases are column matrices V (n, nv), W (n, m); gramian G = W^H R W (m, m),
cross-gramian CG = W^H R V (m, nv).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.estim.lars import (
    lars_weighted_path,
    lars_weighted_path_complex,
    lars_weighted_path_complex_jax,
    lars_weighted_path_group,
    lars_weighted_path_group_jax,
    lars_weighted_path_jax,
)
from rla4mor_tpu_torch.estim.manifold_distance import ManifoldDistance
from rla4mor_tpu_torch.utils.logger import get_logger


class RecoveryMap:
    def __init__(self, V, W, gramian=None, cross_gramian=None,
                 product: Optional[Product] = None,
                 manifold_distance: Optional[ManifoldDistance] = None,
                 log_level: int = 20):
        self.V = torch.as_tensor(V)
        self.W = torch.as_tensor(W).to(self.V.device)
        n = self.V.shape[0]
        self.product = product if product is not None else Product.identity(n)
        if gramian is None:
            gramian = self.product.inner(self.W, self.W)
        if cross_gramian is None:
            cross_gramian = self.product.inner(self.W, self.V)
        self.gramian = torch.as_tensor(gramian).to(self.V.device)
        self.cross_gramian = torch.as_tensor(cross_gramian).to(self.V.device)
        self.manifold_distance = manifold_distance
        self.logger = get_logger("estim.recovery", log_level)

    # -- core ------------------------------------------------------------------
    def compute_state(self, w, **kwargs):
        raise NotImplementedError

    def compute_correction(self, w, v):
        """eta = G^-1 (w - CG v), for v (nv, p) or a batch (..., nv, p)."""
        w = torch.as_tensor(w)
        v = torch.as_tensor(v)
        dt = torch.promote_types(torch.promote_types(w.dtype, v.dtype), self.gramian.dtype)
        return torch.linalg.solve(self.gramian.to(dt),
                                  w.to(dt) - self.cross_gramian.to(dt) @ v.to(dt))

    def solve(self, w, correct: bool = True, **kwargs):
        """Recover states u = V v (+ W eta); w is (m,) or (m, k)."""
        w = torch.as_tensor(w).to(self.V.device)
        single = w.dim() == 1
        wm = w[:, None] if single else w
        v = self.compute_state(wm, **kwargs)
        dt = torch.promote_types(self.V.dtype, v.dtype)
        u = self.V.to(dt) @ v.to(dt)
        if correct:
            eta = self.compute_correction(wm, v)
            u = u + self.W.to(eta.dtype) @ eta
        return u[:, 0] if single else u

    # -- restrictions (convergence studies) -----------------------------------
    def _replace(self, **kw):
        out = object.__new__(type(self))
        out.__dict__.update(self.__dict__)
        out.__dict__.update(kw)
        return out

    def project_background(self, indices):
        """Restrict the background basis V to the columns ``indices``."""
        indices = torch.as_tensor(indices, device=self.V.device)
        kw = dict(V=self.V[:, indices], cross_gramian=self.cross_gramian[:, indices])
        if self.manifold_distance is not None:
            nv, m = self.V.shape[1], self.W.shape[1]
            ind = torch.cat([indices, nv + torch.arange(m, device=indices.device)])
            kw["manifold_distance"] = self.manifold_distance.project(ind)
        return self._replace(**kw)

    def project_observation(self, indices):
        """Restrict the observation basis W to the columns ``indices``."""
        indices = torch.as_tensor(indices, device=self.V.device)
        kw = dict(W=self.W[:, indices],
                  gramian=self.gramian[indices][:, indices],
                  cross_gramian=self.cross_gramian[indices, :])
        if self.manifold_distance is not None:
            nv = self.V.shape[1]
            ind = torch.cat([torch.arange(nv, device=indices.device), nv + indices])
            kw["manifold_distance"] = self.manifold_distance.project(ind)
        return self._replace(**kw)


class PbdwRecoveryMap(RecoveryMap):
    """Parametrised-background data-weak recovery (saddle-point solve)."""

    def compute_state(self, w, **kwargs):
        w = torch.as_tensor(w).to(self.gramian.device)
        m, nv = self.W.shape[1], self.V.shape[1]
        G, CG = self.gramian, self.cross_gramian
        A = torch.cat([torch.cat([G, CG], dim=1),
                       torch.cat([CG.conj().T, G.new_zeros((nv, nv))], dim=1)], dim=0)
        b = torch.cat([w, w.new_zeros((nv, w.shape[1]))], dim=0)
        dt = torch.promote_types(A.dtype, b.dtype)
        return torch.linalg.solve(A.to(dt), b.to(dt))[m:, :]


class DicRecoveryMap(RecoveryMap):
    """Dictionary-based multi-space recovery with LARS sparse selection."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # an R-orthonormal observation basis is required, to a tolerance of
        # the working dtype
        G = self.gramian
        eps = torch.finfo(G.real.dtype if G.is_complex() else G.dtype).eps
        tol = max(1e-8, 1e3 * eps)
        eye = torch.eye(self.W.shape[1], dtype=G.dtype, device=G.device)
        if not bool(((G - eye).abs() <= tol).all()):
            raise ValueError("DicRecoveryMap requires an R-orthonormal observation basis W")
        md = self.manifold_distance
        if md is not None and self.V.shape[1] + self.W.shape[1] != md.lhs.source_dim:
            raise ValueError("manifold distance does not act on [V, W] coefficients")

    def _resolve_max_steps(self, max_steps):
        """None -> enough fixed-shape homotopy steps to cover the whole host
        path: LASSO add/drop oscillations take about 5x the dictionary size,
        so 6 K + 16, K doubled for a real-stacked complex dictionary."""
        if max_steps is not None:
            return int(max_steps)
        K = self.cross_gramian.shape[1]
        if self.cross_gramian.is_complex():
            K *= 2
        return 6 * K + 16

    def _lars_fn(self, is_complex: bool, complex_mode: str):
        if complex_mode not in ("group", "stacked"):
            raise ValueError(f"complex_mode {complex_mode!r}")
        if not is_complex:
            return lars_weighted_path_jax
        return (lars_weighted_path_group_jax if complex_mode == "group"
                else lars_weighted_path_complex_jax)

    # -- path machinery ---------------------------------------------------------
    def compute_state_path(self, w, alpha=0.0, weights=None, scale=1e3, ols=True,
                           return_path=True, solver="jax", max_steps=None,
                           complex_mode="group", **kwargs):
        """LARS path of dictionary coefficients (K, P) and its alphas.

        ``solver="jax"`` (the default) is the fixed-shape device path
        (``max_steps`` points, the converged tail repeated); ``"np"`` the
        exact variable-length host path, kept as the oracle. A complex
        problem takes the rotation-invariant complex homotopy
        (``complex_mode="group"``) or the real-stacking reduction
        (``"stacked"``)."""
        w = torch.as_tensor(w).to(self.cross_gramian.device)
        is_complex = self.cross_gramian.is_complex() or w.is_complex()
        fn = self._lars_fn(is_complex, complex_mode)
        if solver == "jax":
            v, alphas, _ = fn(self.cross_gramian, w, alpha, weights, scale, ols,
                              self._resolve_max_steps(max_steps))
            return v, alphas
        fn = (lars_weighted_path if not is_complex
              else lars_weighted_path_group if complex_mode == "group"
              else lars_weighted_path_complex)
        v, alphas = fn(self.cross_gramian.cpu().numpy(), w.cpu().numpy(), alpha, weights,
                       scale, ols, return_path, **kwargs)
        dev = self.cross_gramian.device
        return torch.as_tensor(v).to(dev), torch.as_tensor(alphas).to(dev)

    def compute_correction_path(self, w, v):
        """Corrections of every path point (v (nv, P) for one w (m,))."""
        w = torch.as_tensor(w).reshape(-1, 1)
        return self.compute_correction(w.expand(-1, v.shape[-1]), v)

    def _state_single(self, w, **kwargs):
        v, _ = self.compute_state_path(w, **kwargs)
        eta = self.compute_correction_path(w, v)
        coefs = torch.cat([v, eta], dim=0)
        distances, _ = self.manifold_distance.evaluate(coefs)
        return v[:, int(np.argmin(distances))]

    def lars_paths(self, w_batch, alpha=0.0, weights=None, scale=1e3, ols=True,
                   max_steps=None, complex_mode="group"):
        """The device LARS paths of all columns of w (m, s), one batched
        call: ``(v (s, K, P), steps (s,))``, each column's homotopy steps and
        its path up to the longest column's last step (after its own last
        step a column repeats its last point, as the fixed-shape path does
        up to ``max_steps``)."""
        w = torch.as_tensor(w_batch).to(self.cross_gramian.device)
        is_complex = self.cross_gramian.is_complex() or w.is_complex()
        fn = self._lars_fn(is_complex, complex_mode)
        v, _, steps = fn(self.cross_gramian, w.T, alpha, weights, scale, bool(ols),
                         self._resolve_max_steps(max_steps))
        return v[..., :max(1, int(steps.max()))], steps

    def select(self, w_batch, paths):
        """The point of each column's path nearest the manifold -> (nv, s):
        the corrections and manifold distances of every path point and the
        argmin, each one batched call over the columns. ``paths`` is
        :meth:`lars_paths`' v. The argmin takes the first of equal
        distances, so a path's repeated tail never moves the choice."""
        md = self.manifold_distance
        if md is None:
            raise ValueError("batched recovery needs a manifold distance")
        w = torch.as_tensor(w_batch).to(paths.device)
        eta = self.compute_correction(w.T[:, :, None], paths)        # (s, m, P)
        d = md.distances(torch.cat([paths, eta.to(paths.dtype)], dim=1))  # (s, P)
        pick = d.argmin(dim=1)
        return paths.gather(2, pick[:, None, None].expand(-1, paths.shape[1], 1))[:, :, 0].T

    def compute_state_batched(self, w_batch, alpha=0.0, weights=None, scale=1e3,
                              ols=True, max_steps=None, complex_mode="group"):
        """All columns of w (m, s) at once -> (nv, s): :meth:`lars_paths`,
        then :meth:`select`. ``last_steps`` keeps the homotopy steps each
        column took."""
        paths, self.last_steps = self.lars_paths(w_batch, alpha, weights, scale, ols,
                                                 max_steps, complex_mode)
        return self.select(w_batch, paths)

    def compute_state(self, w, solver="jax", **kwargs):
        w = torch.as_tensor(w)
        batched_kw = {"alpha", "weights", "scale", "ols", "max_steps", "complex_mode"}
        md = self.manifold_distance
        # the batched path needs md.distances (a subclass with only the host
        # evaluate() goes column by column)
        md_batchable = (md is not None
                        and type(md).distances is not ManifoldDistance.distances)
        if solver == "jax" and set(kwargs) <= batched_kw and md_batchable:
            return self.compute_state_batched(w, **kwargs)
        cols = [self._state_single(w[:, i], solver=solver, **kwargs)
                for i in range(w.shape[1])]
        return torch.stack(cols, dim=1)

    def solve_path(self, w, path=None, **kwargs):
        """All recoveries along the path (n, P) and their manifold
        distances (P,); ``last_path_coefs`` keeps the path's coefficients
        [v; eta] (nv + m, P). ``path`` (K, P), w's path from
        :meth:`lars_paths`, is used instead of computing it anew."""
        w = torch.as_tensor(w).to(self.cross_gramian.device)
        if w.dim() != 1:
            raise ValueError("solve_path takes one observation vector")
        v = self.compute_state_path(w, **kwargs)[0] if path is None else path
        eta = self.compute_correction_path(w, v)
        dt = torch.promote_types(self.V.dtype, v.dtype)
        u = self.V.to(dt) @ v.to(dt) + self.W.to(dt) @ eta.to(dt)
        self.last_path_coefs = torch.cat([v, eta.to(v.dtype)], dim=0)
        distances, _ = self.manifold_distance.evaluate(self.last_path_coefs)
        return u, distances
