"""BFGS with a strong-Wolfe line search, in plain torch, over a batch of
independent problems.

A port of ``jax.scipy.optimize.minimize(method="BFGS")`` (JAX's
``_src/scipy/optimize/bfgs.py`` and ``line_search.py``; Wright and Nocedal,
'Numerical Optimization', algorithms 6.1, 3.5 and 3.6), which torch does
not have, as JAX runs it under ``jax.vmap``: the ROI solvers minimise R
problems at once. The iterations, the zoom's cubic/quadratic/bisection
choice, the step-size floor of 1e-8, the failure thresholds and the float32
arithmetic are JAX's, so the two solvers walk the same path up to rounding.

The state holds one row per problem: (R,) scalars, (R, d) vectors and
(R, d, d) inverse Hessians, on the device of ``x0``. Each of JAX's
``lax.while_loop``s (the BFGS iterations, the line search's steps, the
zoom's steps) becomes a loop that runs while any row's own condition holds:
the body is computed for every row, and a row whose condition has ended
keeps its state (``torch.where``), as a batched ``while_loop`` does. So a
row that has converged or failed freezes its ``x_k``, ``f_k``, ``g_k``, ``k``
and status, and every row ends where it would end alone. Branches become
``torch.where`` over both sides. Each loop iteration reads one boolean from
the device, its all-done test; nothing else crosses to the host. JAX's two
zooms per line-search step (one per bracket orientation, each a no-op for
the rows that do not take it) run as one zoom here: a row takes at most one
of them. TF32 is off for the whole solve (``_device.no_tf32``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .._device import no_tf32

_F32 = torch.float32
Tensor = torch.Tensor


class BFGSResults(NamedTuple):
    """Python numbers and (d,) tensors for a (d,) problem; (R,) and (R, d)
    tensors for R rows."""
    converged: bool
    failed: bool
    k: int              # iterations
    nfev: int           # value-and-gradient evaluations
    x_k: Tensor
    f_k: Tensor
    g_k: Tensor
    status: int         # 0 converged, 1 maxiter, 2+ls status line search
    line_search_status: int


class _LineSearchResults(NamedTuple):
    failed: Tensor
    nfev: Tensor
    a_k: Tensor
    f_k: Tensor
    g_k: Tensor
    status: Tensor


class _ZoomResults(NamedTuple):
    failed: Tensor
    nfev: Tensor
    a_star: Tensor
    phi_star: Tensor
    dphi_star: Tensor
    g_star: Tensor


def _where(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """``torch.where`` of (R,) ``cond`` over (R, ...) rows."""
    return torch.where(cond.view(cond.shape + (1,) * (a.dim() - 1)), a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc ** 2 * r0 - db ** 2 * r1) / denom
    B = (-dc ** 3 * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


def _zoom(restricted, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo,
          a_hi, phi_hi, dphi_hi, g_0, pass_through) -> _ZoomResults:
    """Zoom (algorithm 3.6): cubic, then quadratic, then bisection. Rows
    with ``pass_through`` do not zoom."""
    done = torch.zeros_like(pass_through)
    failed = torch.zeros_like(pass_through)
    j = torch.zeros(a_lo.shape, dtype=torch.int64, device=a_lo.device)
    nfev = torch.zeros_like(j)
    a_rec = (a_lo + a_hi) / 2.0
    phi_rec = (phi_lo + phi_hi) / 2.0
    a_star, phi_star, dphi_star, g_star = (torch.ones_like(a_lo), phi_lo,
                                           dphi_lo, g_0)
    delta1, delta2 = 0.2, 0.1
    threshold = 1e-5  # float32 (JAX uses 1e-10 only for 64-bit)
    while True:
        live = ~done & ~pass_through & ~failed
        if not bool(live.any()):
            break
        dalpha = a_hi - a_lo
        a = torch.minimum(a_hi, a_lo)
        b = torch.maximum(a_hi, a_lo)
        cchk = delta1 * dalpha
        qchk = delta2 * dalpha
        failed_j = failed | (dalpha <= threshold)

        a_j_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                              phi_rec)
        use_cubic = (j > 0) & (a_j_cubic > a + cchk) & (a_j_cubic < b - cchk)
        a_j_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = ~use_cubic & (a_j_quad > a + qchk) & (a_j_quad < b - qchk)
        a_j = torch.where(use_cubic, a_j_cubic,
                          torch.where(use_quad, a_j_quad,
                                      (a_lo + a_hi) / 2.0))

        phi_j, dphi_j, g_j = restricted(a_j, live)

        hi_to_j = wolfe_one(a_j, phi_j) | (phi_j >= phi_lo)
        star_to_j = wolfe_two(dphi_j) & ~hi_to_j
        hi_to_lo = ((dphi_j * (a_hi - a_lo) >= 0.0) & ~hi_to_j
                    & ~star_to_j)
        lo_to_j = ~hi_to_j & ~star_to_j

        # JAX's chain of replacements, in its order
        n_a_rec = torch.where(hi_to_j, a_hi, a_rec)
        n_phi_rec = torch.where(hi_to_j, phi_hi, phi_rec)
        n_a_hi = torch.where(hi_to_j, a_j, a_hi)
        n_phi_hi = torch.where(hi_to_j, phi_j, phi_hi)
        n_dphi_hi = torch.where(hi_to_j, dphi_j, dphi_hi)
        n_done = done | star_to_j
        n_a_star = torch.where(star_to_j, a_j, a_star)
        n_phi_star = torch.where(star_to_j, phi_j, phi_star)
        n_dphi_star = torch.where(star_to_j, dphi_j, dphi_star)
        n_g_star = _where(star_to_j, g_j, g_star)
        n_a_rec = torch.where(hi_to_lo, n_a_hi, n_a_rec)
        n_phi_rec = torch.where(hi_to_lo, n_phi_hi, n_phi_rec)
        n_a_hi = torch.where(hi_to_lo, a_lo, n_a_hi)
        n_phi_hi = torch.where(hi_to_lo, phi_lo, n_phi_hi)
        n_dphi_hi = torch.where(hi_to_lo, dphi_lo, n_dphi_hi)
        rec_lo = lo_to_j & ~hi_to_lo
        n_a_rec = torch.where(rec_lo, a_lo, n_a_rec)
        n_phi_rec = torch.where(rec_lo, phi_lo, n_phi_rec)
        n_a_lo = torch.where(lo_to_j, a_j, a_lo)
        n_phi_lo = torch.where(lo_to_j, phi_j, phi_lo)
        n_dphi_lo = torch.where(lo_to_j, dphi_j, dphi_lo)
        n_j = j + 1
        n_failed = failed_j | (n_j >= 30)

        # rows that were not live keep their state
        done = torch.where(live, n_done, done)
        failed = torch.where(live, n_failed, failed)
        j = torch.where(live, n_j, j)
        nfev = torch.where(live, nfev + 1, nfev)
        a_lo = torch.where(live, n_a_lo, a_lo)
        phi_lo = torch.where(live, n_phi_lo, phi_lo)
        dphi_lo = torch.where(live, n_dphi_lo, dphi_lo)
        a_hi = torch.where(live, n_a_hi, a_hi)
        phi_hi = torch.where(live, n_phi_hi, phi_hi)
        dphi_hi = torch.where(live, n_dphi_hi, dphi_hi)
        a_rec = torch.where(live, n_a_rec, a_rec)
        phi_rec = torch.where(live, n_phi_rec, phi_rec)
        a_star = torch.where(live, n_a_star, a_star)
        phi_star = torch.where(live, n_phi_star, phi_star)
        dphi_star = torch.where(live, n_dphi_star, dphi_star)
        g_star = _where(live, n_g_star, g_star)
    return _ZoomResults(failed, nfev, a_star, phi_star, dphi_star, g_star)


def line_search(value_and_grad, xk, pk, old_fval, old_old_fval, gfk,
                active: Tensor, c1: float = 1e-4, c2: float = 0.9,
                maxiter: int = 20) -> _LineSearchResults:
    """Inexact line search satisfying the strong Wolfe conditions
    (algorithm 3.5), starting from JAX's initial step, for every row of
    ``xk`` (R, d) along ``pk`` (R, d). Rows where ``active`` (R,) is False
    do not search (they report a failed search)."""
    R = xk.shape[0]

    def restricted(t, live):
        x = _where(live, xk + t[:, None] * pk, xk)
        phi, g = value_and_grad(x)
        phi = phi.to(_F32)
        g = g.to(_F32)
        return phi, (g * pk).sum(-1), g

    phi_0 = old_fval
    dphi_0 = (gfk * pk).sum(-1)
    cand = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
    start_value = torch.where(cand > 1, torch.ones_like(cand), cand)

    def wolfe_one(a_i, phi_i):  # negation of W1
        return phi_i > phi_0 + c1 * a_i * dphi_0

    def wolfe_two(dphi_i):
        return torch.abs(dphi_i) <= -c2 * dphi_0

    done = torch.zeros_like(active)
    failed = torch.zeros_like(active)
    i = torch.ones(R, dtype=torch.int64, device=xk.device)
    nfev = torch.zeros_like(i)
    a_i1, phi_i1, dphi_i1 = torch.zeros_like(phi_0), phi_0, dphi_0
    a_star, phi_star, dphi_star, g_star = (torch.zeros_like(phi_0), phi_0,
                                           dphi_0, gfk)
    while True:
        live = active & ~done & (i <= maxiter) & ~failed
        if not bool(live.any()):
            break
        a_i = torch.where(i == 1, start_value, a_i1 * 2.0)
        phi_i, dphi_i, g_i = restricted(a_i, live)

        star_to_zoom1 = (wolfe_one(a_i, phi_i)
                         | ((phi_i >= phi_i1) & (i > 1)))
        star_to_i = wolfe_two(dphi_i) & ~star_to_zoom1
        star_to_zoom2 = (dphi_i >= 0.0) & ~star_to_zoom1 & ~star_to_i
        # zoom1 brackets (a_i1, a_i), zoom2 (a_i, a_i1)
        z1 = star_to_zoom1
        zoomed = star_to_zoom1 | star_to_zoom2
        z = _zoom(restricted, wolfe_one, wolfe_two,
                  torch.where(z1, a_i1, a_i), torch.where(z1, phi_i1, phi_i),
                  torch.where(z1, dphi_i1, dphi_i),
                  torch.where(z1, a_i, a_i1), torch.where(z1, phi_i, phi_i1),
                  torch.where(z1, dphi_i, dphi_i1), gfk,
                  ~(live & zoomed))

        n_done = done | zoomed | star_to_i
        n_failed = failed | (zoomed & z.failed)
        n_a_star = torch.where(zoomed, z.a_star,
                               torch.where(star_to_i, a_i, a_star))
        n_phi_star = torch.where(zoomed, z.phi_star,
                                 torch.where(star_to_i, phi_i, phi_star))
        n_dphi_star = torch.where(zoomed, z.dphi_star,
                                  torch.where(star_to_i, dphi_i, dphi_star))
        n_g_star = _where(zoomed, z.g_star, _where(star_to_i, g_i, g_star))

        done = torch.where(live, n_done, done)
        failed = torch.where(live, n_failed, failed)
        nfev = torch.where(live, nfev + 1 + z.nfev, nfev)
        a_star = torch.where(live, n_a_star, a_star)
        phi_star = torch.where(live, n_phi_star, phi_star)
        dphi_star = torch.where(live, n_dphi_star, dphi_star)
        g_star = _where(live, n_g_star, g_star)
        i = torch.where(live, i + 1, i)
        a_i1 = torch.where(live, a_i, a_i1)
        phi_i1 = torch.where(live, phi_i, phi_i1)
        dphi_i1 = torch.where(live, dphi_i, dphi_i1)

    status = torch.where(failed, 1, torch.where(i > maxiter, 3, 0))
    # step sizes below 1e-8 stall float32 BFGS: floor them (JAX does too)
    alpha_k = torch.where(torch.abs(a_star) < 1e-8,
                          torch.sign(a_star) * 1e-8, a_star)
    return _LineSearchResults(failed=failed | ~done, nfev=nfev, a_k=alpha_k,
                              f_k=phi_star, g_k=g_star, status=status)


def minimize_bfgs(value_and_grad: Callable[[Tensor], Tuple[Tensor, Tensor]],
                  x0, maxiter: Optional[int] = None,
                  gtol: float = 1e-5) -> BFGSResults:
    """Minimize with BFGS (algorithm 6.1), every row of ``x0`` its own
    problem.

    ``x0`` is (R, d): ``value_and_grad(X)`` takes float32 (R, d) rows on
    ``x0``'s device and returns their losses (R,) and gradients (R, d)
    there, a row's loss depending on that row alone; the results are (R,)
    and (R, d) tensors. ``x0`` (d,) is one problem: ``value_and_grad(x)``
    takes (d,) and returns a 0-dim loss and a (d,) gradient, and the
    results are Python numbers and (d,) tensors. Each row stops when
    ``max|g| < gtol``, when its line search fails (at most 10 steps per
    search), or after ``maxiter`` iterations (default ``200*d``) — JAX's
    defaults.
    """
    x0 = torch.as_tensor(x0, dtype=_F32).detach()
    single = x0.dim() == 1
    if single:
        vg_one = value_and_grad

        def value_and_grad(x):
            f, g = vg_one(x[0])
            return f.reshape(1), g[None]

        x0 = x0[None]
    R, d = x0.shape
    if maxiter is None:
        maxiter = d * 200
    eye = torch.eye(d, dtype=_F32, device=x0.device)
    with no_tf32():
        f_k, g_k = value_and_grad(x0)
        f_k = f_k.to(_F32)
        g_k = g_k.to(_F32)
        converged = g_k.abs().amax(-1) < gtol
        failed = torch.zeros_like(converged)
        k = torch.zeros(R, dtype=torch.int64, device=x0.device)
        nfev = torch.ones_like(k)
        ls_status = torch.zeros_like(k)
        x_k, H_k = x0, eye.expand(R, d, d)
        old_old_fval = f_k + torch.linalg.vector_norm(g_k, dim=-1) / 2
        while True:
            active = ~converged & ~failed & (k < maxiter)
            if not bool(active.any()):
                break
            p_k = -(H_k @ g_k[:, :, None])[:, :, 0]
            ls = line_search(value_and_grad, x_k, p_k, old_fval=f_k,
                             old_old_fval=old_old_fval, gfk=g_k,
                             active=active, maxiter=10)
            s_k = ls.a_k[:, None] * p_k
            x_kp1 = x_k + s_k
            y_k = ls.g_k - g_k
            rho_k = torch.reciprocal((y_k * s_k).sum(-1))
            rho = rho_k[:, None, None]
            w = eye - rho * (s_k[:, :, None] * y_k[:, None, :])
            H_kp1 = (w @ H_k @ w.transpose(-1, -2)
                     + rho * (s_k[:, :, None] * s_k[:, None, :]))
            H_kp1 = _where(torch.isfinite(rho_k), H_kp1, H_k)
            conv = ls.g_k.abs().amax(-1) < gtol

            # a row whose loop has ended keeps its state
            nfev = torch.where(active, nfev + ls.nfev, nfev)
            failed = torch.where(active, ls.failed, failed)
            ls_status = torch.where(active, ls.status, ls_status)
            converged = torch.where(active, conv, converged)
            old_old_fval = torch.where(active, f_k, old_old_fval)
            k = torch.where(active, k + 1, k)
            x_k = _where(active, x_kp1, x_k)
            f_k = torch.where(active, ls.f_k, f_k)
            g_k = _where(active, ls.g_k, g_k)
            H_k = _where(active, H_kp1, H_k)
    status = torch.where(converged, 0, torch.where(
        k == maxiter, 1, torch.where(failed, 2 + ls_status, -1)))
    if single:
        return BFGSResults(
            converged=bool(converged[0]), failed=bool(failed[0]),
            k=int(k[0]), nfev=int(nfev[0]), x_k=x_k[0], f_k=f_k[0],
            g_k=g_k[0], status=int(status[0]),
            line_search_status=int(ls_status[0]))
    return BFGSResults(converged=converged, failed=failed, k=k, nfev=nfev,
                       x_k=x_k, f_k=f_k, g_k=g_k, status=status,
                       line_search_status=ls_status)
