"""BFGS with a strong-Wolfe line search, in plain torch.

A port of ``jax.scipy.optimize.minimize(method="BFGS")`` (JAX's
``_src/scipy/optimize/bfgs.py`` and ``line_search.py``; Wright and Nocedal,
'Numerical Optimization', algorithms 6.1, 3.5 and 3.6), which torch does
not have. The iterations, the zoom's cubic/quadratic/bisection choice, the
step-size floor of 1e-8, the failure thresholds and the float32 arithmetic
are JAX's, so the two solvers walk the same path up to rounding. JAX's
``while_loop`` bodies become Python loops: a body that sets ``failed``
still runs to its end, as it does under ``lax.while_loop``.

The solver state is a handful of float32 scalars and ``(d,)``/``(d, d)``
tensors on the host; only ``value_and_grad`` touches the device, once per
evaluation. TF32 is off for the whole solve (``_device.no_tf32``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .._device import no_tf32

_F32 = torch.float32
Tensor = torch.Tensor


def _s(v) -> Tensor:
    """A float32 scalar tensor on the host."""
    return torch.as_tensor(v, dtype=_F32)


class BFGSResults(NamedTuple):
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
    failed: bool
    nfev: int
    a_k: Tensor
    f_k: Tensor
    g_k: Tensor
    status: int


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = torch.stack([torch.stack([dc ** 2, -db ** 2]),
                      torch.stack([-dc ** 3, db ** 3])])
    d2 = torch.stack([fb - fa - C * db, fc - fa - C * dc])
    A, B = (d1 @ d2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


def _zoom(restricted, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo,
          a_hi, phi_hi, dphi_hi, g_0):
    """Zoom (algorithm 3.6): cubic, then quadratic, then bisection."""
    done = failed = False
    j = nfev = 0
    a_rec = (a_lo + a_hi) / 2.0
    phi_rec = (phi_lo + phi_hi) / 2.0
    a_star, phi_star, dphi_star, g_star = _s(1.0), phi_lo, dphi_lo, g_0
    delta1, delta2 = 0.2, 0.1
    threshold = 1e-5  # float32 (JAX uses 1e-10 only for 64-bit)
    while not done and not failed:
        dalpha = a_hi - a_lo
        a = torch.minimum(a_hi, a_lo)
        b = torch.maximum(a_hi, a_lo)
        cchk = delta1 * dalpha
        qchk = delta2 * dalpha
        failed = failed or bool(dalpha <= threshold)

        a_j_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                              phi_rec)
        use_cubic = (j > 0 and bool(a_j_cubic > a + cchk)
                     and bool(a_j_cubic < b - cchk))
        a_j_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = (not use_cubic and bool(a_j_quad > a + qchk)
                    and bool(a_j_quad < b - qchk))
        if use_cubic:
            a_j = a_j_cubic
        elif use_quad:
            a_j = a_j_quad
        else:
            a_j = (a_lo + a_hi) / 2.0

        phi_j, dphi_j, g_j = restricted(a_j)
        nfev += 1

        hi_to_j = bool(wolfe_one(a_j, phi_j)) or bool(phi_j >= phi_lo)
        star_to_j = bool(wolfe_two(dphi_j)) and not hi_to_j
        hi_to_lo = (bool(dphi_j * (a_hi - a_lo) >= 0.0) and not hi_to_j
                    and not star_to_j)
        lo_to_j = not hi_to_j and not star_to_j

        if hi_to_j:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_j, phi_j, dphi_j
        if star_to_j:
            done = True
            a_star, phi_star, dphi_star, g_star = a_j, phi_j, dphi_j, g_j
        if hi_to_lo:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
        if lo_to_j and not hi_to_lo:
            a_rec, phi_rec = a_lo, phi_lo
        if lo_to_j:
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= 30
    return failed, nfev, a_star, phi_star, dphi_star, g_star


def line_search(value_and_grad, xk, pk, old_fval, old_old_fval, gfk,
                c1: float = 1e-4, c2: float = 0.9,
                maxiter: int = 20) -> _LineSearchResults:
    """Inexact line search satisfying the strong Wolfe conditions
    (algorithm 3.5), starting from JAX's initial step."""

    def restricted(t):
        phi, g = value_and_grad(xk + _s(t) * pk)
        return phi, torch.dot(g, pk), g

    phi_0 = old_fval
    dphi_0 = torch.dot(gfk, pk)
    cand = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
    start_value = torch.where(cand > 1, _s(1.0), cand)

    def wolfe_one(a_i, phi_i):  # negation of W1
        return phi_i > phi_0 + c1 * a_i * dphi_0

    def wolfe_two(dphi_i):
        return torch.abs(dphi_i) <= -c2 * dphi_0

    done = failed = False
    i = 1
    nfev = 0
    a_i1, phi_i1, dphi_i1 = _s(0.0), phi_0, dphi_0
    a_star, phi_star, g_star = _s(0.0), phi_0, gfk
    while not done and i <= maxiter and not failed:
        a_i = start_value if i == 1 else a_i1 * 2.0
        phi_i, dphi_i, g_i = restricted(a_i)
        nfev += 1

        star_to_zoom1 = (bool(wolfe_one(a_i, phi_i))
                         or (bool(phi_i >= phi_i1) and i > 1))
        star_to_i = bool(wolfe_two(dphi_i)) and not star_to_zoom1
        star_to_zoom2 = (bool(dphi_i >= 0.0) and not star_to_zoom1
                         and not star_to_i)
        if star_to_zoom1:
            z = _zoom(restricted, wolfe_one, wolfe_two, a_i1, phi_i1, dphi_i1,
                      a_i, phi_i, dphi_i, gfk)
        elif star_to_zoom2:
            z = _zoom(restricted, wolfe_one, wolfe_two, a_i, phi_i, dphi_i,
                      a_i1, phi_i1, dphi_i1, gfk)
        if star_to_zoom1 or star_to_zoom2:
            z_failed, z_nfev, a_star, phi_star, _, g_star = z
            nfev += z_nfev
            done = True
            failed = failed or z_failed
        elif star_to_i:
            done = True
            a_star, phi_star, g_star = a_i, phi_i, g_i
        i += 1
        a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i

    status = 1 if failed else (3 if i > maxiter else 0)
    # step sizes below 1e-8 stall float32 BFGS: floor them (JAX does too)
    alpha_k = a_star
    if bool(torch.abs(alpha_k) < 1e-8):
        alpha_k = torch.sign(alpha_k) * 1e-8
    return _LineSearchResults(failed=failed or not done, nfev=nfev,
                              a_k=alpha_k, f_k=phi_star,
                              g_k=g_star, status=status)


def minimize_bfgs(value_and_grad: Callable[[Tensor], Tuple[Tensor, Tensor]],
                  x0, maxiter: Optional[int] = None,
                  gtol: float = 1e-5) -> BFGSResults:
    """Minimize with BFGS (algorithm 6.1).

    ``value_and_grad(x)`` takes a float32 ``(d,)`` host tensor and returns
    the loss (0-dim) and its gradient ``(d,)`` as float32 host tensors.
    Stops when ``max|g| < gtol``, when the line search fails (at most
    10 steps per search), or after ``maxiter`` iterations (default
    ``200*d``) — JAX's defaults.
    """
    x0 = torch.as_tensor(x0, dtype=_F32).detach().cpu()
    d = x0.shape[0]
    if maxiter is None:
        maxiter = d * 200
    eye = torch.eye(d, dtype=_F32)
    with no_tf32():
        f_k, g_k = value_and_grad(x0)
        converged = bool(torch.linalg.vector_norm(g_k, ord=math.inf) < gtol)
        failed = False
        k, nfev = 0, 1
        x_k, H_k = x0, eye
        old_old_fval = f_k + torch.linalg.vector_norm(g_k) / 2
        ls_status = 0
        while not converged and not failed and k < maxiter:
            p_k = -(H_k @ g_k)
            ls = line_search(value_and_grad, x_k, p_k, old_fval=f_k,
                             old_old_fval=old_old_fval, gfk=g_k,
                             maxiter=10)
            nfev += ls.nfev
            failed = ls.failed
            ls_status = ls.status
            s_k = ls.a_k * p_k
            x_kp1 = x_k + s_k
            y_k = ls.g_k - g_k
            rho_k = torch.reciprocal(torch.dot(y_k, s_k))
            w = eye - rho_k * (s_k[:, None] * y_k[None, :])
            H_kp1 = w @ H_k @ w.T + rho_k * (s_k[:, None] * s_k[None, :])
            if bool(torch.isfinite(rho_k)):
                H_k = H_kp1
            converged = bool(torch.linalg.vector_norm(ls.g_k, ord=math.inf)
                             < gtol)
            old_old_fval = f_k
            k += 1
            x_k, f_k, g_k = x_kp1, ls.f_k, ls.g_k
    if converged:
        status = 0
    elif k == maxiter:
        status = 1
    else:
        status = 2 + ls_status if failed else -1
    return BFGSResults(converged=converged, failed=failed, k=k, nfev=nfev,
                       x_k=x_k, f_k=f_k, g_k=g_k, status=status,
                       line_search_status=ls_status)
