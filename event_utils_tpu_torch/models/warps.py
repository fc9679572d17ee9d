"""Parametric motion (warp) models (port of ``event_utils_tpu.models.warps``).

Each model is a pure function ``warp_fn(params, xs, ys, ts, t0) -> (x', y')``
on tensors — differentiable by autograd, and ``torch.func.jacfwd`` derives
the Jacobians a subclass does not write out — wrapped in a small class with
``name``/``dims`` and the reference's ``warp(xs, ys, ts, ps, t0, params,
compute_grad)`` signature.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Tuple

import torch

from .._device import as_f32, pick_device
from ..errors import RegistryError


class warp_function(ABC):
    """Base class of parametric, differentiable event warps."""

    def __init__(self, name: str, dims: int):
        self.name = name
        self.dims = dims

    @abstractmethod
    def warp_fn(self, params, xs, ys, ts, t0) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """Events at ``ts`` moved to reference time ``t0`` under motion
        ``params``. Returns ``(x', y')``."""

    def jacobian(self, params, xs, ys, ts, t0):
        """Per-event Jacobians d(x')/d(params), d(y')/d(params), each
        ``(dims, N)``. Derived with ``torch.func.jacfwd`` unless a subclass
        writes out the analytic form."""
        params = params.to(torch.float32)
        jx = torch.func.jacfwd(
            lambda p: self.warp_fn(p, xs, ys, ts, t0)[0])(params)  # (N, dims)
        jy = torch.func.jacfwd(
            lambda p: self.warp_fn(p, xs, ys, ts, t0)[1])(params)
        return jx.T, jy.T

    def warp(self, xs, ys, ts, ps, t0, params, compute_grad: bool = False,
             device=None):
        """Reference-compatible entry (warps.py:22-42): returns
        ``(x', y', jacobian_x, jacobian_y)`` (Jacobians None unless
        ``compute_grad``)."""
        del ps
        dev = pick_device(xs, ys, ts, params, device=device)
        xs = as_f32(xs, dev)
        ys = as_f32(ys, dev)
        ts = as_f32(ts, dev)
        params = as_f32(params, dev).to(dev)  # a small vector follows events
        if isinstance(t0, torch.Tensor):
            t0 = t0.to(device=dev, dtype=torch.float32)
        xw, yw = self.warp_fn(params, xs, ys, ts, t0)
        jx, jy = (None, None)
        if compute_grad:
            jx, jy = self.jacobian(params, xs, ys, ts, t0)
        return xw, yw, jx, jy


class linvel_warp(warp_function):
    """Linear-velocity (global optic flow) warp, 2 DoF (warps.py:44-61):
    ``x' = x - (t - t0) * vx``, ``y' = y - (t - t0) * vy``."""

    def __init__(self):
        super().__init__("linvel_warp", 2)

    def warp_fn(self, params, xs, ys, ts, t0):
        dt = ts - t0
        return xs - dt * params[0], ys - dt * params[1]

    def jacobian(self, params, xs, ys, ts, t0):
        # dx'/dvx = -(t - t0); dy'/dvy = -(t - t0)
        dt = ts - t0
        zeros = torch.zeros_like(dt)
        return torch.stack([-dt, zeros]), torch.stack([zeros, -dt])


class xyztheta_warp(warp_function):
    """4-DoF translation + scale + rotation warp, linearized about the image
    origin, params (vx, vy, s, w)::

        x' = x - dt * (vx + s*x - w*y)
        y' = y - dt * (vy + s*y + w*x)
    """

    def __init__(self):
        super().__init__("xyztheta_warp", 4)

    def warp_fn(self, params, xs, ys, ts, t0):
        dt = ts - t0
        vx, vy, s, w = params[0], params[1], params[2], params[3]
        return (xs - dt * (vx + s * xs - w * ys),
                ys - dt * (vy + s * ys + w * xs))

    def jacobian(self, params, xs, ys, ts, t0):
        dt = ts - t0
        zeros = torch.zeros_like(dt)
        jx = torch.stack([-dt, zeros, -dt * xs, dt * ys])
        jy = torch.stack([zeros, -dt, -dt * ys, -dt * xs])
        return jx, jy


class pure_rotation_warp(warp_function):
    """Pure-rotation warp, params (cx, cy, w): each event is rotated about
    (cx, cy) by the angle accumulated since t0::

        a  = w * (t - t0)
        x' = cx + cos(a)(x - cx) + sin(a)(y - cy)
        y' = cy - sin(a)(x - cx) + cos(a)(y - cy)
    """

    def __init__(self):
        super().__init__("pure_rotation_warp", 3)

    def warp_fn(self, params, xs, ys, ts, t0):
        cx, cy, w = params[0], params[1], params[2]
        a = w * (ts - t0)
        ca, sa = torch.cos(a), torch.sin(a)
        rx = xs - cx
        ry = ys - cy
        return cx + ca * rx + sa * ry, cy - sa * rx + ca * ry


def linvel_warp_fn(params, xs, ys, ts, t0):
    dt = ts - t0
    return xs - dt * params[0], ys - dt * params[1]


WARP_REGISTRY = {
    "linvel": linvel_warp,
    "linvel_warp": linvel_warp,
    "xyztheta": xyztheta_warp,
    "xyztheta_warp": xyztheta_warp,
    "pure_rotation": pure_rotation_warp,
    "pure_rotation_warp": pure_rotation_warp,
}


def get_warp(name: str) -> warp_function:
    """Explicit registry lookup."""
    try:
        return WARP_REGISTRY[name]()
    except KeyError:
        raise RegistryError(
            f"Unknown warp model {name!r}; have {sorted(WARP_REGISTRY)}")
