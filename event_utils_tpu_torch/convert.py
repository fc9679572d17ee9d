"""Carry the contrast-maximisation state across from the JAX package.

This path has no learned weights: its state is the warp model and the
objective with their knobs. ``warp_from_jax`` and ``objective_from_jax``
build the port's counterpart of a JAX instance by reading its class name
and its knobs — duck typing only, nothing of the JAX package is imported.
"""

from __future__ import annotations

from .errors import RegistryError
from .models import objectives, warps

# the knobs the JAX optimizers key their compiled losses on, plus the
# adaptive-lifespan state and the default blur
OBJECTIVE_KNOBS = ("thresh", "p", "div", "adaptive_lifespan",
                   "minimum_events", "pixel_crossings", "default_blur")


def warp_from_jax(w) -> warps.warp_function:
    """The port's warp of the same class as the JAX warp ``w``."""
    cls = getattr(warps, type(w).__name__, None)
    if not (isinstance(cls, type) and issubclass(cls, warps.warp_function)):
        raise RegistryError(f"no port of warp class {type(w).__name__!r}")
    return cls()


def objective_from_jax(obj) -> objectives.objective_function:
    """The port's objective of the same class as the JAX objective ``obj``,
    with its knobs copied."""
    cls = getattr(objectives, type(obj).__name__, None)
    if not (isinstance(cls, type)
            and issubclass(cls, objectives.objective_function)):
        raise RegistryError(
            f"no port of objective class {type(obj).__name__!r}")
    out = cls()
    for knob in OBJECTIVE_KNOBS:
        if hasattr(obj, knob):
            setattr(out, knob, getattr(obj, knob))
    return out
