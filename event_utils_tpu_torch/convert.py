"""Carry state across from the JAX package.

- Contrast maximisation has no learned weights: its state is the warp
  model and the objective with their knobs. ``warp_from_jax`` and
  ``objective_from_jax`` build the port's counterpart of a JAX instance by
  reading its class name and its knobs — duck typing only.
- The learned models' weights: ``load_params_npz`` reads a ``params.npz``
  written by the JAX package's ``training.checkpointing.save_params_npz``
  (one array per flax tree path, plus ``__step__`` and
  ``__model_json__``) into the port's ``EVFlowNet`` / ``E2VID``;
  ``state_to_flax_params`` is the inverse of ``convert_flax_params``, with
  which the port's trainers write the same layout. The same layout carries
  the port's ``UNetRecurrent``, whose parameter paths (rpg_e2vid's names,
  ``['params']['encoders']['0']['recurrent_block']['Gates']['kernel']``)
  have no flax counterpart; its ``__model_json__`` holds
  ``"architecture": "UNetRecurrent"``, so a load rebuilds it. Batch norms
  (E-RAFT's context encoder) are stored as flax stores them: scale and
  shift under ``['params'][...]['scale' | 'bias']``, running statistics
  under ``['batch_stats'][...]['mean' | 'var']``; the step counter
  ``num_batches_tracked`` is not stored, and a load keeps the model's own.
  The RVT detector's linear layers are stored as flax's ``Dense``
  (``kernel`` ``(in, out)``, the transpose of ``nn.Linear``'s weight),
  its LayerNorms as norms (``scale``, ``bias``) and its LayerScales under
  their own leaf, ``gamma``.

Nothing of the JAX package is imported.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .errors import DataFormatError, RegistryError
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


# ---------------------------------------------------------------------------
# Learned weights: flax params.npz -> nn.Module
# ---------------------------------------------------------------------------

_PATH_PART = re.compile(r"\['([^'\]]+)'\]")
_META_KEYS = ("__step__", "__model_json__")


# (flax collection, flax leaf) -> the port's leaf
_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
           ("params", "scale"): "weight", ("params", "gamma"): "gamma",
           ("batch_stats", "mean"): "running_mean",
           ("batch_stats", "var"): "running_var"}
# a norm's step counter: not a weight, not stored
_UNSTORED = "num_batches_tracked"


def flax_key_to_name(key: str) -> Tuple[str, bool]:
    """``"['params']['_Encoder_0']['Conv_1']['kernel']"`` ->
    ``("_Encoder_0.Conv_1.weight", True)``; the flag says the array is a
    kernel (HWIO or a dense ``(in, out)``, to be transposed). The port's
    modules register their submodules under flax's own auto-names
    (``models.networks``), so the path carries over part for part; only
    the leaf is renamed (a norm's ``scale`` to ``weight``, its
    ``batch_stats`` ``mean`` and ``var`` to ``running_mean`` and
    ``running_var``)."""
    parts = _PATH_PART.findall(key)
    if (len(parts) < 3 or "".join(f"['{p}']" for p in parts) != key
            or (parts[0], parts[-1]) not in _LEAVES):
        raise DataFormatError(f"not a flax conv or norm parameter path: "
                              f"{key!r}")
    leaf = _LEAVES[(parts[0], parts[-1])]
    return ".".join(parts[1:-1] + [leaf]), parts[-1] == "kernel"


def convert_flax_params(flat: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """Flat flax parameters (``jax.tree_util.keystr`` path -> array) as a
    state dict of the port's modules: kernels HWIO -> OIHW
    (``permute(3, 2, 0, 1)``), dense kernels ``(in, out)`` -> ``(out,
    in)``, biases unchanged, float32."""
    out = {}
    for key, arr in flat.items():
        name, is_kernel = flax_key_to_name(key)
        if name in out:
            raise DataFormatError(f"{key}: a second array for {name}")
        t = torch.tensor(np.asarray(arr, np.float32))
        if is_kernel:
            if t.dim() not in (2, 4):
                raise DataFormatError(
                    f"{key}: a kernel must be 4-D HWIO or a 2-D dense "
                    f"(in, out), got {tuple(t.shape)}")
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
        out[name] = t.contiguous()
    return out


def state_to_flax_params(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_flax_params``: a state dict of the port's
    modules as flat flax parameters (``"_Encoder_0.Conv_1.weight"`` ->
    ``"['params']['_Encoder_0']['Conv_1']['kernel']"``), kernels OIHW ->
    HWIO, linear weights ``(out, in)`` -> dense kernels ``(in, out)``,
    float32 host arrays; a norm's 1-D weight is its ``scale``, its
    running statistics go under ``['batch_stats']`` and its
    ``num_batches_tracked`` is left out."""
    out = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        if leaf == _UNSTORED and path:
            continue
        arr = t.detach().to("cpu", torch.float32)
        if leaf == "weight" and arr.dim() == 4:
            arr, collection, flax_leaf = (arr.permute(2, 3, 1, 0), "params",
                                          "kernel")
        elif leaf == "weight" and arr.dim() == 2:
            arr, collection, flax_leaf = arr.t(), "params", "kernel"
        elif leaf == "weight" and arr.dim() == 1:
            collection, flax_leaf = "params", "scale"
        elif leaf in ("bias", "gamma"):
            collection, flax_leaf = "params", leaf
        elif leaf in ("running_mean", "running_var"):
            collection, flax_leaf = "batch_stats", leaf[8:]
        else:
            raise DataFormatError(
                f"not a conv, linear or norm parameter: {name!r} of shape "
                f"{tuple(arr.shape)} (a conv weight is 4-D OIHW, a linear "
                f"one 2-D)")
        if not path:
            raise DataFormatError(f"not a module parameter name: {name!r}")
        key = "".join(f"['{p}']" for p in [collection] + path + [flax_leaf])
        out[key] = np.ascontiguousarray(arr.numpy())
    return out


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray]
                     ) -> nn.Module:
    """Load flat flax parameters into ``model`` (on its device).

    Raises ``DataFormatError`` on a parameter the model has and the file
    lacks, on one the file has and the model lacks, and on a shape
    mismatch — a partial load never happens."""
    state = convert_flax_params(flat)
    have = model.state_dict()
    kept = {k: v for k, v in have.items() if k.rsplit(".", 1)[-1] == _UNSTORED}
    missing = sorted(set(have) - set(state) - set(kept))
    surplus = sorted(set(state) - set(have))
    if missing or surplus:
        raise DataFormatError(
            f"params do not fit {type(model).__name__}: missing {missing}, "
            f"surplus {surplus}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(have[name].shape):
            raise DataFormatError(
                f"{name}: saved shape {tuple(t.shape)} != model "
                f"{tuple(have[name].shape)}")
    model.load_state_dict({**kept, **state})
    return model


def read_model_json_npz(path: str) -> dict:
    """The ``__model_json__`` architecture sidecar of a ``params.npz``
    (``{}`` for snapshots that predate it)."""
    with np.load(path) as z:
        if "__model_json__" not in z:
            return {}
        return json.loads(bytes(z["__model_json__"]).decode())


def load_params_npz(model: nn.Module, path: str,
                    model_kwargs: Optional[dict] = None) -> int:
    """Load a JAX ``params.npz`` into ``model``; returns its ``__step__``.

    ``model_kwargs``, when given, must equal the snapshot's
    ``__model_json__`` (the architecture the weights were saved for), as
    the JAX package's ``load_params_npz`` requires."""
    with np.load(path) as z:
        saved = (json.loads(bytes(z["__model_json__"]).decode())
                 if "__model_json__" in z else {})
        if model_kwargs is not None and saved != dict(model_kwargs):
            raise DataFormatError(
                f"params file was saved for model_kwargs={saved}, "
                f"model has {dict(model_kwargs)}")
        flat = {k: z[k] for k in z.files if k not in _META_KEYS}
        step = int(z["__step__"]) if "__step__" in z else 0
    load_flax_params(model, flat)
    return step
