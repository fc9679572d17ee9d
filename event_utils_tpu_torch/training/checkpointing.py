"""Weights snapshots and resumable checkpoints of the trainers (port of
``event_utils_tpu.training.checkpointing``).

- ``save_params_npz`` writes the JAX package's flat ``params.npz`` layout
  (one array per flax tree path, HWIO kernels, plus ``__step__`` and the
  ``__model_json__`` architecture sidecar) from the trainer's deliverable
  weights (the EMA when it keeps one), atomically. The JAX package's
  ``load_params_npz`` reads it, and ``load_params_npz`` here reads both
  packages' files: this is the format the two share. The sidecar holds
  the trainer's ``model_kwargs``, its ``"architecture"`` key included, so
  a file of the port's ``UNetRecurrent`` or ``ERAFT`` (which the JAX
  package cannot load) rebuilds that network, ERAFT's batch norms with
  their running statistics (``convert.state_to_flax_params``).
- ``save_trainer_checkpoint`` / ``restore_trainer_checkpoint`` replace
  orbax, which the card's machine lacks, with the port's own format: one
  ``step_<N>.pt`` per step under ``ckpt_dir`` (a ``torch.save`` of
  ``{step, model, optimizer, ema}``), written atomically; a second save of
  the same step does nothing, as with orbax. Non-default architectures are
  recorded once in JAX's ``model.json`` sidecar (``read_model_config``).
  The JAX package cannot read these files, nor the port orbax's.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from ..convert import load_flax_params, read_model_json_npz, \
    state_to_flax_params
from ..errors import DataFormatError, DataNotFoundError

__all__ = ["load_params_npz", "read_model_config", "read_model_json_npz",
           "restore_trainer_checkpoint", "save_params_npz",
           "save_trainer_checkpoint", "write_params_npz"]

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def save_params_npz(trainer, path: str) -> None:
    """Write the trainer's deliverable weights (``inference_params``: the
    EMA when enabled) as a flat ``.npz`` keyed by flax tree path, with
    ``__step__`` and ``__model_json__``; atomic (temp file, then
    ``os.replace``)."""
    write_params_npz(trainer.inference_params, path, trainer.model_kwargs,
                     trainer.step)


def write_params_npz(state, path: str, model_kwargs=None,
                     step: int = 0) -> None:
    """``save_params_npz`` of a state dict: a network with no trainer (the
    detectors of ``cli/detect.py``) writes its weights this way."""
    arrays = state_to_flax_params(state)
    arrays["__step__"] = np.asarray(int(step), np.int64)
    arrays["__model_json__"] = np.frombuffer(
        json.dumps(model_kwargs or {}).encode(), np.uint8)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_params_npz(trainer, path: str) -> int:
    """Restore weights saved by ``save_params_npz`` (either package's) into
    ``trainer``: the optimiser starts afresh and the EMA (when enabled) is
    re-seeded from the loaded weights, as in JAX. The file's
    ``__model_json__`` must equal the trainer's ``model_kwargs``. Returns
    the saved step, which becomes the trainer's."""
    with np.load(path) as z:
        saved = (json.loads(bytes(z["__model_json__"]).decode())
                 if "__model_json__" in z else {})
        have = dict(trainer.model_kwargs or {})
        if saved != have:
            raise DataFormatError(
                f"params file was saved for model_kwargs={saved}, trainer "
                f"has {have}")
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
        step = int(z["__step__"]) if "__step__" in z else 0
    load_flax_params(trainer.model, flat)
    trainer.opt.reset()
    if hasattr(trainer, "reset_ema"):
        trainer.reset_ema()
    trainer.step = step
    return step


def read_model_config(ckpt_dir: str) -> dict:
    """Model kwargs recorded by ``save_trainer_checkpoint`` (``{}`` for
    default-architecture checkpoints, which write no sidecar)."""
    path = os.path.join(os.path.abspath(ckpt_dir), "model.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return dict(json.load(f).get("model_kwargs", {}))


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(ckpt_dir)) if m)


def save_trainer_checkpoint(trainer, ckpt_dir: str) -> None:
    """Save model, optimiser, EMA and step at ``trainer.step`` as
    ``ckpt_dir/step_<N>.pt``; an existing step is left as it is."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    if trainer.model_kwargs:
        path = os.path.join(ckpt_dir, "model.json")
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump({"model_kwargs": trainer.model_kwargs}, f)
    path = os.path.join(ckpt_dir, f"step_{int(trainer.step)}.pt")
    if os.path.exists(path):
        return
    ema = getattr(trainer, "ema_model", None)
    state = {"step": int(trainer.step),
             "model": trainer.model.state_dict(),
             "optimizer": trainer.optimizer.state_dict(),
             "ema": ema.state_dict() if ema is not None else None}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_trainer_checkpoint(trainer, ckpt_dir: str,
                               step: Optional[int] = None) -> int:
    """Restore model, optimiser, EMA and step from ``ckpt_dir`` (the
    latest step unless ``step`` is given); returns the step."""
    steps = _steps(ckpt_dir)
    if step is None:
        if not steps:
            raise DataNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    elif step not in steps:
        raise DataNotFoundError(f"no checkpoint of step {step} under "
                                f"{ckpt_dir} (have {steps})")
    state = torch.load(os.path.join(ckpt_dir, f"step_{step}.pt"),
                       map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    ema = getattr(trainer, "ema_model", None)
    if ema is not None:
        if state["ema"] is None:
            trainer.reset_ema()
        else:
            ema.load_state_dict(state["ema"])
    trainer.step = int(state["step"])
    return trainer.step
