"""Inference surface of the trainers: ``FlowTrainer.predict`` and
``ReconstructionTrainer.reconstruct``, with weights loaded from a JAX
``params.npz`` (``convert.load_params_npz``). The train steps, optimisers
and checkpoint saving are not ported yet."""

from .loop import FlowTrainer  # noqa: F401
from .reconstruction import ReconstructionTrainer  # noqa: F401
