"""Training runtime: the trainers' steps, the simulated training loops, and
weights snapshots and checkpoints (port of ``event_utils_tpu.training``)."""

from .in_the_loop import (simulate_flow_batch,  # noqa: F401
                          simulate_recon_batch,
                          train_flow_in_the_loop,
                          train_reconstruction_in_the_loop)
from .loop import FlowTrainer, cosine_decay_schedule  # noqa: F401
from .reconstruction import ReconstructionTrainer  # noqa: F401
