"""Command-line entry points of the port (run on the card unless
``--device cpu``):

- ``python -m event_utils_tpu_torch.cli.infer_flow``   EV-FlowNet inference
- ``python -m event_utils_tpu_torch.cli.reconstruct``  E2VID inference
- ``python -m event_utils_tpu_torch.cli.simulate``     ground-truth recordings
                                                     from the simulator
- ``python -m event_utils_tpu_torch.cli.eval_cmax``    ``grid_cmax_batched``
                                                     flow against ground truth
- ``python -m event_utils_tpu_torch.cli.train_flow``   EV-FlowNet training
                                                     (``--simulate``)
- ``python -m event_utils_tpu_torch.cli.train_reconstruction``  E2VID
                                                     training

The JAX package's other CLIs are not ported yet.
"""
