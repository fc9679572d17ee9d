"""Command-line entry points of the port (run on the card unless
``--device cpu``):

- ``python -m event_utils_tpu_torch.cli.infer_flow``   EV-FlowNet inference
- ``python -m event_utils_tpu_torch.cli.reconstruct``  E2VID inference
- ``python -m event_utils_tpu_torch.cli.simulate``     ground-truth recordings
                                                     from the simulator
- ``python -m event_utils_tpu_torch.cli.eval_cmax``    ``grid_cmax_batched``
                                                     flow against ground truth
- ``python -m event_utils_tpu_torch.cli.stream_flow``  streaming dense flow:
                                                     native ingest into
                                                     warm-started
                                                     ``grid_cmax_batched``
- ``python -m event_utils_tpu_torch.cli.train_flow``   EV-FlowNet training
                                                     (on a recording, or
                                                     ``--simulate``)
- ``python -m event_utils_tpu_torch.cli.train_reconstruction``  E2VID
                                                     training
- ``python -m event_utils_tpu_torch.cli.augment_demo`` augmentation figures
                                                     (needs matplotlib)
- ``python -m event_utils_tpu_torch.cli.cmax_demo``    every objective on an
                                                     event slice
- ``python -m event_utils_tpu_torch.cli.visualize``    dataset renders
                                                     through a visualizer
- ``python -m event_utils_tpu_torch.cli.visualize_events``  3-D event renders
- ``python -m event_utils_tpu_torch.cli.visualize_voxel``   3-D voxel renders
- ``python -m event_utils_tpu_torch.cli.visualize_flow``    events over dense
                                                     flow frames

Both trainers take ``--data_parallel`` (alone a world of one; under
``torchrun --nproc_per_node N``, N ranks). The data-format converters have
their ``main`` in ``data_formats`` (``txt_events``, ``h5_to_memmap``,
``memmap_to_h5``, ``rosbag_to_h5``, ``add_hdf5_attribute``).
"""
