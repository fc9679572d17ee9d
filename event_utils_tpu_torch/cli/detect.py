"""Object detection CLI: RVT over a recording's stacked histograms.

Cuts an H5/memmap recording into windows of ``--t`` seconds (RVT's Gen4
setting: 0.05), builds each window's stacked histogram (``--num_bins``
time bins a polarity, coordinates halved as RVT halves Gen4's 1280x720,
counts clipped at 10; a chunk of ``--chunk`` windows in one batched call
on the dataset's device), pads it with zeros below and to the right to
multiples of 64, and runs the network window by window at batch 1, its
four LSTM states carried from window to window across chunks and starting
from zero at the recording's start. A streaming fetch hands the chunk it
built over on the card, with no copy to the host. Each window's decoded
predictions, ``(A, 5 + classes)`` rows ``[x, y, w, h, objectness,
classes...]`` in the padded input's pixels (box centre and size), come to
the host once a chunk and are written to ``predictions.npz``
(``predictions (N, A, 5 + classes)``, ``timestamps (N,)``: each window's
last event). Non-maximum suppression is left to the reader.

The network is the one ``--architecture`` names or the ``--params`` file's
``__model_json__`` does (``models.networks.DETECTION_MODELS``), its
weights loaded from ``--params`` strictly (without it, RVT-B with 3
classes at PyTorch's default initialisation: a pipeline check only). It
runs on the card unless ``--device cpu`` is passed.

Example (Gen4 1 Mpx recordings, as RVT reads them):
    python -m event_utils_tpu_torch.cli.detect rec_dir --architecture RVT \\
        --params params.npz --t 0.05 --num_bins 10 --output_dir out
"""

from __future__ import annotations

import argparse
import functools


#: the divisor of the event coordinates: RVT halves Gen4's 1280x720
DOWNSAMPLE = 2


def build_parser():
    parser = argparse.ArgumentParser(
        description="Detect objects in events with RVT")
    parser.add_argument("path", help="H5 file or memmap dir")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--params", default=None,
                        help="weights snapshot (.npz) in the port's "
                             "save_params_npz layout; its __model_json__ "
                             "names the network (omitted: PyTorch's default "
                             "initialisation, a pipeline check only)")
    parser.add_argument("--architecture", default=None, choices=["RVT"],
                        help="the network (default: the --params file's, "
                             "else RVT)")
    parser.add_argument("--t", type=float, default=0.05,
                        help="window seconds")
    parser.add_argument("--num_bins", type=int, default=10,
                        help="time bins a polarity")
    parser.add_argument("--chunk", type=int, default=8,
                        help="windows a fetch builds in one call (the state "
                             "is carried across chunks)")
    parser.add_argument("--no_window_cache", action="store_true",
                        help="disable the sidecar .npz window cache")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; raises "
                             "without a card) or 'cpu'")
    # windows of --t seconds alone; the window cache's key names the
    # method, the event count and the voxel grids' channel layout too
    parser.set_defaults(method="t_seconds", k=None, combined_channels=False)
    return parser


def _model_kwargs(args) -> dict:
    """The network's ``model_kwargs``: a ``--params`` file's own
    (``__model_json__``), else RVT-B with Gen4's 3 classes, as RVT trains
    it. An ``--architecture`` other than the file's raises
    ``SystemExit``."""
    if args.params:
        from ..convert import read_model_json_npz

        saved = read_model_json_npz(args.params)
        if args.architecture not in (None, saved.get("architecture")):
            raise SystemExit(f"{args.params} holds {saved}: --architecture "
                             "names another network")
        return saved
    return {"architecture": "RVT", "num_classes": 3}


def build_model(model_kwargs: dict, num_bins: int, device, params=None):
    """The detection network on ``device`` in eval mode, over ``2
    num_bins`` histogram channels, with ``params`` (a ``params.npz``)
    loaded strictly where given."""
    from ..convert import load_params_npz
    from ..models.networks import build_detector

    model = build_detector(model_kwargs, 2 * num_bins)
    if params:
        load_params_npz(model, params, model_kwargs)
    return model.to(device)


def padder(multiple: int):
    """The fetch's padding: zeros below and to the right up to sides that
    are multiples of ``multiple``."""
    from .reconstruct import _pad_to_multiple_hw

    return functools.partial(_pad_to_multiple_hw, multiple=multiple)


def main(argv=None):
    """Run the CLI; returns ``{"windows", "output_dir", "predictions"}``
    (the path of ``predictions.npz``)."""
    args = build_parser().parse_args(argv)

    import os

    import numpy as np

    from .._device import to_numpy
    from ..data_loaders import DynamicH5Dataset, MemMapDataset
    from .reconstruct import _voxel_method, _window_source

    model_kwargs = _model_kwargs(args)
    cls = MemMapDataset if os.path.isdir(args.path) else DynamicH5Dataset
    dataset = cls(args.path, voxel_method=_voxel_method(args),
                  num_bins=args.num_bins, return_events=False,
                  return_format="numpy", device=args.device,
                  representation="stacked_histogram",
                  downsample=DOWNSAMPLE)
    model = build_model(model_kwargs, args.num_bins, dataset.device,
                        args.params)
    if args.params:
        print(f"loaded weights {args.params}: {model_kwargs}")
    else:
        print("WARNING: no --params; detecting with random weights")

    os.makedirs(args.output_dir, exist_ok=True)
    n = len(dataset)
    fetch, stamps = _window_source(
        dataset, args, n, pad=padder(model.input_multiple),
        cache_suffix=".detcache.npz")
    preds, state = [], None
    for lo in range(0, n, args.chunk):
        hists, _ = fetch.on(dataset.device, lo, min(lo + args.chunk, n))
        boxes, _, state = model.detect(hists, state)
        preds.append(to_numpy(boxes))
    dataset.close()
    out = os.path.join(args.output_dir, "predictions.npz")
    np.savez(out, predictions=np.concatenate(preds),
             timestamps=np.asarray(stamps, np.float64))
    print(f"wrote {n} windows' predictions to {out}")
    return {"windows": n, "output_dir": args.output_dir, "predictions": out}


if __name__ == "__main__":
    main()
