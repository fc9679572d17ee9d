"""RVT's stacked histogram: per-polarity event counts in equal time bins.

Gehrig and Scaramuzza, CVPR 2023 (github.com/uzh-rpg/RVT
``data/utils/representations.py``, ``StackedHistogram``): a window's
stamps are normed to ``t_norm = (t - t_first) / max(t_last - t_first,
MIN_SPAN_S) * bins`` over its own first and last stamp; an event falls
in bin ``min(floor(t_norm), bins - 1)`` of channel ``p bins + bin``
(``p`` 0 for a negative event and 1 for a positive one: polarity-major);
coordinates are divided by ``downsample`` (RVT halves Gen4's 1280x720);
counts are clipped at ``COUNT_CUTOFF`` and returned as float32. An event
of polarity 0 (the padding of ``pack_windows`` and the placeholder of an
empty window) counts nothing.

``stacked_histogram_rows`` builds every row's histogram in one call: one
flat scatter of ones (the CUDA flat kernel on the card, ``impl='pallas'``,
its plain version on the CPU) with ids offset by row, then one clamp.
Stamps are float32 seconds, as ``pack_windows`` packs them.
"""

from __future__ import annotations

import torch

from ..ops.scatter import scatter_add_flat

#: RVT's least window span, 1 microsecond, in seconds
MIN_SPAN_S = 1e-6
#: counts a cell holds at most (RVT's ``count_cutoff`` for Gen1 and Gen4)
COUNT_CUTOFF = 10


def histogram_shape(bins: int, sensor_size, downsample: int = 1):
    """``(2 bins, ceil(H / d), ceil(W / d))`` of one window's histogram."""
    H, W = sensor_size
    return (2 * bins, -(-H // downsample), -(-W // downsample))


def stacked_histogram_rows(xs, ys, ts, ps, bins: int, sensor_size,
                           downsample: int = 1,
                           impl: str = "pallas") -> torch.Tensor:
    """Stacked histograms of S rows of events: ``(S, 2 bins, ceil(H / d),
    ceil(W / d))`` float32, row s over its own first and last stamp.
    ``xs``, ``ys``, ``ts``, ``ps`` are ``(S, N)`` tensors on one device,
    time-sorted within a row; events outside the ``sensor_size`` are
    dropped before the division."""
    C, Hd, Wd = histogram_shape(bins, sensor_size, downsample)
    H, W = sensor_size
    S = xs.shape[0]
    ts = ts.to(torch.float32)
    span = torch.clamp(ts[:, -1:] - ts[:, :1], min=MIN_SPAN_S)
    b = torch.floor((ts - ts[:, :1]) / span * bins).clamp(max=bins - 1)
    ix = torch.trunc(xs.to(torch.float32)).long()
    iy = torch.trunc(ys.to(torch.float32)).long()
    ok = ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (ps != 0)
          & (b >= 0))
    ch = (ps > 0).long() * bins + b.long()
    row = torch.arange(S, device=xs.device)[:, None]
    ids = ((row * C + ch) * Hd + iy // downsample) * Wd + ix // downsample
    ids = torch.where(ok, ids, -1).reshape(-1)
    counts = scatter_add_flat(ids, torch.ones(ids.shape, device=ids.device),
                              S * C * Hd * Wd, impl=impl)
    return counts.clamp_(max=COUNT_CUTOFF).view(S, C, Hd, Wd)


def stacked_histogram(xs, ys, ts, ps, bins: int, sensor_size,
                      downsample: int = 1,
                      impl: str = "pallas") -> torch.Tensor:
    """One window's stacked histogram, ``(2 bins, ceil(H / d), ceil(W /
    d))``: ``stacked_histogram_rows`` of one row. ``(N,)`` tensors on one
    device."""
    return stacked_histogram_rows(
        xs[None], ys[None], ts[None], ps[None], bins, sensor_size,
        downsample, impl)[0]
