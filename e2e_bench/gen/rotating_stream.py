"""The rotating scene as a long event stream, drawn from a seed.

Frozen copy of ``rotating_scene`` in ``chip_smoke.py`` (400 points turning
about the sensor centre, positions and polarities uniform, Gaussian jitter
of 0.2 px, 1 M draws a second), lengthened from 0.2 s to a stream of
``num_events`` in-frame events: the draws come in chunks of
``CHUNK_DRAWS`` consecutive in time, and events that leave the frame are
dropped as in the original. Pixel coordinates are floored to integers, as a
camera reports them. Host numpy only; the program under test never sees
this module, only the recording written from its output.
"""

from __future__ import annotations

import numpy as np

CHUNK_DRAWS = 1 << 21


def rotating_stream(seed: int, num_events: int, sensor=(180, 240),
                    omega: float = 1.2, points: int = 400,
                    draws_per_s: float = 1e6, jitter: float = 0.2):
    """``(xs int16, ys int16, ts float64, ps int8 in {-1, 1})`` of the first
    ``num_events`` in-frame events, time-sorted."""
    rng = np.random.default_rng(seed)
    H, W = sensor
    px = rng.uniform(10, W - 10, points)
    py = rng.uniform(10, H - 10, points)
    pol = rng.choice(np.array([-1, 1], np.int8), points)
    cx, cy = W / 2, H / 2
    out = {k: [] for k in ("x", "y", "t", "p")}
    have, t_chunk = 0, CHUNK_DRAWS / draws_per_s
    c = 0
    while have < num_events:
        idx = rng.integers(0, points, CHUNK_DRAWS)
        ts = c * t_chunk + np.sort(rng.uniform(0, t_chunk, CHUNK_DRAWS))
        ang = omega * ts
        rx = px[idx] - cx
        ry = py[idx] - cy
        ca, sa = np.cos(ang), np.sin(ang)
        xs = cx + ca * rx - sa * ry + rng.normal(0, jitter, CHUNK_DRAWS)
        ys = cy + sa * rx + ca * ry + rng.normal(0, jitter, CHUNK_DRAWS)
        keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        out["x"].append(np.floor(xs[keep]).astype(np.int16))
        out["y"].append(np.floor(ys[keep]).astype(np.int16))
        out["t"].append(ts[keep])
        out["p"].append(pol[idx][keep])
        have += int(keep.sum())
        c += 1
    return tuple(np.concatenate(out[k])[:num_events] for k in "xytp")
