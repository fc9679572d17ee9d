"""Synthetic spatiotemporal-plane illustration figures (port of
``event_utils_tpu.visualization.draw_plane``; reference
lib/visualization/utils/draw_plane.py and draw_plane_simple.py): events
scattered around an edge sweeping through the x-t-y volume, with its plane.

``plane_points`` draws the events (host numpy, the JAX package's draws);
``draw_plane_figure`` imports matplotlib to plot them.
"""

from __future__ import annotations

import os

import numpy as np

PLANE_H, PLANE_W, PLANE_T = 60, 80, 1.0


def plane_points(n_events: int = 600, velocity: float = 40.0,
                 noise: float = 1.0, seed: int = 0):
    """``(xs, ys, ts, ps)`` of an edge at ``x = 10 + velocity t`` over a
    60x80 sensor and 1 s, ``noise`` px of jitter in x, 75% positive."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, PLANE_T, n_events))
    edge_x = 10 + velocity * ts
    xs = edge_x + rng.normal(0, noise, n_events)
    ys = rng.uniform(0, PLANE_H, n_events)
    ps = rng.choice([-1.0, 1.0], n_events, p=[0.25, 0.75])
    return xs, ys, ts, ps


def draw_plane_figure(save_path=None, n_events: int = 600,
                      velocity: float = 40.0, noise: float = 1.0,
                      elev: float = 20, azim: float = 45, seed: int = 0,
                      show: bool = False, simple: bool = False):
    """Render the events of ``plane_points`` with the plane they lie on.

    @param simple If True, draw only the scatter (the draw_plane_simple
        variant); else include the translucent plane surface.
    @returns The matplotlib Axes3D.
    """
    import matplotlib.pyplot as plt

    xs, ys, ts, ps = plane_points(n_events, velocity, noise, seed)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d", proj_type="ortho")
    colors = np.where(ps > 0, "r", "b")
    ax.scatter(xs, ts, ys, zdir="z", c=colors, s=4, marker=".", linewidths=0)

    if not simple:
        gy, gt = np.meshgrid(np.linspace(0, PLANE_H, 8),
                             np.linspace(0, PLANE_T, 8))
        gx = 10 + velocity * gt
        ax.plot_surface(gx, gt, gy, alpha=0.25, color="gray")

    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("t")
    ax.set_zlabel("y")
    ax.set_xlim3d(0, PLANE_W)
    ax.set_ylim3d(0, PLANE_T)
    ax.set_zlim3d(0, PLANE_H)
    if save_path is not None:
        from ..utils.util import ensure_dir
        ensure_dir(os.path.dirname(save_path) or ".")
        plt.savefig(save_path, dpi=200, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return ax
