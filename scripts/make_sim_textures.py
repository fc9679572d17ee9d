#!/usr/bin/env python3
"""Write the simulator textures that the port carries over from JAX.

    JAX_PLATFORMS=cpu python3 scripts/make_sim_textures.py

The JAX simulate CLI draws its scene texture from a threefry key
(``event_utils_tpu/cli/simulate.py:135-137``), which ``torch.Generator``
cannot reproduce. So the textures of the published recordings are data,
like the networks' weights: for each seed this writes

    smooth_texture(jax.random.split(jax.random.PRNGKey(seed))[0],
                   (128, 128), octaves=3)

as a float32 ``.npy`` into ``event_utils_tpu_torch/simulation/textures/``
(seed 91: the similarity recording of ``runs/flow128_similarity``; seed 77:
the translate recordings of ``runs/recon128v2``). The port loads them with
``simulation.load_texture`` and its simulate CLI with ``--texture``; it
never calls this script, which needs the JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (91, 77)
SHAPE = (128, 128)
OCTAVES = 3


def texture(seed, shape=SHAPE, octaves=OCTAVES) -> np.ndarray:
    """The JAX simulate CLI's texture for ``seed``, as float32 numpy."""
    import jax

    from event_utils_tpu.simulation.esim import smooth_texture
    tex_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(smooth_texture(tex_key, shape, octaves=octaves),
                      np.float32)


def main() -> int:
    sys.path.insert(0, ROOT)
    from event_utils_tpu_torch.simulation import texture_path
    for seed in SEEDS:
        path = texture_path(seed, SHAPE, OCTAVES)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, texture(seed))
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
