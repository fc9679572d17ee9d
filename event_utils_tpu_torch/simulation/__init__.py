"""Event-camera simulation (ESIM-style) on the card: ground-truth data
generation, with the JAX package's textures carried over as data
(``textures/``, written by ``scripts/make_sim_textures.py``)."""

from .esim import (Scene, SimulatedEvents, SimulatorConfig, affine_scene,
                   hot_pixel_map, load_texture, rotating_scene,
                   simulate_events, simulate_events_device,
                   simulate_events_device_batch, simulate_scene,
                   smooth_texture, texture_path, translating_scene)

__all__ = [
    "Scene", "SimulatedEvents", "SimulatorConfig", "affine_scene",
    "hot_pixel_map", "load_texture", "rotating_scene", "simulate_events",
    "simulate_events_device", "simulate_events_device_batch",
    "simulate_scene", "smooth_texture",
    "texture_path", "translating_scene",
]
