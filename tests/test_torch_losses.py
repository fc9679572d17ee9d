"""Parity of the port's training losses against the JAX package, on the CPU.

``contrast_flow_loss`` (value and gradient in the flow, B = 2 at 32x32),
``perceptual_distance`` and ``reconstruction_loss`` (value and gradient in
the prediction), and the perceptual filters the port carries over as data,
which must equal JAX's threefry draws bit for bit. JAX runs its default
'xla' scatter, the route its trainers take (its flat Pallas kernel has no
VJP). Tolerance: 1e-5 of the value's or the gradient's scale (f32 sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_utils_tpu.models import networks as jnet
from event_utils_tpu_torch.errors import ConfigurationError
from event_utils_tpu_torch.models import networks as pnet
from event_utils_tpu_torch.ops import get_default_impl, set_default_impl

REL = 1e-5
H, W = 32, 32


def assert_rel(got, ref, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, scale)


def flow_batch(seed, mask_mode):
    """Flow (2, 2, H, W) and padded events (2, N, 4) with their mask."""
    g = np.random.default_rng(seed)
    B, N = 2, 600
    xs = g.uniform(0, W - 1, (B, N))
    ys = g.uniform(0, H - 1, (B, N))
    ts = np.sort(g.uniform(0, 0.1, (B, N)), axis=1)
    ps = g.choice([-1.0, 1.0], (B, N))
    events = np.stack([xs, ys, ts, ps], -1).astype(np.float32)
    mask = (g.uniform(size=(B, N)) < 0.85).astype(np.float32)
    if mask_mode == "one_empty":
        mask[1] = 0.0
    elif mask_mode == "all_masked":
        mask[:] = 0.0
    flow = (g.normal(size=(B, 2, H, W)) * 20.0).astype(np.float32)
    return flow, events, mask


@pytest.mark.parametrize("mask_mode", ["partial", "one_empty", "all_masked"])
@pytest.mark.parametrize("smoothness", [0.5, 0.0])
def test_contrast_flow_loss_value_and_gradient_match_jax(mask_mode,
                                                         smoothness):
    flow, events, mask = flow_batch(1, mask_mode)

    def jloss(f):
        return jnet.contrast_flow_loss(f, jnp.asarray(events),
                                       jnp.asarray(mask), (H, W),
                                       smoothness_weight=smoothness)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(flow))
    f = torch.tensor(flow, requires_grad=True)
    val = pnet.contrast_flow_loss(f, torch.tensor(events), torch.tensor(mask),
                                  (H, W), smoothness_weight=smoothness)
    val.backward()
    val = float(val.detach())
    assert abs(val - float(jval)) <= REL * max(abs(float(jval)), 1e-6)
    assert_rel(f.grad, jgrad)
    if mask_mode == "all_masked" and not smoothness:
        assert val == 0.0 and not f.grad.abs().any()


def test_contrast_flow_loss_kernel_route_matches_exact_route_on_the_cpu():
    """Under 'pallas' the splat goes to the flat kernel's wrapper, which
    runs its plain version for CPU tensors: the same loss and gradient."""
    flow, events, mask = flow_batch(2, "partial")
    out = {}
    prev = get_default_impl()
    try:
        for impl in ("xla", "pallas"):
            set_default_impl(impl)
            f = torch.tensor(flow, requires_grad=True)
            val = pnet.contrast_flow_loss(f, torch.tensor(events),
                                          torch.tensor(mask), (H, W))
            val.backward()
            out[impl] = (float(val.detach()), f.grad)
    finally:
        set_default_impl(prev)
    assert abs(out["xla"][0] - out["pallas"][0]) <= REL * abs(out["xla"][0])
    assert_rel(out["pallas"][1], out["xla"][1].numpy())


def test_perceptual_filters_are_jax_draws_bit_for_bit():
    filters = pnet.perceptual_filters()
    key = jax.random.PRNGKey(0)
    in_ch = 1
    for lvl, w in enumerate(filters):
        key, sub = jax.random.split(key)
        ref = jax.random.normal(sub, (16, in_ch, 3, 3), jnp.float32)
        ref = np.asarray(ref / jnp.sqrt(9.0 * in_ch))
        assert w.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), ref)
        in_ch = 16
    with pytest.raises(ConfigurationError):
        pnet.perceptual_filters(levels=2)


def images(seed, shape=(2, 1, H, W)):
    g = np.random.default_rng(seed)
    return (g.uniform(size=shape).astype(np.float32),
            g.uniform(size=shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 1, 32, 32), (1, 1, 24, 40)])
def test_perceptual_distance_value_and_gradient_match_jax(shape):
    pred, target = images(3, shape)
    jval, jgrad = jax.value_and_grad(
        lambda p: jnet.perceptual_distance(p, jnp.asarray(target)))(
            jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    val = pnet.perceptual_distance(p, torch.tensor(target))
    val.backward()
    assert abs(float(val.detach()) - float(jval)) <= REL * abs(float(jval))
    assert_rel(p.grad, jgrad)


@pytest.mark.parametrize("lpips,mse", [(0.0, 0.0), (0.1, 0.0), (0.0, 4.0),
                                       (0.1, 4.0)])
def test_reconstruction_loss_value_and_gradient_match_jax(lpips, mse):
    pred, target = images(4)
    jval, jgrad = jax.value_and_grad(
        lambda p: jnet.reconstruction_loss(p, jnp.asarray(target),
                                           lpips_weight=lpips,
                                           mse_weight=mse))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    filters = pnet.perceptual_filters() if lpips else None
    val = pnet.reconstruction_loss(p, torch.tensor(target), lpips_weight=lpips,
                                   mse_weight=mse, filters=filters)
    val.backward()
    assert abs(float(val.detach()) - float(jval)) <= REL * abs(float(jval))
    assert_rel(p.grad, jgrad)
