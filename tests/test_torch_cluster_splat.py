"""The ROI solves' two splats after the cluster design was measured, on the
CPU.

Private copies summed across a thread-block cluster through distributed
shared memory lost on the card (``scripts/tune_scatter_variants.cu``): for
whole images to the private kernel with more blocks a sample run in waves,
for few patches to the direct patch kernel. So
``bilinear_scatter_batched:private`` (one image is its S = 1) stays the
private kernel: G blocks a sample
(``private_blocks``, by shape) each splat a contiguous share of the
sample's events into a private copy in shared memory; one block stores its
copy, several add theirs to a zeroed output. The kernel runs only on the
card (``python3 chip_smoke.py``, ``tests/test_torch_cuda.py``). Here the
pure-Python geometry is checked on its own, and a plain-torch emulation of
the two stages (``emulated``) is held against the plain versions and
against the JAX package's splat: ``bilinear_matmul`` (the Pallas kernel in
interpret mode) and its ``jax.vmap`` over samples, as
``tests/test_torch_batched.py`` runs it.

Tolerances: against the plain versions 1e-6 of the output's max |value|
(fp32: the emulation sums each pixel in another order); against JAX 1e-5
(its hilo class).
"""

import jax
import numpy as np
import pytest
import torch

from event_utils_tpu.ops import pallas_scatter as jps
from event_utils_tpu_torch.errors import ConfigurationError
from event_utils_tpu_torch.ops import cuda_scatter as cs

FP32_REL = 1e-6
HILO_REL = 1e-5
IMAGE = (181, 241)            # DAVIS240 + 1: the IWE of the grid searches
PATCH = (64, 128)             # the ROI solvers' patches
SMS = cs.PRIVATE_MAX_BLOCKS   # an H100 SXM's SMs, one 174 KB image each
# the blocks a sample that measured fastest on the card at the main path's
# shapes (samples, events a sample; scripts/tune_scatter_routes.py part 9):
# the single image, a grid level, loss chunks of 2^24 // N samples of N
# events, the landscape, the full-frame ROI rows, stream_flow's grid level,
# the chunk boundary, and a small sample
MEASURED = {(1, 200_000): 132, (25, 200_000): 5, (83, 200_000): 3,
            (129, 130_000): 1, (167, 100_000): 3, (400, 15_000): 1,
            (2700, 2048): 1, (25, 20_000): 5, (65535, 4): 1, (3, 50): 1}


def assert_rel(got, ref, rel):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-6)
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def waves(S, b):
    return -(-S * b // SMS)


def emulated(x, y, w, H, W, blocks):
    """The private kernel's two stages in plain torch, for one sample (x, y
    (n,), w (K, n)): the slots split into ``blocks`` contiguous shares as
    the kernel splits them, each splatted into its own copy by
    ``bilinear_scatter_plain``, the copies' non-zero pixels added in block
    order to a zeroed image (one block: its copy is the image)."""
    n = x.shape[0]
    K = w.shape[0]
    share = -(-n // blocks) if n else 0
    out = torch.zeros((K, H, W), dtype=w.dtype, device=w.device)
    for j in range(blocks):
        lo, hi = min(j * share, n), min((j + 1) * share, n)
        copy = cs.bilinear_scatter_plain(x[lo:hi], y[lo:hi], w[:, lo:hi], H,
                                         W)
        if blocks == 1:
            return copy
        out += torch.where(copy != 0, copy, 0.0)
    return out


def odd_coords(rng, S, n, H, W):
    """(S, n) f32 coordinates over and around an (H, W) image, with NaN,
    +-1e30, x0 = -1 and x0 = W - 1 (one tap in, one out) among them."""
    x = rng.uniform(-2, W + 1, (S, n)).astype(np.float32)
    y = rng.uniform(-2, H + 1, (S, n)).astype(np.float32)
    odd = np.array([np.nan, 1e30, -1e30, -0.5, W - 0.5, -1.0, W - 1.0],
                   np.float32)
    x[:, ::5] = odd[np.arange(x[:, ::5].shape[1]) % len(odd)]
    y[:, 2::9] = np.array([np.nan, -1e30, -0.25, H - 0.75],
                          np.float32)[np.arange(y[:, 2::9].shape[1]) % 4]
    return torch.as_tensor(x), torch.as_tensor(y)


# ---------------------------------------------------------------------------
# The geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(MEASURED))
def test_blocks_at_the_measured_shapes(shape):
    """``private_blocks`` picks the blocks a sample that measured fastest
    on the card at the main path's shapes."""
    assert cs.private_blocks(*shape) == MEASURED[shape]


@pytest.mark.parametrize("S", [1, 2, 25, 44, 45, 65, 66, 67, 83, 88, 89,
                               100, 129, 131, 132, 133, 167, 198, 200, 263,
                               264, 265, 400, 2700, 4096])
def test_blocks_fill_the_card_and_stay_bounded(S):
    """Every sample gets at least one block and no more than one per 1024
    events; up to 66 samples the blocks fill one wave of the SMs and no
    more; past it at most ``PRIVATE_WAVE_BLOCKS``, and only with 98304
    events a sample; the count picked runs the fewest waves per block's
    share of the events, the smaller count on a tie, and more than one
    only where that cuts one block's waves to ``PRIVATE_WAVE_CUT`` or
    less."""
    for n in (1, 50, 1024, 20_000, 98_303, 98_304, 200_000, 2_000_000):
        b = cs.private_blocks(S, n)
        most = -(-n // cs.PRIVATE_EVENTS_PER_BLOCK)
        assert 1 <= b <= most
        if 2 * S <= SMS:
            assert S * b <= SMS
            assert b == min(most, SMS // S)
        elif n < cs.PRIVATE_MIN_EVENTS:
            assert b == 1
        else:
            assert b <= cs.PRIVATE_WAVE_BLOCKS
            tries = range(1, min(most, cs.PRIVATE_WAVE_BLOCKS) + 1)
            best = min(tries, key=lambda o: (waves(S, o) / o, o))
            if waves(S, best) / best <= cs.PRIVATE_WAVE_CUT * waves(S, 1):
                assert b == best
                for other in tries:
                    lhs, rhs = waves(S, b) * other, waves(S, other) * b
                    assert lhs < rhs or (lhs == rhs and b <= other)
            else:
                assert b == 1


def test_routes_by_shape():
    """Shapes to routes: an image that fits 227 KB takes the private
    kernel, K = 4 at a grid level's 200k events the vector one; few
    patches stay on the direct kernel, many take the patch kernel; the
    routes are counted and have wrappers."""
    assert cs.bilinear_batched_route(1, *IMAGE, 200_000) == "private"
    assert cs.bilinear_batched_route(4, *IMAGE, 200_000) == "vector"
    assert cs.bilinear_batched_route(
        1, *IMAGE, cs.PRIVATE_MIN_EVENTS) == "private"
    assert cs.bilinear_batched_route(
        1, *IMAGE, cs.PRIVATE_MIN_EVENTS - 1) == "direct"
    assert cs.bilinear_batched_route(
        1, *IMAGE, cs.PRIVATE_MIN_EVENTS - 1, 2) == "private"
    assert cs.bilinear_patches_route(108, *PATCH) == "direct"
    assert cs.bilinear_patches_route(767, *PATCH) == "direct"
    assert cs.bilinear_patches_route(768, *PATCH) == "patch"
    assert cs.bilinear_patches_route(2700, 240, 256) == "direct"
    assert set(cs.ROUTES) == set(cs.KERNEL_WRAPPERS)
    assert "bilinear_scatter:private" not in cs.ROUTES
    assert (cs.KERNEL_WRAPPERS["bilinear_scatter_batched:private"]
            is cs.bilinear_scatter_batched)
    x = torch.zeros(10)
    with pytest.raises(ConfigurationError):   # K = 4 past 227 KB
        cs.bilinear_scatter_batched(x[None], x[None], torch.ones(4, 10),
                                    *IMAGE, route="private")


# ---------------------------------------------------------------------------
# The two stages in plain torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", [1, 2, 3, 5, 7, 132])
def test_emulated_stages_match_the_batched_plain_version(blocks):
    """Shares splatted into private copies and their non-zero pixels added:
    the batched plain version's image, sample by sample, at K = 1 and
    K = 3, with shares that do not divide the events (and empty ones past
    the events at 132 blocks)."""
    rng = np.random.default_rng(100 + blocks)
    S, n, H, W = 3, 1001, 37, 53
    x, y = odd_coords(rng, S, n, H, W)
    for K in (1, 3):
        w = torch.as_tensor(rng.normal(0, 1, (S, K, n)).astype(np.float32))
        ref = cs.bilinear_scatter_batched_plain(x, y, w, H, W)
        got = torch.stack([emulated(x[s], y[s], w[s], H, W, blocks)
                           for s in range(S)])
        assert_rel(got, ref, FP32_REL)


def test_emulated_stages_on_one_pixel():
    """Every slot on one pixel: the hot pixel's four taps summed across the
    copies, every other pixel exactly zero."""
    n, H, W = 4000, 37, 53
    x = torch.full((n,), 20.25)
    y = torch.full((n,), 10.5)
    w = torch.as_tensor(np.random.default_rng(3).uniform(0.5, 1.5, (1, n))
                        .astype(np.float32))
    ref = cs.bilinear_scatter_plain(x, y, w, H, W)
    got = emulated(x, y, w, H, W, 3)
    assert_rel(got, ref, FP32_REL)
    assert int((got != 0).sum()) == 4


@pytest.mark.parametrize("blocks", [1, 3, 8])
def test_emulated_stages_match_jax_bilinear_matmul(blocks):
    """One image against the JAX package's splat (the Pallas kernel in
    interpret mode), K = 1 and K = 4 with a mask."""
    rng = np.random.default_rng(20 + blocks)
    n, H, W = 3000, 41, 61
    x = rng.uniform(-1.5, W + 0.5, n).astype(np.float32)
    y = rng.uniform(-1.5, H + 0.5, n).astype(np.float32)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    for K in (1, 4):
        w = rng.normal(0, 1, (K, n)).astype(np.float32)
        ref = jps.bilinear_matmul(x, y, w[0] if K == 1 else w, (H, W),
                                  mask=mask, chunk=1024, interpret=True)
        got = emulated(torch.as_tensor(x), torch.as_tensor(y),
                       torch.as_tensor(w * mask), H, W, blocks)
        assert_rel(got[0] if K == 1 else got, np.asarray(ref), HILO_REL)


def test_emulated_stages_match_jax_vmap():
    """S samples with the blocks ``private_blocks`` picks against
    ``jax.vmap`` of the Pallas kernel over the samples (per-sample
    weights)."""
    rng = np.random.default_rng(31)
    S, n, H, W = 3, 1500, 41, 61
    x = rng.uniform(-2, W + 1, (S, n)).astype(np.float32)
    y = rng.uniform(-2, H + 1, (S, n)).astype(np.float32)
    w = rng.normal(0, 1, (S, 1, n)).astype(np.float32)

    def one(xs, ys, ws):
        return jps.bilinear_matmul(xs, ys, ws[0], (H, W), chunk=1024,
                                   interpret=True)

    ref = np.asarray(jax.vmap(one)(x, y, w))
    blocks = cs.private_blocks(S, n)
    assert blocks == 2                  # two blocks for 1500 events
    got = torch.stack([emulated(
        torch.as_tensor(x[s]), torch.as_tensor(y[s]), torch.as_tensor(w[s]),
        H, W, blocks)[0] for s in range(S)])
    assert_rel(got, ref, HILO_REL)


def test_every_bound_entry_point_is_in_the_source():
    """Each C entry point that ``ops/build.py`` binds is defined in
    ``csrc/scatter_kernels.cu`` with as many parameters as its ctypes
    signature: the card loads the library by these names."""
    import re

    from event_utils_tpu_torch.ops import build
    src = (build.CSRC_DIR / "scatter_kernels.cu").read_text()
    body = src[src.index('extern "C" {'):]
    for name, argtypes in build.SIGNATURES["scatter_kernels"].items():
        m = re.search(r"\bint " + name + r"\(([^)]*)\)", body)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
