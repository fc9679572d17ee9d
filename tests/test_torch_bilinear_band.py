"""The whole-image splat's vector route and its routing, on the CPU.

``bilinear_scatter_batched:vector`` (one image at S = 1) serves K >= 2 channels
past 227 KB: each tap's K values go as one ``float2``
(K = 2) or ``float4`` (K = 3, 4) reduction into a channels-innermost scratch
``(S, H*W, Kp)``, which a second pass unpacks into ``(S, K, H, W)``.

The kernels run only on the card (``python3 chip_smoke.py``,
``tests/test_torch_cuda.py``). Here the pure-Python geometry (``vector_channels``,
``vector_chunk``) and the routing are checked on their own, and a numpy
emulation of the design with that geometry (``vector_emulated``) is held
against the plain versions and against the JAX package's splat: ``bilinear_matmul``
(the Pallas kernel in interpret mode) and its ``jax.vmap`` over samples.

Tolerances: against the plain versions 1e-5 of the output's max |value|
(f32: the emulations sum each pixel in another order); against JAX 3e-5 of
it (its 'hilo' class, ~1e-5 relative, with margin). JAX's one-hot product
turns a NaN coordinate into NaN pixels, so the JAX cases keep +-1e30 and
out-of-frame coordinates and leave NaN to the plain comparisons.
"""

import jax
import numpy as np
import pytest
import torch

from event_utils_tpu.ops import pallas_scatter as jps
from event_utils_tpu_torch.errors import ConfigurationError
from event_utils_tpu_torch.ops import cuda_scatter as cs

FP32_REL = 1e-5
HILO_REL = 3e-5
F32 = np.float32


def assert_rel(got, ref, rel):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-6)
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def _taps(x, y, H, W, lo=0, hi=None):
    """Floors, fractions and the tap tests of one sample's events, with the
    rows held to [lo, hi) (the image by default), as the kernels
    test them: in float, before any integer cast."""
    hi = H if hi is None else hi
    with np.errstate(invalid="ignore"):
        x0 = np.floor(x)
        y0 = np.floor(y)
        okx = ((x0 >= 0) & (x0 < W), (x0 + 1 >= 0) & (x0 + 1 < W))
        oky = ((y0 >= lo) & (y0 < hi), (y0 + 1 >= lo) & (y0 + 1 < hi))
    return x0, y0, x - x0, y - y0, okx, oky


def vector_emulated(x, y, w, H, W):
    """The vector route in numpy (f32): each live tap adds its K values,
    padded to ``vector_channels(K)`` columns, as one row of the zeroed
    channels-innermost scratch (S, H*W, Kp); then the first K columns are
    unpacked into (S, K, H, W). Returns the output and the scratch."""
    S, n = x.shape
    K = w.shape[-2]
    Kp = cs.vector_channels(K)
    w = np.broadcast_to(w, (S, K, n))
    scratch = np.zeros((S, H * W, Kp), F32)
    for s in range(S):
        x0, y0, dx, dy, okx, oky = _taps(x[s], y[s], H, W)
        live = (oky[0] | oky[1]) & (okx[0] | okx[1])
        i = np.nonzero(live)[0]
        wp = np.zeros((len(i), Kp), F32)
        wp[:, :K] = w[s, :, i].reshape(len(i), K)
        base = y0[i].astype(np.int64) * W + x0[i].astype(np.int64)
        wx = (wp * (1 - dx[i])[:, None], wp * dx[i][:, None])
        for oy, wy in ((0, 1 - dy[i]), (1, dy[i])):
            for ox in (0, 1):
                m = oky[oy][i] & okx[ox][i] & (wp != 0).any(1)
                np.add.at(scratch[s], base[m] + oy * W + ox,
                          (wx[ox] * wy[:, None])[m])
    out = scratch[..., :K].transpose(0, 2, 1).reshape(S, K, H, W)
    return np.ascontiguousarray(out), scratch


def odd_coords(rng, S, n, H, W, rows, nan=True):
    """(S, n) f32 coordinates over and around an (H, W) image, with edge
    rows among them: floor(y) = -1, H - 1 and every multiple of ``rows``
    less one; +-1e30 and out-of-frame x (x0 = -2, -1, W - 1, W); with ``nan``
    also NaN in x and y."""
    x = rng.uniform(-2, W + 1, (S, n))
    y = rng.uniform(-2, H + 1, (S, n))
    edges = np.array([-1.0, H - 1.0] + [r - 1.0
                                        for r in range(rows, H, rows)])
    y[:, ::3] = edges[np.arange(y[:, ::3].shape[1]) % len(edges)] + 0.375
    odd_x = [1e30, -1e30, -1.5, W + 0.5, -0.5, W - 0.5]
    odd_y = [1e30, -1e30]
    if nan:
        odd_x.append(np.nan)
        odd_y.append(np.nan)
    x[:, 1::7] = np.array(odd_x)[np.arange(x[:, 1::7].shape[1]) % len(odd_x)]
    y[:, 2::11] = np.array(odd_y)[np.arange(y[:, 2::11].shape[1])
                                  % len(odd_y)]
    return x.astype(F32), y.astype(F32)


def plain(x, y, w, H, W):
    """The batched plain version on numpy inputs, as numpy."""
    return cs.bilinear_scatter_batched_plain(
        torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w), H,
        W).numpy()


# ---------------------------------------------------------------------------
# The geometry
# ---------------------------------------------------------------------------

def test_vector_scratch_geometry():
    """Two channels pair as one float2; three to four as one float4; more
    as whole float4s. Zhu's 181x241 stack: chunks whose scratch stays
    within ``VECTOR_CHUNK_BYTES``."""
    assert [cs.vector_channels(K) for K in (2, 3, 4, 5, 8, 9)] == [
        2, 4, 4, 8, 8, 12]
    c = cs.vector_chunk(4, 181, 241)
    assert c == ZHU_CHUNK
    assert c * 181 * 241 * 16 <= max(cs.VECTOR_CHUNK_BYTES, 181 * 241 * 16)
    assert cs.vector_chunk(4, 2000, 2000) == 1
    assert cs.vector_chunk(2, 2, 3) == cs.BATCH_MAX_SAMPLES
    assert cs.batched_chunk("vector", 4, 181, 241) == c
    for r in ("direct", "private"):
        assert cs.batched_chunk(r, 4, 181, 241) == cs.BATCH_MAX_SAMPLES

# ---------------------------------------------------------------------------
# The channels-innermost scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,K,shared", [(1, 2, True), (3, 2, False),
                                        (1, 3, True), (3, 3, False),
                                        (1, 4, True), (3, 4, False),
                                        (2, 5, False)])
def test_vector_scratch_matches_plain(S, K, shared):
    """The scratch written tap by tap as Kp-wide rows (Kp = 2 for K = 2,
    4 for K = 3 and 4, 8 for K = 5) and unpacked equals the batched plain
    version; the pad columns stay zero."""
    rng = np.random.default_rng(60 + 10 * S + K)
    n, H, W = 2500, 37, 53
    x, y = odd_coords(rng, S, n, H, W, 5)
    w = rng.normal(0, 1, (K, n) if shared else (S, K, n)).astype(F32)
    w[..., 3::17] = 0.0
    got, scratch = vector_emulated(x, y, w, H, W)
    assert scratch.shape == (S, H * W, cs.vector_channels(K))
    assert not scratch[..., K:].any()
    assert_rel(got, plain(x, y, w, H, W), FP32_REL)


def test_vector_scratch_matches_jax_vmap():
    """Zhu's K = 4 stack of three samples (per-sample weights) against
    ``jax.vmap`` of the Pallas kernel."""
    rng = np.random.default_rng(71)
    S, n, H, W = 3, 2000, 41, 61
    x, y = odd_coords(rng, S, n, H, W, 5, nan=False)
    t = rng.uniform(0, 1, (S, 1, n))
    p = rng.random((S, 1, n)) > 0.5
    w = np.concatenate([t * p, p, t * ~p, ~p], 1).astype(F32)

    def one(xs, ys, ws):
        return jps.bilinear_matmul(xs, ys, ws, (H, W), chunk=1024,
                                   interpret=True)

    ref = np.asarray(jax.vmap(one)(x, y, w))
    got, _ = vector_emulated(x, y, w, H, W)
    assert_rel(got, ref, HILO_REL)


@pytest.mark.parametrize("K", [2, 4])
def test_vector_scratch_matches_jax_bilinear_matmul(K):
    """One image with a mask, edge rows, +-1e30 and out-of-frame
    coordinates against the JAX package's splat (the Pallas kernel in
    interpret mode)."""
    rng = np.random.default_rng(80 + K)
    n, H, W = 2048, 41, 61
    x, y = odd_coords(rng, 1, n, H, W, 6, nan=False)
    mask = (rng.random(n) > 0.2).astype(F32)
    w = rng.normal(0, 1, (K, n)).astype(F32)
    ref = jps.bilinear_matmul(x[0], y[0], w, (H, W), mask=mask, chunk=1024,
                              interpret=True)
    got, _ = vector_emulated(x, y, w * mask, H, W)
    assert_rel(got[0], np.asarray(ref), HILO_REL)


def test_vector_scratch_edge_rows_and_columns():
    """floor(y) = -1 sends only its second row, floor(y) = H - 1 only its
    first; likewise in x; each tap's K values land in one scratch row."""
    H, W = 12, 10
    x = np.array([[3.25, -0.5, W - 1 + 0.75]], F32)
    y = np.array([[-1 + 0.5, H - 1 + 0.75, 5.0]], F32)
    w = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], F32)
    got, scratch = vector_emulated(x, y, w, H, W)
    assert_rel(got, plain(x, y, w, H, W), FP32_REL)
    assert got[0, :, 0].sum(1) == pytest.approx([0.5, 2.0])     # y0 = -1
    assert got[0, :, H - 1].sum(1) == pytest.approx([0.25, 0.625])
    assert got[0, :, :, W - 1].sum(1) == pytest.approx([0.75, 1.5])
    assert scratch[0, 5 * W + W - 1].tolist() == pytest.approx([0.75, 1.5])


# ---------------------------------------------------------------------------
# Routing, forced routes, counters, gradients
# ---------------------------------------------------------------------------

# (K, H, W, n) -> route that part 11 of scripts/tune_scatter_routes.py
# measured fastest on an H100 (the main path's shapes among them: one ROI's
# 2k events into its own image and into the full frame, stream_flow's 20k,
# the timestamp image and zhu's stack at 200k; the few-event shapes stay on
# the direct route, whose device time the band variant did not beat)
MEASURED = {(1, 21, 21, 2048): "direct", (1, 181, 241, 2048): "direct",
            (1, 181, 241, 8192): "direct", (1, 181, 241, 20_000): "direct",
            (1, 181, 241, 200_000): "private", (4, 181, 241, 2048): "direct",
            (4, 181, 241, 15_000): "direct", (4, 181, 241, 20_000): "vector",
            (4, 181, 241, 200_000): "vector",
            (1, 480, 640, 2048): "direct", (1, 480, 640, 131_072): "direct",
            (4, 480, 640, 20_000): "direct", (4, 480, 640, 32_768): "vector"}
# (K, H, W, n, S) -> route
MEASURED_BATCHED = {(1, 181, 241, 20_000, 25): "private",
                    (1, 181, 241, 200_000, 25): "private",
                    (4, 181, 241, 200_000, 25): "vector",
                    (4, 181, 241, 2048, 25): "direct",
                    (4, 181, 241, 4096, 25): "vector",
                    (4, 480, 640, 2048, 25): "direct",
                    (1, 480, 640, 2048, 25): "direct"}
ZHU_CHUNK = 30


@pytest.mark.parametrize("shape", sorted(MEASURED))
def test_routes_at_the_measured_shapes(shape):
    # one image: the batched rule at S = 1
    assert cs.bilinear_batched_route(*shape) == MEASURED[shape]
    assert cs.bilinear_batched_route(*shape, 1) == MEASURED[shape]


@pytest.mark.parametrize("shape", sorted(MEASURED_BATCHED))
def test_batched_routes_at_the_measured_shapes(shape):
    assert cs.bilinear_batched_route(*shape) == MEASURED_BATCHED[shape]


def test_route_thresholds():
    """The vector route only for two channels or more past 227 KB and from
    ``VECTOR_MIN_SAVED_BILINEAR`` saved requests; few events stay direct;
    the private route where the image fits (one image from
    ``PRIVATE_MIN_EVENTS`` on)."""
    assert cs.bilinear_batched_route(1, 181, 241, 1) == "direct"
    assert cs.bilinear_batched_route(4, 181, 241, 2048) == "direct"
    assert cs.bilinear_batched_route(4, 181, 241, 16_383) == "direct"
    assert cs.bilinear_batched_route(4, 181, 241, 16_384) == "vector"
    assert cs.bilinear_batched_route(1, 181, 241, 10 ** 6) == "private"
    assert cs.bilinear_batched_route(
        1, 181, 241, cs.PRIVATE_MIN_EVENTS) == "private"
    assert cs.bilinear_batched_route(2, 8, 8, 10 ** 6) == "private"
    assert cs.bilinear_batched_route(4, 181, 241, 2048, 25) == "direct"
    assert cs.bilinear_batched_route(4, 181, 241, 8192, 25) == "vector"
    assert cs.bilinear_batched_route(4, 181, 241, 2048, 400) == "direct"
    assert cs.bilinear_batched_route(1, 720, 1280, 10 ** 6, 25) == "direct"
    assert cs.bilinear_batched_route(1, 720, 1280, 2048, 25) == "direct"


def test_forced_routes_and_their_limits():
    """``route=`` takes any route the shape allows (on the CPU the plain
    version answers) and raises for one it does not."""
    rng = np.random.default_rng(5)
    n, H, W = 300, 181, 241
    x, y = (torch.as_tensor(a[0]) for a in odd_coords(rng, 1, n, H, W, 6))
    w4 = torch.as_tensor(rng.normal(0, 1, (4, n)).astype(F32))
    ref = cs.bilinear_scatter_plain(x, y, w4, H, W)
    for r in ("vector", "direct"):
        assert torch.equal(cs.bilinear_scatter(x, y, w4, H, W, route=r), ref)
        assert torch.equal(cs.bilinear_scatter_batched(
            x[None], y[None], w4, H, W, route=r)[0], ref)
    with pytest.raises(ConfigurationError):     # one channel: nothing to pair
        cs.bilinear_scatter(x, y, w4[:1].contiguous(), H, W, route="vector")
    with pytest.raises(ConfigurationError):     # 697 KB: no private image
        cs.bilinear_scatter(x, y, w4, H, W, route="private")
    with pytest.raises(ConfigurationError):
        cs.bilinear_scatter_batched(x[None], y[None], w4[:1].contiguous(),
                                    H, W, route="vector")


def test_new_routes_are_counted_and_have_wrappers():
    """The vector route is in ``ROUTES`` and ``KERNEL_WRAPPERS`` and
    counted by ``launch_counts``, one image's launches under the batched
    name; a CPU call launches nothing. The band variant, which lost, is no
    route."""
    new = {"bilinear_scatter_batched:vector": cs.bilinear_scatter_batched}
    assert "bilinear_scatter:vector" not in cs.ROUTES
    assert not any("band" in r for r in cs.ROUTES)
    assert set(cs.ROUTES) == set(cs.KERNEL_WRAPPERS)
    for name, fn in new.items():
        assert name in cs.ROUTES
        assert cs.KERNEL_WRAPPERS[name] is fn
    cs.reset_launch_counts()
    assert set(cs.launch_counts()) == set(cs.ROUTES)
    x = torch.rand(64) * 20
    cs.bilinear_scatter(x, x, torch.rand(4, 64), 181, 241, route="vector")
    cs.bilinear_scatter_batched(x[None], x[None], torch.rand(4, 64), 181,
                                241, route="vector")
    assert not any(cs.launch_counts().values())


@pytest.mark.parametrize("K,H,W,n", [(1, 181, 241, 2048), (4, 181, 241, 2048),
                                     (4, 181, 241, 40_000),
                                     (2, 37, 53, 2000)])
def test_gradients_do_not_depend_on_the_route(K, H, W, n):
    """``bilinear_matmul``'s gradients (the gather VJP of
    ``_bilinear_core_bwd``) at shapes the direct and vector routes serve
    equal autograd through the plain version's ``index_add_``, and the
    batched splat's equal them sample by sample."""
    rng = np.random.default_rng(K * n)
    x, y = odd_coords(rng, 2, n, H, W, 6, nan=False)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    w = torch.as_tensor(rng.normal(0, 1, (K, n)).astype(F32))
    tgt = torch.as_tensor(rng.normal(0, 1, (2, K, H, W)).astype(F32))
    assert cs.bilinear_batched_route(K, H, W, n) in ("direct", "vector")

    def grads(fn, *a):
        leaves = [t.clone().requires_grad_(True) for t in a]
        return torch.autograd.grad((fn(*leaves) * tgt[0]).sum(), leaves)

    got = grads(lambda a, b, c: cs.bilinear_matmul(a, b, c, (H, W)), x[0],
                y[0], w)
    ref = grads(lambda a, b, c: cs.bilinear_scatter_plain(a, b, c, H, W),
                x[0], y[0], w)
    for g, r in zip(got, ref):
        assert_rel(g, r, 1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (x, y, w)]
    gb = torch.autograd.grad(
        (cs.bilinear_matmul_batched(*leaves, (H, W)) * tgt).sum(), leaves)
    assert_rel(gb[0][0], got[0], 1e-5)      # sample 0's x and y
    assert_rel(gb[1][0], got[1], 1e-5)
