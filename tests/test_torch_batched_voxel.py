"""Batched voxel grids, on the CPU: ``_voxel_kernel`` under ``jax.vmap``.

The JAX package builds S voxel grids of S rows of events with one vmapped
call: ``voxel_grids_fixed_n`` (windows of a stream) and the trainers'
padded rows (``training/loop.py:174-185``, ``in_the_loop.py:508-520``).
The port's counterparts build them in one call too:
``voxel_matmul_batched`` / ``voxel_scatter_batched`` (one batched kernel
launch on the card; here its plain version), ``events_to_voxel_rows`` (the
exact routes: one flat scatter with ids offset by row) and
``voxelize_batch``. The E2VID windows keep the segment route, with each
window's first and last stamp read off the simulator's sorted rows
(``window_stamps``) instead of a ``scatter_reduce``.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode, or the exact XLA route. Tolerances, relative to the
output's max |value|: f32 sums 1e-5; JAX's one-hot-matmul kernel at 'hilo'
and 'int8' precision 3e-5, at 'bf16' 4e-3; gradients 1e-5 (both sides
gather the cotangent exactly). The plain batched splat is held bitwise to
single plain calls, and the sorted-row stamps bitwise to the
``scatter_reduce`` ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu.ops import pallas_scatter as jps
from event_utils_tpu_torch.ops import cuda_scatter as cs
from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
from event_utils_tpu_torch.representations import voxel_grid as vg
from event_utils_tpu_torch.training import in_the_loop as itl

torch.set_num_threads(1)

SENSOR = (24, 32)
REL = {None: 1e-5, "sort": 1e-5, "matmul": 3e-5, "matmul_int8": 3e-5,
       "matmul_bf16": 4e-3}


def assert_rel(got, ref, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    err = float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def stream(rng, n, sensor=SENSOR):
    H, W = sensor
    xs = rng.integers(-2, W + 2, n)
    ys = rng.integers(-2, H + 2, n)
    ts = np.sort(rng.uniform(0, 1.0, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return xs, ys, ts, ps


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the batched kernel wrapper, the flat scatter and
    the single-grid entry points while the test runs."""
    seen = dict.fromkeys(("batched", "flat", "single"), 0)

    def counting(key, fn):
        def wrapped(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(cs, "voxel_scatter_batched", counting(
        "batched", cs.voxel_scatter_batched))
    monkeypatch.setattr(vg, "scatter_add_flat", counting(
        "flat", vg.scatter_add_flat))
    monkeypatch.setattr(vg, "events_to_voxel", counting(
        "single", vg.events_to_voxel))
    return seen


# ---------------------------------------------------------------------------
# voxel_grids_fixed_n
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("windows", [1, 4, 11])
@pytest.mark.parametrize("impl", [None, "sort", "matmul", "matmul_bf16",
                                  "matmul_int8"])
def test_voxel_grids_fixed_n_matches_jax(rng, calls, impl, windows):
    """Every window in one call: one batched kernel call under 'matmul*',
    one flat scatter otherwise, never one grid per window; a ragged tail
    is left out as JAX leaves it out."""
    n, B = 300, 3 if windows != 4 else 5
    xs, ys, ts, ps = stream(rng, n * windows + 17)
    got = P.representations.voxel_grids_fixed_n(
        xs, ys, ts, ps, B, n, sensor_size=SENSOR, impl=impl, device="cpu")
    ref = J.representations.voxel_grids_fixed_n(xs, ys, ts, ps, B, n,
                                                sensor_size=SENSOR, impl=impl)
    assert got.shape == (windows, B) + SENSOR
    assert_rel(got, ref, REL[impl])
    matmul = impl is not None and impl.startswith("matmul")
    assert calls == {"batched": int(matmul), "flat": int(not matmul),
                     "single": 0}


@pytest.mark.parametrize("impl", [None, "matmul"])
def test_voxel_grids_fixed_n_slices_match_jax(rng, calls, impl):
    """``temporal_bilinear=False``: equal-duration slices per window, one
    flat scatter (the slice binning's matmul route is the flat kernel)."""
    xs, ys, ts, ps = stream(rng, 1000)
    got = P.representations.voxel_grids_fixed_n(
        xs, ys, ts, ps, 4, 250, sensor_size=SENSOR, temporal_bilinear=False,
        impl=impl, device="cpu")
    ref = J.representations.voxel_grids_fixed_n(
        xs, ys, ts, ps, 4, 250, sensor_size=SENSOR, temporal_bilinear=False,
        impl=impl)
    assert_rel(got, ref, 1e-5)
    assert calls == {"batched": 0, "flat": 1, "single": 0}


def test_voxel_grids_fixed_n_tiled_raises_as_jax_does(rng):
    """JAX's vmapped call cannot bucket traced events on the host and
    raises (``TracerArrayConversionError``); the port raises
    ``ConfigurationError`` (ROADMAP queue 3)."""
    xs, ys, ts, ps = stream(rng, 600)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        J.representations.voxel_grids_fixed_n(xs, ys, ts, ps, 3, 300,
                                              sensor_size=SENSOR,
                                              impl="tiled")
    with pytest.raises(P.errors.ConfigurationError):
        P.representations.voxel_grids_fixed_n(xs, ys, ts, ps, 3, 300,
                                              sensor_size=SENSOR,
                                              impl="tiled", device="cpu")


# ---------------------------------------------------------------------------
# voxel_matmul_batched against jax.vmap(voxel_matmul), values and gradients
# ---------------------------------------------------------------------------

ROW_CASES = ["window", "masked", "override", "masked_override"]


def rows(rng, S=4, n=400, B=5):
    """S rows of n events (time-sorted per row), per-row masks with an
    all-masked row and a row of one event, per-row windows that pin events
    beyond both edges, and a cotangent."""
    ev = [stream(rng, n) for _ in range(S)]
    xs, ys, ts, ps = (np.stack(a) for a in zip(*ev))
    mask = (rng.random((S, n)) > 0.3).astype(np.float32)
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2, n // 2] = 1.0
    t0 = np.array([0.2, 0.0, 0.1, 0.35], np.float32)[:S]
    t1 = np.array([0.7, 1.0, 0.6, 0.95], np.float32)[:S]
    tgt = rng.normal(size=(S, B) + SENSOR).astype(np.float32)
    return xs, ys, ts, ps, mask, t0, t1, tgt


def jax_batched(case, B, xs, ys, ts, ps, mask, t0, t1):
    """``jax.vmap`` of the Pallas ``voxel_matmul`` (interpret mode) over the
    rows, as a function of ``(ts, ps)``."""
    masked = case.startswith("masked")
    over = case.endswith("override")

    def one(x, y, t, p, m, a, b):
        return jps.voxel_matmul(x, y, t, p, B, sensor_size=SENSOR,
                                mask=m if masked else None,
                                t0=a if over else None,
                                t1=b if over else None, interpret=True)

    return lambda t, p: jax.vmap(one)(jnp.asarray(xs), jnp.asarray(ys), t, p,
                                      jnp.asarray(mask), jnp.asarray(t0),
                                      jnp.asarray(t1))


@pytest.mark.parametrize("case", ROW_CASES)
def test_voxel_matmul_batched_matches_jax_vmap(rng, case):
    B = 5
    xs, ys, ts, ps, mask, t0, t1, tgt = rows(rng, B=B)
    fn = jax_batched(case, B, xs, ys, ts, ps, mask, t0, t1)
    ref = fn(jnp.asarray(ts), jnp.asarray(ps))
    jgt, jgp = jax.grad(lambda t, p: jnp.sum(fn(t, p) * tgt),
                        argnums=(0, 1))(jnp.asarray(ts), jnp.asarray(ps))
    kw = {}
    if case.startswith("masked"):
        kw["mask"] = torch.as_tensor(mask)
    if case.endswith("override"):
        kw.update(t0=torch.as_tensor(t0), t1=torch.as_tensor(t1))
    pt = torch.tensor(ts, requires_grad=True)
    pp = torch.tensor(ps, requires_grad=True)
    got = cs.voxel_matmul_batched(torch.as_tensor(xs), torch.as_tensor(ys),
                                  pt, pp, B, sensor_size=SENSOR, **kw)
    assert_rel(got, ref, REL["matmul"])
    gt_, gp_ = torch.autograd.grad((got * torch.as_tensor(tgt)).sum(),
                                   (pt, pp))
    assert_rel(gt_, jgt, 1e-5)
    assert_rel(gp_, jgp, 1e-5)
    if case.startswith("masked"):
        got = got.detach()
        assert float(got[1].abs().max()) == 0.0     # all masked
        assert float(got[2].sum()) == pytest.approx(   # one event, one bin
            float(np.asarray(ref[2]).sum()), abs=1e-6)


@pytest.mark.parametrize("case", ["masked", "masked_override"])
def test_split_grids_are_the_two_polarity_grids(rng, case):
    """``split``: each row's positive and negative grids in one call, equal
    to the two polarity weightings of ``events_to_neg_pos_voxel`` (values,
    and the gradient in ``ts``)."""
    B = 5
    xs, ys, ts, ps, mask, t0, t1, _ = rows(rng, B=B)
    ps[:, ::7] = 0.0                   # zero polarity counts as negative
    kw = dict(sensor_size=SENSOR, mask=torch.as_tensor(mask))
    if case.endswith("override"):
        kw.update(t0=torch.as_tensor(t0), t1=torch.as_tensor(t1))
    x, y = torch.as_tensor(xs), torch.as_tensor(ys)
    tgt = torch.as_tensor(rng.normal(size=(4, 2 * B) + SENSOR)
                          .astype(np.float32))
    pt = torch.tensor(ts, requires_grad=True)
    got = cs.voxel_matmul_batched(x, y, pt, torch.as_tensor(ps), B,
                                  split=True, **kw)
    (g_split,) = torch.autograd.grad((got * tgt).sum(), (pt,))
    pt2 = torch.tensor(ts, requires_grad=True)
    halves = [cs.voxel_matmul_batched(x, y, pt2, sel.float(), B, **kw)
              for sel in (torch.as_tensor(ps) > 0, torch.as_tensor(ps) <= 0)]
    want = torch.cat(halves, 1)
    (g_two,) = torch.autograd.grad((want * tgt).sum(), (pt2,))
    assert torch.equal(got, want)
    assert_rel(g_split, g_two.numpy(), 1e-6)
    ref = jax.vmap(lambda a, b, c, d, m: jnp.concatenate(
        J.representations.events_to_neg_pos_voxel(
            a, b, c, d, B, sensor_size=SENSOR, mask=m), 0))(
        xs, ys, ts, ps, mask)
    if case == "masked":
        assert_rel(got, ref, 1e-5)


# ---------------------------------------------------------------------------
# The plain version: bitwise S single calls; the vector layout
# ---------------------------------------------------------------------------

def raw_rows(rng, S, n, B, H, W):
    """Kernel inputs as no wrapper makes them: coordinates off the image,
    first bins of -1, ``t_norm = B-1``, NaN, +-inf and huge bins, zero and
    negative weights."""
    xs = rng.integers(-1, W + 1, (S, n)).astype(np.int32)
    ys = rng.integers(-1, H + 1, (S, n)).astype(np.int32)
    t = rng.uniform(-2.5, B + 1.5, (S, n)).astype(np.float32)
    t[:, ::9] = B - 1
    t[:, 1::9] = -1.0
    t[:, 2::9] = -0.25
    t[:, 3::9] = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30])[
        np.arange(t[:, 3::9].shape[1]) % 5]
    ps = (rng.choice([-1.0, 0.0, 1.0], (S, n))
          * rng.uniform(0.5, 1.5, (S, n))).astype(np.float32)
    return [torch.as_tensor(a) for a in (xs, ys, t, ps)]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("B", [1, 3, 5, 9])
def test_batched_plain_is_single_plain_calls(rng, B, split):
    S, n, H, W = 5, 700, 9, 11
    xs, ys, t, ps = raw_rows(rng, S, n, B, H, W)
    got = cs.voxel_scatter_batched_plain(xs, ys, t, ps, B, H, W, split)
    assert torch.equal(got, cs.voxel_scatter_batched(xs, ys, t, ps, B, H, W,
                                                     split=split))
    single = []
    for s in range(S):
        weights = ((torch.where(ps[s] > 0, ps[s], 0.0),
                    torch.where(ps[s] < 0, -ps[s], 0.0)) if split
                   else (ps[s],))
        single += [cs.voxel_scatter_plain(xs[s], ys[s], t[s], w, B, H, W)
                   for w in weights]
    assert got.shape == (S, (2 if split else 1) * B, H, W)
    assert torch.equal(got, torch.cat(single).view(got.shape))


def batched_vector_layout(xs, ys, t_norm, ps, B, H, W, split):
    """What the batched vector route's two kernels compute, in numpy: per
    grid (row, and polarity with ``split``) one pair of adjacent columns per
    event in one of its two bins-innermost accumulators, then ``out[g, b] =
    first[g][:, b] + second[g][:, b + 1]``."""
    S = xs.shape[0]
    G = 2 if split else 1
    Bp = cs._voxel_scratch_bins(B)
    acc = np.zeros((S * G, 2, H * W, Bp))
    for s in range(S):
        for x, y, t, p in zip(xs[s], ys[s], t_norm[s], ps[s]):
            if p == 0 or not (0 <= x < W and 0 <= y < H):
                continue
            b0 = np.floor(t)
            if not (b0 >= -1 and b0 < B):        # NaN fails both
                continue
            g = s * G + int(split and p < 0)
            p = abs(p) if split else p
            odd = int(b0) & 1
            col = int(b0) + odd
            assert col % 2 == 0 and 0 <= col and col + 1 < Bp
            acc[g, odd, y * W + x, col] += p * (1 - (t - b0))
            acc[g, odd, y * W + x, col + 1] += p * (t - b0)
    out = acc[:, 0, :, :B] + acc[:, 1, :, 1:B + 1]
    return out.transpose(0, 2, 1).reshape(S, G * B, H, W)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("B", [1, 2, 5])
def test_batched_vector_layout_matches_plain(rng, B, split):
    S, n, H, W = 3, 300, 6, 7
    args = raw_rows(rng, S, n, B, H, W)
    with np.errstate(invalid="ignore"):
        ref = batched_vector_layout(*(a.numpy() for a in args), B, H, W,
                                    split)
    assert_rel(cs.voxel_scatter_batched(*args, B, H, W, split=split), ref,
               1e-5)


def batched_private_layout(xs, ys, t_norm, ps, B, H, W, split):
    """What the batched private route's kernel computes, in numpy: block
    (g, b) of ``voxel_batched_private_kernel`` (grid g = s * G + q) keeps,
    of row s's events, the taps whose bin is b by the kernel's float tests
    (a NaN, infinite or huge bin matches none) and, with ``split``, whose
    sign is q's (q = 0: p > 0, 1: p < 0), sums them in its own plane and
    stores it once. Every output element must be stored by exactly one
    block."""
    S, n = xs.shape
    G = 2 if split else 1
    out = np.full((S, G, B, H, W), np.nan)
    stores = np.zeros((S, G, B, H, W), int)
    one = np.float32(1.0)
    for s in range(S):
        t = t_norm[s]
        b0 = np.floor(t)
        fb = t - b0
        for q in range(G):
            for b in range(B):
                own = np.float32(b)
                want = (b0 == own) | (b0 + one == own)
                p = np.where(want, ps[s], 0.0)
                keep = (p != 0) & (ys[s] >= 0) & (ys[s] < H) & (xs[s] >= 0) \
                    & (xs[s] < W)
                if split:
                    keep &= (p < 0) == bool(q)
                    p = np.abs(p)
                val = np.where(b0 == own, p * (1 - fb), p * fb)
                plane = np.zeros((H, W))
                np.add.at(plane, (ys[s][keep], xs[s][keep]), val[keep])
                out[s, q, b] = plane
                stores[s, q, b] += 1
    assert (stores == 1).all()
    return out.reshape(S, G * B, H, W)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("B", [1, 2, 5, 9])
def test_batched_private_ownership_matches_plain_and_jax(rng, B, split):
    """The private route's ownership (``batched_private_layout``: one
    (grid, bin) plane a block) to 1e-5 of the scale: on kernel inputs as no
    wrapper makes them (off-image coordinates, NaN, +-inf and huge bins,
    zero weights) and on masked rows with per-row ``t0``/``t1`` overrides
    (events pinned to either edge bin, ``t_norm = B-1`` exactly) against
    the plain version; on masked rows (an all-masked row, a row of one
    event) also against JAX's ``jax.vmap(voxel_matmul)`` in interpret mode
    (with ``split``, its vmap over the two polarity weightings). JAX's
    kernel truncates folded weights to bf16 scale (its ``voxel_matmul``
    comment), so the pinned rows are held against the plain version
    only."""
    S, n, H, W = 3, 300, 7, 6
    raw = raw_rows(rng, S, n, B, H, W)
    plain = cs.voxel_scatter_batched(*raw, B, H, W, split=split)
    with np.errstate(invalid="ignore"):
        got = batched_private_layout(*(a.numpy() for a in raw), B, H, W,
                                     split)
    assert_rel(plain, got, 1e-5)
    xs, ys, ts, ps, mask, t0, t1, _ = rows(rng, B=B)
    weights = [(ps > 0).astype(np.float32), (ps <= 0).astype(np.float32)] \
        if split else [ps]
    ref = np.concatenate([np.asarray(jax_batched(
        "masked", B, xs, ys, ts, w, mask, t0, t1)(
            jnp.asarray(ts), jnp.asarray(w))) for w in weights], 1)
    for over in ({}, {"t0": torch.as_tensor(t0), "t1": torch.as_tensor(t1)}):
        args = cs.voxel_inputs_batched(
            torch.as_tensor(xs), torch.as_tensor(ys), torch.as_tensor(ts),
            torch.as_tensor(ps), B, SENSOR, mask=torch.as_tensor(mask),
            split=split, **over)
        plain = cs.voxel_scatter_batched(*args, B, *SENSOR, split=split)
        got = batched_private_layout(*(a.numpy() for a in args), B,
                                     *SENSOR, split)
        assert_rel(plain, got, 1e-5)
        if not over:
            assert_rel(plain, ref, 1e-5)
            assert_rel(got, ref, 1e-5)


def test_batched_private_planes_fit_a_block():
    """A plane past 227 KB never goes 'private', and forcing it there
    raises; every plane that fits, the 128x128, 180x240 and 184x240 of the
    paths among them, serves the route."""
    for H, W in ((128, 128), (180, 240), (184, 240), (241, 241), (7, 6)):
        assert cs.voxel_private_fits(H, W)
        assert H * W * 4 <= cs.SHARED_MAX_BYTES
    for H, W in ((242, 241), (480, 640), (720, 1280)):
        assert not cs.voxel_private_fits(H, W)
        assert cs.voxel_batched_route(104, 20000, 5, H, W) != "private"
        assert cs.voxel_batched_route(96, 12288, 5, H, W, True) != "private"
        xs = torch.zeros((2, 3), dtype=torch.int32)
        t = torch.zeros((2, 3))
        with pytest.raises(P.errors.ConfigurationError):
            cs.voxel_scatter_batched(xs, xs, t, t, 5, H, W, route="private")
    # at the boundary (241 x 241 x 4 B = 232,324 B) the route serves
    xs, ys, t, ps = raw_rows(np.random.default_rng(3), 2, 40, 2, 241, 241)
    assert torch.equal(
        cs.voxel_scatter_batched(xs, ys, t, ps, 2, 241, 241, route="private"),
        cs.voxel_scatter_batched_plain(xs, ys, t, ps, 2, 241, 241))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_batched_route_and_chunk_by_shape():
    """The vector rule per row and per launch, and 'private' where it says
    'direct' for grids of at least 32 MB whose plane fits 227 KB; 'vector'
    keeps what it takes; one grid (S = 1) takes 'vector' where one
    reduction saved per event outweighs its scratch, else 'direct'; the
    scratch of one vector launch stays within 16 MB."""
    for n in (4096, 262144, 1 << 21):
        for sensor in ((180, 240), (480, 640), (720, 1280), (128, 128)):
            for B in (5, 9, 200):
                scratch = 2 * sensor[0] * sensor[1] * cs._voxel_scratch_bins(B)
                assert cs.voxel_batched_route(1, n, B, *sensor) == (
                    "vector" if cs._vector_pays(n, scratch) else "direct")
    assert cs.voxel_batched_chunk(5, 128, 128) == 21
    assert cs.voxel_batched_chunk(5, 180, 240) == 8
    assert cs.voxel_batched_chunk(5, 128, 128, split=True) == 10
    for B, H, W, split in ((5, 128, 128, False), (5, 180, 240, True),
                           (9, 720, 1280, False)):
        rows_ = cs.voxel_batched_chunk(B, H, W, split)
        assert rows_ * cs._voxel_row_scratch(B, H, W, split) * 4 <= \
            cs.VECTOR_MAX_SCRATCH_BYTES or rows_ == 1
    # the shapes of the smoke's voxel_batched path and the trainers', each
    # to the route that measured fastest there (tune part 12)
    assert cs.voxel_batched_route(104, 20000, 5, 180, 240) == "private"
    assert cs.voxel_batched_route(96, 12288, 5, 128, 128, True) == "private"
    assert cs.voxel_batched_route(8, 1 << 18, 5, 180, 240) == "vector"
    assert cs.voxel_batched_route(8, 32768, 5, 184, 240, True) == "direct"
    assert cs.voxel_batched_route(8, 65536, 5, 128, 128, True) == "direct"
    assert cs.voxel_batched_route(8, 65536, 5, 128, 128) == "vector"
    assert cs.voxel_batched_route(2, 65536, 5, 128, 128) == "direct"
    # the rule's edge: 32 MB of grids (tune part 12's "rule" rows)
    assert cs.voxel_batched_route(32, 4096, 5, 180, 240) == "direct"
    assert cs.voxel_batched_route(32, 20000, 5, 180, 240) == "direct"
    assert cs.voxel_batched_route(38, 4096, 5, 180, 240) == "direct"
    assert cs.voxel_batched_route(39, 4096, 5, 180, 240) == "private"
    assert cs.voxel_batched_route(48, 4096, 5, 128, 128, True) == "direct"
    assert cs.voxel_batched_route(51, 12288, 5, 128, 128, True) == "direct"
    assert cs.voxel_batched_route(52, 12288, 5, 128, 128, True) == "private"
    assert cs.voxel_batched_route(102, 4096, 5, 128, 128) == "direct"
    assert cs.voxel_batched_route(103, 4096, 5, 128, 128) == "private"
    # where the old rule takes 'vector', it keeps it at any size: 32 and
    # 104 DAVIS240 windows of 2^18 (vector 0.1936 ms, private 0.2303)
    assert cs.voxel_batched_route(32, 1 << 18, 5, 180, 240) == "vector"
    assert cs.voxel_batched_route(104, 1 << 18, 5, 180, 240) == "vector"
    # past 227 KB a plane keeps the single grid's rule at any size
    assert cs.voxel_batched_route(104, 20000, 5, 480, 640) == "direct"


def test_batched_wrapper_checks_and_launch_count_keys(rng):
    xs, ys, t, ps = raw_rows(rng, 2, 50, 3, 5, 6)
    for route in ("vector", "direct", "private"):
        assert torch.equal(
            cs.voxel_scatter_batched(xs, ys, t, ps, 3, 5, 6, route=route),
            cs.voxel_scatter_batched_plain(xs, ys, t, ps, 3, 5, 6))
        name = f"voxel_scatter_batched:{route}"
        assert name in cs.ROUTES
        assert cs.KERNEL_WRAPPERS[name] is cs.voxel_scatter_batched
        assert cs.launch_counts()[name] >= 0
    with pytest.raises(P.errors.ConfigurationError):
        cs.voxel_scatter_batched(xs, ys, t, ps, 3, 5, 6, route="single")
    with pytest.raises(P.errors.ConfigurationError):
        cs.voxel_scatter_batched(xs, ys, t, ps, 3, 480, 640, route="private")
    with pytest.raises(P.errors.ConfigurationError):
        cs.voxel_scatter_batched(xs[:1], ys, t, ps, 3, 5, 6)
    with pytest.raises(P.errors.ConfigurationError):
        cs.voxel_scatter_batched(xs.long(), ys, t, ps, 3, 5, 6)
    empty = cs.voxel_matmul_batched(xs[:, :0], ys[:, :0], t[:, :0],
                                    ps[:, :0], 3, (5, 6), split=True)
    assert empty.shape == (2, 6, 5, 6) and not empty.any()


# ---------------------------------------------------------------------------
# The trainers' rows: voxelize_batch, the E2VID windows
# ---------------------------------------------------------------------------

def padded_rows(rng, N=600):
    """Four padded rows as the simulator gives them: valid events first,
    time-sorted, pads with zero coordinates and polarity and the row's
    last valid stamp; a full row, a row with pads at the end, an
    all-masked row and a row of one event."""
    H, W = SENSOR
    ev = np.zeros((4, N, 4), np.float32)
    mask = np.zeros((4, N), np.float32)
    for b, c in enumerate((N, 350, 0, 1)):
        ev[b, :c, 0] = rng.integers(0, W, c)
        ev[b, :c, 1] = rng.integers(0, H, c)
        ev[b, :c, 2] = np.sort(rng.uniform(0.0, 0.5, c))
        ev[b, :c, 3] = rng.choice([-1.0, 1.0], c)
        ev[b, c:, 2] = ev[b, c - 1, 2] if c else 0.0
        mask[b, :c] = 1.0
    return ev, mask


def jax_voxelize(ev, mask, combined, B=5):
    """JAX's trainers' grids: ``jax.vmap`` of ``events_to_voxel`` /
    ``events_to_neg_pos_voxel`` over the masked rows."""
    def one(e, m):
        x, y, t, p = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
        if combined:
            return J.representations.events_to_voxel(
                x, y, t, p, B, sensor_size=SENSOR, mask=m)
        vp, vn = J.representations.events_to_neg_pos_voxel(
            x, y, t, p, B, sensor_size=SENSOR, mask=m)
        return jnp.concatenate([vp, vn], 0)
    return jax.vmap(one)(ev, mask)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("combined", [False, True])
def test_voxelize_batch_matches_jax(rng, calls, impl, combined):
    """One call for all rows: the batched voxel kernel under 'pallas'
    (both polarities at once), one flat scatter under 'xla'."""
    ev, mask = padded_rows(rng)
    ref = jax_voxelize(ev, mask, combined)
    prev = get_default_impl()
    set_default_impl(impl)
    try:
        got = itl.voxelize_batch(torch.as_tensor(ev), torch.as_tensor(mask),
                                 5, SENSOR, combined)
    finally:
        set_default_impl(prev)
    assert_rel(got, ref, 1e-5)
    assert float(got[2].abs().max()) == 0.0
    assert abs(float(got[3].sum())) == 1.0          # one event, weight 1
    pallas = impl == "pallas"
    assert calls == {"batched": int(pallas), "flat": int(not pallas),
                     "single": 0}


def sorted_rows(rng, N=400, T=5):
    """Rows as the simulator gives them, with stamps on the window edges,
    a row that ends inside the windows (pads reach into them), an empty
    row, a row of one event and a row whose last stamp is an edge."""
    bounds = torch.linspace(0.0, 0.5, T + 1)
    ts = np.zeros((5, N), np.float32)
    mask = np.zeros((5, N), np.float32)
    for b, c in enumerate((N, 250, 0, 1, 90)):
        last = 0.29 if b == 4 else 0.33
        t = np.sort(rng.uniform(0.0, last, c)).astype(np.float32)
        if c > 10:
            t[3] = 0.0                          # before the first window
            t[4:7] = bounds[1:4].numpy()        # on the edges
            t = np.sort(t)
        if b == 4:
            t[-1] = bounds[3]                   # the last stamp on an edge
        ts[b, :c] = t
        ts[b, c:] = t[-1] if c else 0.0
        mask[b, :c] = 1.0
    return torch.as_tensor(ts), torch.as_tensor(mask), bounds


def test_window_stamps_equal_the_scatter_reduce_ones(rng):
    """Read off the sorted rows, each window's first and last stamp are the
    ``scatter_reduce`` min and max over its events, bit for bit: empty
    windows (float32 max and -max) and windows that reach the pads too."""
    ts, mask, bounds = sorted_rows(rng)
    B, T = ts.shape[0], len(bounds) - 1
    t0, t1 = itl.window_stamps(ts, mask, bounds)
    w = torch.searchsorted(bounds, ts) - 1
    seg = torch.where((mask > 0) & (w >= 0) & (w < T),
                      w * B + torch.arange(B)[:, None], -1)
    r0, r1 = vg.segment_windows(ts.reshape(-1), seg.reshape(-1), T * B)
    assert torch.equal(t0.t().reshape(-1), r0)
    assert torch.equal(t1.t().reshape(-1), r1)
    big = torch.finfo(torch.float32).max
    assert (r0 == big).any() and (r0 < big).any()   # empty windows, and not


@pytest.mark.parametrize("combined", [False, True])
def test_recon_batch_windows_from_sorted_rows(monkeypatch, combined):
    """``simulate_recon_scenes`` hands its segment route each window's
    stamps from ``window_stamps``: bitwise the ``scatter_reduce`` ones of
    its own segments (saturated and padded scenes), and the grids those
    give."""
    kept = []
    real = itl.events_to_neg_pos_voxel_segments

    def keep(*a, **kw):
        kept.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(itl, "events_to_neg_pos_voxel_segments", keep)
    scenes = itl.draw_scenes(5, 2, 3, SENSOR, omega_max=4.0, s_max=0.3)
    for capacity in (6000, 400):
        kept.clear()
        voxels, _, sat = itl.simulate_recon_scenes(
            scenes, capacity, 3, combined=combined, return_saturation=True,
            device="cpu")
        (a, kw), = kept
        r0, r1 = vg.segment_windows(a[2], a[4], a[5])
        assert torch.equal(kw["t0"], r0) and torch.equal(kw["t1"], r1)
        again = real(*a, **dict(kw, t0=None, t1=None))
        assert torch.equal(voxels.reshape(again.shape), again)
    assert sat.any()


def test_segments_take_each_window_once(monkeypatch, rng):
    """The polarity pair reads the per-segment stamps once, and not at all
    when they are given."""
    n = 2000
    xs, ys = (torch.as_tensor(rng.integers(0, s, n), dtype=torch.float32)
              for s in (SENSOR[1], SENSOR[0]))
    ts = torch.as_tensor(np.sort(rng.uniform(0, 1, n)), dtype=torch.float32)
    ps = torch.as_tensor(rng.choice([-1.0, 1.0], n), dtype=torch.float32)
    seg = torch.as_tensor(rng.integers(-1, 6, n))
    count = [0]
    real = vg.segment_windows

    def counted(*a):
        count[0] += 1
        return real(*a)

    monkeypatch.setattr(vg, "segment_windows", counted)
    want = vg.events_to_neg_pos_voxel_segments(xs, ys, ts, ps, seg, 5, 4,
                                               SENSOR)
    assert count[0] == 1
    t0, t1 = real(ts, seg, 5)
    got = vg.events_to_neg_pos_voxel_segments(xs, ys, ts, ps, seg, 5, 4,
                                              SENSOR, t0=t0, t1=t1)
    assert count[0] == 1 and torch.equal(got, want)


def test_no_trainer_reaches_scatter_reduce(monkeypatch, rng):
    """``fit``'s grids, the in-the-loop flow and E2VID batches and their
    evals run without a ``scatter_reduce``, under 'pallas' and 'xla'."""
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                ReconstructionTrainer)

    def refuse(*a, **kw):
        raise AssertionError("scatter_reduce on a trainer's path")

    monkeypatch.setattr(torch.Tensor, "scatter_reduce", refuse)
    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", refuse)
    monkeypatch.setattr(torch, "scatter_reduce", refuse)
    ev, mask = padded_rows(rng)
    prev = get_default_impl()
    try:
        for impl in ("pallas", "xla"):
            set_default_impl(impl)
            flow = FlowTrainer((32, 32), learning_rate=1e-4, device="cpu")
            flow.fit([{"events": ev[:, :, [0, 1, 2, 3]],
                       "events_mask": mask}], log_every=0)
            itl.train_flow_in_the_loop(flow, 1, batch_size=2, capacity=2000,
                                       eval_every=1, log_every=0,
                                       log_fn=lambda s: None)
            recon = ReconstructionTrainer(
                (32, 32), model_kwargs={"base_features": 8,
                                        "recurrent_levels": 3,
                                        "num_res_blocks": 1}, device="cpu")
            itl.train_reconstruction_in_the_loop(
                recon, 1, batch_size=2, seq_len=2, capacity=3000,
                eval_every=1, log_every=0, log_fn=lambda s: None)
    finally:
        set_default_impl(prev)
