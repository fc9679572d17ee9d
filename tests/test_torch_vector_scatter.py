"""The contract of the voxel and flat kernels' two routes, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against their plain versions there). Here the
same edge cases go through the plain versions, which are the kernels'
reference, and are held against the JAX package: ``voxel_matmul`` and
``scatter_add_flat_pallas`` with their Pallas kernels in interpret mode, and
the exact XLA route. The scratch layouts of the vector routes (two
bins-innermost accumulators for the voxel grid, a rows-innermost one for
the flat scatter) are written out in numpy with the wrappers' own sizes, so
that their column arithmetic is checked without a card. Then the dispatch:
``voxel_batched_route`` at one grid / ``flat_route`` at the measured
thresholds, forced routes, and the launch counters' keys.

Tolerances, relative to the output's max |value|: 1e-5 against exact f32
sums; 3e-5 against the JAX one-hot-matmul kernels at 'hilo' precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu.ops import pallas_scatter as jps
from event_utils_tpu_torch.ops import cuda_scatter as cs

torch.set_num_threads(1)

SENSOR = (24, 32)
F32_REL = 1e-5
HILO_REL = 3e-5


def assert_rel(got, ref, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    err = float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def stream(rng, n=3000):
    H, W = SENSOR
    xs = rng.integers(-2, W + 2, n)
    ys = rng.integers(-2, H + 2, n)
    ts = np.sort(rng.uniform(0, 0.5, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return xs, ys, ts, ps


def port_voxel(xs, ys, ts, ps, B, route=None, **kw):
    """``voxel_matmul``'s preprocessing, then the kernel wrapper (on the CPU:
    its plain version)."""
    args = cs.voxel_inputs(*(torch.as_tensor(a) for a in (xs, ys, ts, ps)), B,
                           SENSOR, **kw)
    return cs.voxel_scatter(*args, B, *SENSOR, route=route)


# ---------------------------------------------------------------------------
# Voxel grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 4, 5, 9])
@pytest.mark.parametrize("case", ["window", "pinned", "all_masked"])
def test_voxel_plain_matches_jax_kernel(rng, B, case):
    """Even and odd bin counts and a single bin; a ``t1`` override that pins
    half the stream to ``t_norm = B-1`` exactly (its second tap has no
    bin); every event masked."""
    xs, ys, ts, ps = stream(rng)
    kw = {}
    if case == "pinned":
        kw["t1"] = float(ts[len(ts) // 2])
    if case == "all_masked":
        kw.update(mask=np.zeros(len(ts), np.float32), t0=0.0, t1=0.5)
    jkw = {k: (jnp.asarray(v) if k == "mask" else v) for k, v in kw.items()}
    pkw = {k: (torch.as_tensor(v) if k == "mask" else v)
           for k, v in kw.items()}
    got = port_voxel(xs, ys, ts, ps, B, **pkw)
    if case == "pinned":
        t_norm = cs.voxel_inputs(*(torch.as_tensor(a) for a in
                                   (xs, ys, ts, ps)), B, SENSOR, **pkw)[2]
        assert int((t_norm == B - 1).sum()) >= len(ts) // 2 - 1
    if case == "all_masked":
        assert float(got.abs().max()) == 0.0
    exact = np.asarray(J.representations.events_to_voxel(
        xs, ys, ts, ps, B, SENSOR, **jkw))
    assert_rel(got, exact, F32_REL)
    jref = np.asarray(jps.voxel_matmul(xs, ys, ts, ps, B, SENSOR, chunk=512,
                                       interpret=True, **jkw))
    assert_rel(got, jref, HILO_REL)


def test_voxel_plain_takes_unsorted_events(rng):
    """The kernels need no time order (the JAX kernel does): a shuffled
    stream gives the sorted stream's grid, and the exact XLA route's."""
    xs, ys, ts, ps = stream(rng)
    window = dict(t0=float(ts[0]), t1=float(ts[-1]))
    perm = rng.permutation(len(ts))
    got = port_voxel(xs[perm], ys[perm], ts[perm], ps[perm], 5, **window)
    assert_rel(got, port_voxel(xs, ys, ts, ps, 5, **window), F32_REL)
    assert_rel(got, np.asarray(J.representations.events_to_voxel(
        xs, ys, ts, ps, 5, SENSOR)), F32_REL)


def voxel_vector_layout(xs, ys, t_norm, ps, B, H, W):
    """What the vector route's two kernels compute, step by step in numpy:
    one pair of adjacent columns per event in one of two bins-innermost
    accumulators of ``_voxel_scratch_bins(B)`` columns, then ``out[b] =
    first[:, b] + second[:, b + 1]``."""
    Bp = cs._voxel_scratch_bins(B)
    acc = np.zeros((2, H * W, Bp))
    for x, y, t, p in zip(xs, ys, t_norm, ps):
        if p == 0 or not (0 <= x < W and 0 <= y < H):
            continue
        b0 = np.floor(t)
        if not (b0 >= -1 and b0 < B):        # NaN fails both
            continue
        odd = int(b0) & 1
        col = int(b0) + odd
        assert col % 2 == 0 and 0 <= col and col + 1 < Bp, (B, b0, Bp)
        acc[odd, y * W + x, col] += p * (1 - (t - b0))
        acc[odd, y * W + x, col + 1] += p * (t - b0)
    out = acc[0, :, :B] + acc[1, :, 1:B + 1]
    return out.T.reshape(B, H, W)


@pytest.mark.parametrize("B", [1, 2, 4, 5, 9])
def test_voxel_raw_bins_and_the_vector_layout(rng, B):
    """Bin coordinates that no wrapper makes reach the kernels too: a first
    bin of -1 keeps its second tap, ``t_norm = B-1`` keeps its first, NaN,
    +-inf and +-1e30 are dropped. The plain version and the vector route's
    scratch layout agree on all of them."""
    H, W = 6, 7
    n = 2000
    xs = rng.integers(-1, W + 1, n).astype(np.int32)
    ys = rng.integers(-1, H + 1, n).astype(np.int32)
    t = rng.uniform(-2.5, B + 1.5, n).astype(np.float32)
    t[::9] = B - 1
    t[1::9] = -1.0
    t[2::9] = -0.25
    t[3::9] = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30])[
        np.arange(len(t[3::9])) % 5]
    ps = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    got = cs.voxel_scatter(*(torch.as_tensor(a) for a in (xs, ys, t, ps)), B,
                           H, W)
    with np.errstate(invalid="ignore"):
        ref = voxel_vector_layout(xs, ys, t, ps, B, H, W)
    assert_rel(got, ref, F32_REL)
    # one event at the first bin -1, one at the last bin: half a tap each
    one = cs.voxel_scatter_plain(
        torch.tensor([3, 3], dtype=torch.int32),
        torch.tensor([2, 2], dtype=torch.int32),
        torch.tensor([-0.5, B - 0.5]), torch.tensor([1.0, 1.0]), B, H, W)
    assert float(one.sum()) == float(one[:, 2, 3].sum()) == 1.0
    assert float(one[0, 2, 3]) == float(one[B - 1, 2, 3]) == (
        1.0 if B == 1 else 0.5)


# ---------------------------------------------------------------------------
# Flat scatter
# ---------------------------------------------------------------------------

def flat_case(rng, D, n=3000, nb=700):
    idx = rng.integers(-10, nb + 10, n).astype(np.int32)
    idx[::17] = -1
    idx[5::19] = nb
    w = rng.normal(0, 1, (D, n)).astype(np.float32)
    w[:, ::3] = 0.0                      # ids whose D weights are all zero
    if D > 1:
        w[0, 1::3] = 0.0                 # ids with some zero rows
    if D > 2:
        w[D - 1] = 0.0                   # and one row that is all zero
    return idx, w, nb


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5])
def test_flat_plain_matches_jax_kernel(rng, D):
    idx, w, nb = flat_case(rng, D)
    got = cs.flat_scatter(torch.as_tensor(idx), torch.as_tensor(w), nb)
    exact = np.zeros((D, nb))
    ok = (idx >= 0) & (idx < nb)
    for d in range(D):
        np.add.at(exact[d], idx[ok], w[d, ok])
    assert_rel(got, exact, F32_REL)
    jref = np.stack([np.asarray(jps.scatter_add_flat_pallas(idx, w[d], nb,
                                                            chunk=1024))
                     for d in range(D)])
    assert_rel(got, jref, HILO_REL)
    # only out-of-range ids: nothing lands, nothing wraps
    bad = torch.tensor([-1, -nb, nb, nb + 7], dtype=torch.int32)
    assert float(cs.flat_scatter(bad, torch.ones(D, 4), nb).abs().sum()) == 0


@pytest.mark.parametrize("D", [2, 3, 4, 5, 9])
def test_flat_vector_layout(rng, D):
    """What the vector route's two kernels compute, step by step in numpy:
    groups of V weights of one id into a rows-innermost scratch of
    ``_flat_scratch_rows(D)`` columns, all-zero groups skipped, then the
    transpose of its first D columns."""
    idx, w, nb = flat_case(rng, D)
    Dp = cs._flat_scratch_rows(D)
    V = 2 if D == 2 else 4
    assert Dp % V == 0 and D <= Dp < D + V
    scratch = np.zeros((nb, Dp))
    padded = np.concatenate([w, np.zeros((Dp - D, w.shape[1]), np.float32)])
    for i, b in enumerate(idx):
        if not 0 <= b < nb:
            continue
        for g in range(0, Dp, V):
            if np.any(padded[g:g + V, i] != 0):
                scratch[b, g:g + V] += padded[g:g + V, i]
    assert not scratch[:, D:].any()          # the pad columns stay zero
    assert_rel(cs.flat_scatter_plain(torch.as_tensor(idx),
                                     torch.as_tensor(w), nb),
               scratch[:, :D].T, F32_REL)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_voxel_route_thresholds():
    """The measured crossovers: 262144 events at 180x240 (131072 lost); at
    VGA the scratch of 3.7M floats needs ~920k events; at 720p the 44 MB of
    scratch never pay. One grid is the batched rule's S = 1."""
    def route(n, B, H, W):
        return cs.voxel_batched_route(1, n, B, H, W)

    assert route(131072, 5, 180, 240) == "direct"
    assert route(262143, 5, 180, 240) == "direct"
    assert route(262144, 5, 180, 240) == "vector"
    assert route(1 << 21, 5, 180, 240) == "vector"
    assert route(1 << 21, 9, 180, 240) == "vector"
    assert route(524288, 5, 480, 640) == "direct"
    assert route(1 << 21, 5, 480, 640) == "vector"
    assert route(1 << 21, 5, 720, 1280) == "direct"
    assert route(1 << 24, 5, 720, 1280) == "direct"
    assert route(0, 5, 180, 240) == "direct"
    # the scratch: even, and one column past the last pair of either parity
    assert [cs._voxel_scratch_bins(B) for B in (1, 2, 3, 4, 5, 9)] == [
        2, 4, 4, 6, 6, 10]


def test_flat_route_thresholds():
    """One row has nothing to pair; D = 2 pays from 262144 ids on (one
    request saved per id); more rows save more requests per id."""
    nb = 181 * 241
    assert cs.flat_route(1, 1 << 21, 180 * 240) == "direct"
    assert cs.flat_route(2, 131072, nb) == "direct"
    assert cs.flat_route(2, 262144, nb) == "vector"
    assert cs.flat_route(2, 800_000, nb) == "vector"
    assert cs.flat_route(3, 100_000, nb) == "direct"
    assert [cs.flat_route(D, 200_000, nb) for D in (3, 4, 5, 8)] == [
        "vector"] * 4
    assert cs.flat_route(2, 262144, 1 << 22) == "direct"   # 32 MB of scratch
    assert [cs._flat_scratch_rows(D) for D in (2, 3, 4, 5, 8, 9)] == [
        2, 4, 4, 8, 8, 12]


def test_forced_routes_and_launch_count_keys(rng):
    """``route=`` takes a route the shape allows (on the CPU the plain
    version answers either way) and raises for any other; the counters are
    keyed by route and stay at 0 without a card. One grid is the batched
    wrapper at S = 1, so its bin plane of 24x32 allows 'private' too; a
    plane past 227 KB does not."""
    xs, ys, ts, ps = stream(rng, 200)
    ref = port_voxel(xs, ys, ts, ps, 5)
    for route in ("vector", "direct", "private"):
        assert torch.equal(port_voxel(xs, ys, ts, ps, 5, route=route), ref)
    with pytest.raises(P.errors.ConfigurationError):
        port_voxel(xs, ys, ts, ps, 5, route="rows")
    args = cs.voxel_inputs(*(torch.as_tensor(a) for a in (xs, ys, ts, ps)), 5,
                           SENSOR)
    with pytest.raises(P.errors.ConfigurationError):
        cs.voxel_scatter(*args, 5, 300, 300, route="private")
    idx, w, nb = flat_case(rng, 2, n=200)
    idx, w = torch.as_tensor(idx), torch.as_tensor(w)
    for route in ("vector", "direct"):
        assert torch.equal(cs.flat_scatter(idx, w, nb, route=route),
                           cs.flat_scatter_plain(idx, w, nb))
    with pytest.raises(P.errors.ConfigurationError):   # one row cannot pair
        cs.flat_scatter(idx, w[:1].contiguous(), nb, route="vector")
    with pytest.raises(P.errors.ConfigurationError):
        cs.flat_scatter(idx, w, nb, route="rows")
    cs.reset_launch_counts()
    cs.voxel_matmul(*(torch.as_tensor(a) for a in (xs, ys, ts, ps)), 5,
                    SENSOR)
    cs.scatter_add_flat_cuda(idx, w, nb)
    counts = cs.launch_counts()
    assert {"voxel_scatter_batched:vector", "voxel_scatter_batched:direct",
            "flat_scatter:vector", "flat_scatter:direct"} <= set(counts)
    assert not any(k.startswith("voxel_scatter:") for k in counts)
    assert "voxel_scatter" not in counts and "flat_scatter" not in counts
    assert all(cs.KERNEL_WRAPPERS[f"voxel_scatter_batched:{r}"]
               is cs.voxel_scatter_batched
               and cs.KERNEL_WRAPPERS[f"flat_scatter:{r}"] is cs.flat_scatter
               for r in ("vector", "direct"))
    assert not any(counts.values())


@pytest.mark.parametrize("route", ["vector", "direct"])
def test_gradients_do_not_depend_on_the_route(rng, route, monkeypatch):
    """The autograd backwards are gathers that never see the route: with
    either forced, ``voxel_matmul`` and ``scatter_add_flat_cuda`` give the
    gradients of the JAX package's kernels."""
    import jax
    xs, ys, ts, ps = stream(rng, 500)
    B = 4
    tgt = rng.normal(size=(B,) + SENSOR).astype(np.float32)
    monkeypatch.setattr(cs, "voxel_batched_route", lambda *a: route)
    monkeypatch.setattr(cs, "flat_route", lambda *a: route)

    def jloss(t, p):
        return jnp.sum(jps.voxel_matmul(xs, ys, t, p, B, SENSOR, chunk=256,
                                        interpret=True) * tgt)

    jgt, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ts),
                                               jnp.asarray(ps))
    tt = torch.tensor(ts, requires_grad=True)
    pt = torch.tensor(ps, requires_grad=True)
    v = cs.voxel_matmul(torch.as_tensor(xs), torch.as_tensor(ys), tt, pt, B,
                        SENSOR)
    gt, gp = torch.autograd.grad((v * torch.as_tensor(tgt)).sum(), (tt, pt))
    assert_rel(gp, np.asarray(jgp), 1e-4)
    assert_rel(gt, np.asarray(jgt), 1e-4)

    idx, w, nb = flat_case(rng, 3, n=300, nb=55)
    g = rng.normal(size=(3, nb)).astype(np.float32)
    wt = torch.tensor(w, requires_grad=True)
    (gw,) = torch.autograd.grad(
        (cs.scatter_add_flat_cuda(torch.as_tensor(idx), wt, nb)
         * torch.as_tensor(g)).sum(), (wt,))
    ok = (idx >= 0) & (idx < nb)
    assert np.array_equal(gw.numpy(),
                          np.where(ok[None], g[:, np.clip(idx, 0, nb - 1)], 0))
