"""The port's CUDA kernels on the card, against their plain versions.

Card-only: every test here carries the ``cuda`` marker and skips without a
CUDA device (the kernels have no CPU mode; the CPU tests cover the plain
versions against the JAX package). The file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the output's max |value| — float atomics change only
the order of the f32 sums.
"""

import os

import numpy as np
import pytest
import torch

from event_utils_tpu_torch.ops import cuda_scatter as cs

REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(7)


def assert_rel(got, ref):
    err = float((got - ref).abs().max())
    assert err <= REL * max(float(ref.abs().max()), 1.0), err


@pytest.mark.cuda
def test_bilinear_kernel_matches_plain_and_counts(cuda, gen):
    H, W, n = 181, 241, 50_000
    x = torch.as_tensor(gen.uniform(-2, W + 1, n), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, H + 1, n), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=(4, n)), dtype=torch.float32,
                        device=cuda)
    # K=4 at 181x241 exceeds a block's shared memory: at 50,000 events the
    # route that part 11 of the tune script measured fastest
    route = ("bilinear_scatter_batched:"
             f"{cs.bilinear_batched_route(4, H, W, n)}")
    assert route == "bilinear_scatter_batched:vector"
    before = cs.launch_counts()[route]
    assert_rel(cs.bilinear_scatter(x, y, w, H, W),
               cs.bilinear_scatter_plain(x, y, w, H, W))
    assert cs.launch_counts()[route] == before + 1


@pytest.mark.cuda
def test_flat_kernel_matches_plain_and_drops(cuda, gen):
    nb, n = 181 * 241, 50_000
    idx = torch.as_tensor(gen.integers(-5, nb + 5, n), dtype=torch.int32,
                          device=cuda)
    w = torch.as_tensor(gen.normal(size=(2, n)), dtype=torch.float32,
                        device=cuda)
    assert_rel(cs.flat_scatter(idx, w, nb), cs.flat_scatter_plain(idx, w, nb))
    bad = torch.tensor([-1, nb], dtype=torch.int32, device=cuda)
    assert float(cs.flat_scatter(bad, torch.ones(1, 2, device=cuda), nb)
                 .abs().sum()) == 0.0


@pytest.mark.cuda
def test_voxel_kernel_matches_plain_with_overrides(cuda, gen):
    n, B, H, W = 100_000, 5, 180, 240
    xs = torch.as_tensor(gen.integers(-2, W + 2, n), device=cuda)
    ys = torch.as_tensor(gen.integers(-2, H + 2, n), device=cuda)
    ts = torch.sort(torch.rand(n, device=cuda)).values
    ps = torch.as_tensor(gen.choice([-1.0, 1.0], n), dtype=torch.float32,
                         device=cuda)
    mask = torch.rand(n, device=cuda) > 0.3
    for kw in ({}, {"mask": mask}, {"t0": 0.1, "t1": 0.6}):
        args = cs.voxel_inputs(xs, ys, ts, ps, B, (H, W), **kw)
        assert_rel(cs.voxel_scatter(*args, B, H, W),
                   cs.voxel_scatter_plain(*args, B, H, W))


@pytest.mark.cuda
def test_voxel_tiles_kernel_matches_plain(cuda, gen):
    """T*cap not a multiple of the 256-thread block, out-of-tile and dead
    slots, a mask, a window override, and slots at t_norm == B-1 exactly
    (the second tap must vanish)."""
    T, cap, B, th, tw = 7, 1001, 5, 96, 128
    shape = (T, cap)
    bx = torch.as_tensor(gen.integers(-3, tw + 3, shape), device=cuda)
    by = torch.as_tensor(gen.integers(-3, th + 3, shape), device=cuda)
    bt = torch.sort(torch.rand(shape, device=cuda), dim=1).values
    bt[:, -5:] = 1.0
    bp = torch.as_tensor(gen.choice([-1.0, 1.0], shape), dtype=torch.float32,
                         device=cuda)
    mask = (torch.rand(shape, device=cuda) > 0.2).float()
    for kw in ({"t0": 0.0, "t1": 1.0}, {"t0": 0.0, "t1": 1.0, "mask": mask},
               {"t0": 0.2, "t1": 0.7}):
        args = cs.voxel_tiles_inputs(bx, by, bt, bp, B, (th, tw), **kw)
        before = cs.launch_counts()["voxel_tiles_scatter:private"]
        got = cs.voxel_tiles_scatter(*args, B, th, tw)
        assert cs.launch_counts()["voxel_tiles_scatter:private"] == before + 1
        assert got.shape == (T, B, th, tw)
        assert_rel(got, cs.voxel_tiles_scatter_plain(*args, B, th, tw))
    # one slot exactly at the last bin: all of its weight lands in bin B-1
    one = [torch.tensor([[v]], dtype=dt, device=cuda) for v, dt in
           ((3, torch.int32), (4, torch.int32), (float(B - 1), torch.float32),
            (1.0, torch.float32))]
    out = cs.voxel_tiles_scatter(*one, B, th, tw)
    assert float(out[0, B - 1, 4, 3]) == 1.0 and float(out.sum()) == 1.0


@pytest.mark.cuda
def test_autograd_through_kernels_matches_plain_route(cuda, gen):
    from event_utils_tpu_torch.ops.scatter import bilinear_scatter
    n = 20_000
    x = torch.as_tensor(gen.uniform(0, 60, n), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(0, 40, n), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=n), dtype=torch.float32, device=cuda)
    tgt = torch.randn(41, 61, device=cuda)
    grads = []
    for impl in ("matmul", "xla"):
        leaves = [a.clone().requires_grad_(True) for a in (x, y, w)]
        loss = (bilinear_scatter(*leaves, (41, 61), impl=impl) * tgt).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), 1.0), err


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda, gen):
    from event_utils_tpu_torch.representations import events_to_voxel
    xs = gen.integers(0, 240, 1000)
    out = events_to_voxel(xs, xs % 180, np.sort(gen.random(1000)),
                          np.ones(1000), 3, impl="matmul")
    assert out.device.type == "cuda"


@pytest.mark.cuda
def test_tiled_voxel_and_roi_solver_on_the_card(cuda, gen):
    """The ROI-bucketed path end to end on the card: the tiled voxel grid
    against the exact route, and a small grid_cmax_batched whose patch
    losses go through the bilinear kernel."""
    from event_utils_tpu_torch.contrast_max import grid_cmax_batched
    from event_utils_tpu_torch.representations import events_to_voxel
    n, H, W = 50_000, 200, 300
    xs = gen.integers(0, W, n)
    ys = gen.integers(0, H, n)
    ts = np.sort(gen.random(n))
    ps = gen.choice([-1.0, 1.0], n)
    cs.reset_launch_counts()
    tiled = events_to_voxel(xs, ys, ts, ps, 5, (H, W), impl="tiled")
    assert cs.launch_counts()["voxel_tiles_scatter:private"] == 1
    assert_rel(tiled, events_to_voxel(xs, ys, ts, ps, 5, (H, W), impl="xla"))
    m = 8000
    px = gen.uniform(5, 50, 40)
    py = gen.uniform(5, 35, 40)
    idx = gen.integers(0, 40, m)
    t = np.sort(gen.uniform(0, 0.5, m))
    params, rois, f, valid = grid_cmax_batched(
        px[idx] + 10 * t, py[idx] - 6 * t, t, np.ones(m), roi_size=(20, 20),
        img_size=(40, 60), maxiter=20)
    assert params.device.type == "cuda" and bool(valid.all())
    # 6 ROIs: too few patches for the patch kernel, the direct patch route
    assert cs.launch_counts()["bilinear_patches_scatter:direct"] > 0
    med = params.median(dim=0).values.cpu().numpy()
    np.testing.assert_allclose(med, [10.0, -6.0], atol=2.0)


# ---------------------------------------------------------------------------
# The routes that keep their output in shared memory
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("route,n", [("private", 777), ("private", 30_001),
                                     ("direct", 30_001)])
def test_bilinear_routes_match_plain(cuda, gen, route, n):
    """Odd sizes: an image of 37x53 pixels (not a multiple of 4 floats, so
    the bulk copy leaves a tail), K=3, event counts that fill no block; at
    777 events the private kernel runs one block, which stores its image
    into an uninitialised output."""
    H, W, K = 37, 53, 3
    x = torch.as_tensor(gen.uniform(-2, W + 1, n), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, H + 1, n), dtype=torch.float32,
                        device=cuda)
    x[::13] = float("nan")
    y[5::17] = 1e30
    w = torch.as_tensor(gen.normal(size=(K, n)), dtype=torch.float32,
                        device=cuda)
    before = cs.launch_counts()[f"bilinear_scatter_batched:{route}"]
    assert_rel(cs.bilinear_scatter(x, y, w, H, W, route=route),
               cs.bilinear_scatter_plain(x, y, w, H, W))
    assert (cs.launch_counts()[f"bilinear_scatter_batched:{route}"]
            == before + 1)


@pytest.mark.cuda
def test_bilinear_route_is_chosen_by_shape(cuda, gen):
    from event_utils_tpu_torch.errors import ConfigurationError
    assert cs.bilinear_batched_route(1, 181, 241, 2000) == "direct"
    assert cs.bilinear_batched_route(1, 181, 241, 200_000) == "private"
    assert cs.bilinear_batched_route(1, 41, 61, 32768) == "direct"
    assert cs.bilinear_batched_route(4, 181, 241, 200_000) == "vector"
    n = 100
    x = torch.rand(n, device=cuda) * 200
    w = torch.ones(4, n, device=cuda)
    with pytest.raises(ConfigurationError):   # 697 KB cannot be private
        cs.bilinear_scatter(x, x, w, 181, 241, route="private")


@pytest.mark.cuda
@pytest.mark.parametrize("P,C,PH,PW,K,route", [
    (7, 1000, 24, 40, 3, "patch"), (7, 1000, 24, 40, 3, "direct"),
    (3, 501, 19, 23, 1, "patch"), (800, 64, 16, 16, 2, None),
    (5, 300, 64, 128, 8, "patch"), (2, 4000, 240, 256, 2, None)])
def test_bilinear_patches_kernel_matches_plain(cuda, gen, P, C, PH, PW, K,
                                               route):
    """Ragged runs on both routes, a plane that is no multiple of 4 floats,
    enough patches for the patch route to be chosen, many channels, and a
    plane past shared memory (the direct route)."""
    x = torch.as_tensor(gen.uniform(-2, PW + 1, P * C), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, PH + 1, P * C), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=(K, P * C)), dtype=torch.float32,
                        device=cuda)
    took = route or cs.bilinear_patches_route(P, PH, PW)
    assert took == {800: "patch", 2: "direct"}.get(P, route)
    name = "bilinear_patches_scatter" + (":direct" if took == "direct"
                                         else "")
    before = cs.launch_counts()[name]
    got = cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW, route=route)
    assert cs.launch_counts()[name] == before + 1
    assert got.shape == (K, P, PH, PW)
    assert_rel(got, cs.bilinear_patches_scatter_plain(x, y, w, P, C, PH, PW))


@pytest.mark.cuda
def test_bilinear_patches_gradients_match_plain(cuda, gen):
    P, C, PH, PW, K = 6, 700, 24, 40, 2
    x = torch.as_tensor(gen.uniform(-1, PW, P * C), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-1, PH, P * C), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=(K, P * C)), dtype=torch.float32,
                        device=cuda)
    tgt = torch.randn(K, P, PH, PW, device=cuda)
    grads = []
    patch = lambda *a: cs.bilinear_patches_scatter(*a, route="patch")
    for fn in (patch, cs.bilinear_patches_scatter_plain):
        leaves = [a.clone().requires_grad_(True) for a in (x, y, w)]
        grads.append(torch.autograd.grad(
            (fn(*leaves, P, C, PH, PW) * tgt).sum(), leaves))
    for a, b in zip(*grads):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), 1.0), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,th,tw,route", [(5, 96, 128, "private"),
                                           (9, 33, 47, "private"),
                                           (1, 96, 128, "private"),
                                           (3, 240, 256, "direct")])
def test_voxel_tiles_routes_match_plain_unsorted(cuda, gen, B, th, tw, route):
    """Unsorted slots, more bins than any caller uses (9), a plane that is
    no multiple of 4 floats, and a plane past shared memory."""
    T, cap = 5, 1777
    shape = (T, cap)
    bx = torch.as_tensor(gen.integers(-3, tw + 3, shape), device=cuda)
    by = torch.as_tensor(gen.integers(-3, th + 3, shape), device=cuda)
    bt = torch.rand(shape, device=cuda)            # not sorted
    bp = torch.as_tensor(gen.choice([-1.0, 1.0], shape), dtype=torch.float32,
                         device=cuda)
    assert cs.voxel_tiles_route(B, th, tw) == route
    args = cs.voxel_tiles_inputs(bx, by, bt, bp, B, (th, tw), t0=0.1, t1=0.9)
    before = cs.launch_counts()[f"voxel_tiles_scatter:{route}"]
    got = cs.voxel_tiles_scatter(*args, B, th, tw)
    assert cs.launch_counts()[f"voxel_tiles_scatter:{route}"] == before + 1
    assert_rel(got, cs.voxel_tiles_scatter_plain(*args, B, th, tw))


# ---------------------------------------------------------------------------
# The voxel and flat kernels' routes: vector reductions and direct
# ---------------------------------------------------------------------------

def _voxel_stream(cuda, gen, n, H, W):
    xs = torch.as_tensor(gen.integers(-2, W + 2, n), device=cuda)
    ys = torch.as_tensor(gen.integers(-2, H + 2, n), device=cuda)
    ts = torch.sort(torch.rand(n, device=cuda)).values
    ps = torch.as_tensor(gen.choice([-1.0, 1.0], n), dtype=torch.float32,
                         device=cuda)
    return xs, ys, ts, ps


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["vector", "direct"])
@pytest.mark.parametrize("B", [1, 4, 5, 9])
def test_voxel_routes_match_plain(cuda, gen, route, B):
    """Even and odd bin counts and one bin, on a sensor whose pixel count is
    odd: the whole window, a mask, a ``t1`` override that pins a third of
    the stream to ``t_norm = B-1`` exactly, unsorted events, and every
    event masked (an exact zero grid)."""
    n, H, W = 70_001, 45, 67
    xs, ys, ts, ps = _voxel_stream(cuda, gen, n, H, W)
    mask = torch.rand(n, device=cuda) > 0.3
    perm = torch.randperm(n, device=cuda)
    cases = [cs.voxel_inputs(xs, ys, ts, ps, B, (H, W), **kw)
             for kw in ({}, {"mask": mask}, {"t1": float(ts[2 * n // 3])},
                        {"t0": 0.2, "t1": 0.7})]
    assert int((cases[2][2] == B - 1).sum()) >= n // 3
    cases.append([a[perm].contiguous() for a in cases[0]])
    for args in cases:
        name = f"voxel_scatter_batched:{route}"
        before = cs.launch_counts()[name]
        got = cs.voxel_scatter(*args, B, H, W, route=route)
        assert cs.launch_counts()[name] == before + 1
        assert got.shape == (B, H, W) and got.is_contiguous()
        assert_rel(got, cs.voxel_scatter_plain(*args, B, H, W))
    none = cs.voxel_inputs(xs, ys, ts, ps, B, (H, W),
                           mask=torch.zeros_like(mask), t0=0.0, t1=1.0)
    assert float(cs.voxel_scatter(*none, B, H, W, route=route).abs().max()) \
        == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["vector", "direct"])
def test_voxel_routes_drop_odd_bins(cuda, gen, route):
    """Bin coordinates that no wrapper makes: NaN, +-inf, +-1e30 and bins
    from B on are dropped, never wrapped; a first bin of -1 keeps its second
    tap and ``t_norm = B-1`` its first."""
    n, B, H, W = 50_000, 5, 40, 60
    xs, ys, ts, ps = _voxel_stream(cuda, gen, n, H, W)
    x, y, t_norm, p = cs.voxel_inputs(xs, ys, ts, ps, B, (H, W))
    odd = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                        -1e30, -0.25, -1.0, -1.5, B - 0.5, float(B), 2.0 ** 31,
                        -2.0 ** 31], device=cuda)
    t_norm = t_norm.clone()
    t_norm[::3] = odd[torch.arange(len(t_norm[::3]), device=cuda) % len(odd)]
    assert_rel(cs.voxel_scatter(x, y, t_norm, p, B, H, W, route=route),
               cs.voxel_scatter_plain(x, y, t_norm, p, B, H, W))
    one = [torch.tensor(v, dtype=dt, device=cuda) for v, dt in
           (([3, 3], torch.int32), ([4, 4], torch.int32),
            ([-0.5, B - 0.5], torch.float32), ([1.0, 1.0], torch.float32))]
    out = cs.voxel_scatter(*one, B, H, W, route=route)
    assert float(out[0, 4, 3]) == 0.5 and float(out[B - 1, 4, 3]) == 0.5
    assert float(out.sum()) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["vector", "direct"])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 9])
def test_flat_routes_match_plain(cuda, gen, route, D):
    """Row counts on either side of a float4, ids outside the range mixed
    in, ids whose weights are all zero or partly zero, a bucket count that
    is odd; one row has only the direct route."""
    from event_utils_tpu_torch.errors import ConfigurationError
    nb, n = 181 * 241, 60_001
    idx = torch.as_tensor(gen.integers(-5, nb + 5, n), dtype=torch.int32,
                          device=cuda)
    idx[::17] = -1
    idx[5::19] = nb
    w = torch.as_tensor(gen.normal(size=(D, n)), dtype=torch.float32,
                        device=cuda)
    w[:, ::3] = 0.0
    w[0, 1::3] = 0.0
    if D > 2:
        w[D - 1] = 0.0
    if D == 1 and route == "vector":
        with pytest.raises(ConfigurationError):
            cs.flat_scatter(idx, w, nb, route=route)
        return
    before = cs.launch_counts()[f"flat_scatter:{route}"]
    got = cs.flat_scatter(idx, w, nb, route=route)
    assert cs.launch_counts()[f"flat_scatter:{route}"] == before + 1
    assert got.shape == (D, nb) and got.is_contiguous()
    assert_rel(got, cs.flat_scatter_plain(idx, w, nb))
    bad = torch.tensor([-1, nb, nb + 3], dtype=torch.int32, device=cuda)
    assert float(cs.flat_scatter(bad, torch.ones(D, 3, device=cuda), nb,
                                 route=route).abs().sum()) == 0.0


@pytest.mark.cuda
def test_voxel_and_flat_routes_are_chosen_by_shape(cuda, gen):
    """Without ``route=`` a call launches the route that
    ``voxel_batched_route`` (one grid) / ``flat_route`` name for its shape,
    on both sides of the thresholds."""
    B, H, W = 5, 180, 240
    for n in (4096, 300_000):
        args = cs.voxel_inputs(*_voxel_stream(cuda, gen, n, H, W), B, (H, W))
        name = ("voxel_scatter_batched:"
                f"{cs.voxel_batched_route(1, n, B, H, W)}")
        assert name.endswith("vector" if n > 4096 else "direct")
        before = cs.launch_counts()[name]
        assert_rel(cs.voxel_scatter(*args, B, H, W),
                   cs.voxel_scatter_plain(*args, B, H, W))
        assert cs.launch_counts()[name] == before + 1
    nb = H * W
    for D, n in ((1, 300_000), (2, 4096), (2, 300_000), (4, 100_000)):
        idx = torch.as_tensor(gen.integers(0, nb, n), dtype=torch.int32,
                              device=cuda)
        w = torch.randn(D, n, device=cuda)
        name = f"flat_scatter:{cs.flat_route(D, n, nb)}"
        assert name.endswith("vector" if D > 1 and n > 4096 else "direct")
        before = cs.launch_counts()[name]
        assert_rel(cs.flat_scatter(idx, w, nb),
                   cs.flat_scatter_plain(idx, w, nb))
        assert cs.launch_counts()[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["vector", "direct"])
def test_voxel_and_flat_gradients_through_each_route(cuda, gen, route,
                                                     monkeypatch):
    """``voxel_matmul`` and ``scatter_add_flat_cuda`` with the kernel of
    either route as forward: the gradients of autograd through the plain
    versions."""
    monkeypatch.setattr(cs, "voxel_batched_route", lambda *a: route)
    monkeypatch.setattr(cs, "flat_route", lambda *a: route)
    n, B, H, W = 20_000, 5, 40, 60
    xs, ys, ts, ps = _voxel_stream(cuda, gen, n, H, W)
    tgt = torch.randn(B, H, W, device=cuda)
    grads = []
    for plain in (False, True):
        tt = ts.clone().requires_grad_(True)
        pt = ps.clone().requires_grad_(True)
        before = cs.launch_counts()[f"voxel_scatter_batched:{route}"]
        if plain:
            out = cs.voxel_scatter_plain(*cs.voxel_inputs(
                xs, ys, tt, pt, B, (H, W), t0=0.1, t1=0.8), B, H, W)
        else:
            out = cs.voxel_matmul(xs, ys, tt, pt, B, (H, W), t0=0.1, t1=0.8)
            assert (cs.launch_counts()[f"voxel_scatter_batched:{route}"]
                    == before + 1)
        grads.append(torch.autograd.grad((out * tgt).sum(), (tt, pt)))
    nb = 700
    idx = torch.as_tensor(gen.integers(-5, nb + 5, n), dtype=torch.int32,
                          device=cuda)
    w = torch.randn(3, n, device=cuda)
    g = torch.randn(3, nb, device=cuda)
    for fn in (cs.scatter_add_flat_cuda, cs.flat_scatter_plain):
        wt = w.clone().requires_grad_(True)
        grads[fn is cs.flat_scatter_plain] += torch.autograd.grad(
            (fn(idx, wt, nb) * g).sum(), (wt,))
    for a, b in zip(*grads):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), 1.0), err


# ---------------------------------------------------------------------------
# The serving path on the card
# ---------------------------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_networks_on_the_card_match_the_cpu_in_full_f32(cuda, gen):
    """EV-FlowNet and E2VID with the committed weights: the card's forward
    (cuDNN, TF32 off inside the models) against the CPU's, and the TF32
    flags restored after the call."""
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                ReconstructionTrainer)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    x = np.abs(gen.normal(size=(3, 1, 10, 64, 64))).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        flow = FlowTrainer((64, 64), device=dev)
        flow.load_params(os.path.join(_REPO, "runs", "flow128_similarity",
                                      "params.npz"))
        recon = ReconstructionTrainer(
            (64, 64), model_kwargs={"recurrent_levels": 3,
                                    "num_res_blocks": 2}, device=dev)
        recon.load_params(os.path.join(_REPO, "runs", "recon128v2",
                                       "params.npz"))
        outs[dev] = (flow.predict(x[:, 0]).cpu(),
                     recon.reconstruct(x)[0].cpu())
    assert flags == (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * max(float(ref.abs().max()), 1e-3), err


@pytest.mark.cuda
def test_dataset_grids_on_the_card_launch_the_flat_kernel(cuda, gen,
                                                          tmp_path):
    """Under the 'pallas' default a dataset on the card builds each
    polarity-split grid with two ``flat_scatter:direct`` launches; the
    grids equal the CPU's to 1e-5 of their scale."""
    from event_utils_tpu_torch.data_formats import memmap_packager
    from event_utils_tpu_torch.data_loaders import MemMapDataset
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    H, W, n = 48, 64, 20_000
    path = str(tmp_path / "rec")
    ts = np.sort(gen.uniform(0, 1.0, n))
    ps = gen.choice([-1, 1], n)
    with memmap_packager(path) as pk:
        pk.package_events(gen.integers(0, W, n), gen.integers(0, H, n), ts,
                          ps)
        for i, ft in enumerate((0.0, 0.3, 0.6, 0.9)):
            pk.package_image(np.zeros((H, W), np.uint8), ft, i)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], 4, 0,
                        sensor_size=(H, W))
    prev = get_default_impl()
    set_default_impl("pallas")
    try:
        with MemMapDataset(path, device="cuda") as card, \
                MemMapDataset(path, device="cpu") as host:
            for i in range(len(card)):
                before = cs.launch_counts()["flat_scatter:direct"]
                got = card[i]["voxel"]
                assert cs.launch_counts()["flat_scatter:direct"] == \
                    before + 2
                ref = host[i]["voxel"]
                err = float(np.abs(got - ref).max())
                assert err <= 1e-5 * max(float(np.abs(ref).max()), 1.0)
    finally:
        set_default_impl(prev)


@pytest.mark.cuda
def test_chunk_fetch_at_the_cells_shapes_is_one_batched_launch(cuda, gen,
                                                               tmp_path):
    """The reconstruct CLI's chunk fetch at the benchmark cell's shapes (8
    windows of 15,120 events, 5 combined bins, 180x240 padded to 184x240):
    one ``voxel_scatter_batched:direct`` launch and nothing else, its
    grids within 1e-6 of the per-item 'xla' grids' scale."""
    from event_utils_tpu_torch.cli import reconstruct as precon
    from event_utils_tpu_torch.data_formats import memmap_packager
    from event_utils_tpu_torch.data_loaders import MemMapDataset
    H, W, k, S = 180, 240, 15_120, 8
    n = S * k
    path = str(tmp_path / "rec")
    with memmap_packager(path) as pk:
        ps = gen.choice([-1, 1], n)
        ts = np.sort(gen.uniform(0, 1.0, n))
        pk.package_events(gen.integers(0, W, n), gen.integers(0, H, n), ts,
                          ps)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], 0, 0,
                        sensor_size=(H, W))
    assert cs.voxel_batched_route(S, k, 5, H, W) == "direct"
    with MemMapDataset(path, voxel_method={"method": "k_events", "k": k,
                                           "sliding_window_w": 0},
                       combined_voxel_channels=True, return_events=False,
                       device="cuda") as ds:
        assert len(ds) == S
        ref = precon._pad_to_multiple_hw(torch.stack(
            [torch.as_tensor(ds[i]["voxel"]) for i in range(S)])).numpy()
        precon._fetch_chunk(ds, 0, S, precon._pad_to_multiple_hw)  # build
        torch.cuda.synchronize()
        before = cs.launch_counts()
        got, _ = precon._fetch_chunk(ds, 0, S, precon._pad_to_multiple_hw)
        after = cs.launch_counts()
    delta = {r: v - before.get(r, 0) for r, v in after.items()
             if v != before.get(r, 0)}
    assert delta == {"voxel_scatter_batched:direct": 1}, delta
    assert got.shape == (S, 5, 184, 240) and got.dtype == np.float32
    err = float(np.abs(got - ref).max())
    assert err <= 1e-6 * float(np.abs(ref).max()), err


@pytest.mark.cuda
def test_histogram_chunk_at_the_rvt_cells_shapes_is_one_flat_launch(
        cuda, gen, tmp_path):
    """The detection CLI's chunk fetch at the RVT cell's shapes (8 windows
    of 50 ms, ~230,000 events each, on 720x1280 halved and padded to
    384x640, 20 channels): one ``flat_scatter:direct`` launch, the
    stack handed over on the card, equal to the CPU's histograms count
    for count."""
    from event_utils_tpu_torch.cli import detect
    from event_utils_tpu_torch.cli import reconstruct as precon
    from event_utils_tpu_torch.data_formats import memmap_packager
    from event_utils_tpu_torch.data_loaders import MemMapDataset
    H, W, S = 720, 1280, 8
    n = S * 230_400
    path = str(tmp_path / "rec")
    with memmap_packager(path) as pk:
        ps = gen.choice([-1, 1], n)
        ts = np.sort(gen.uniform(0, 0.4001, n))
        # one pixel hit often, so that counts reach the cutoff
        hot = gen.random(n) < 0.01
        pk.package_events(np.where(hot, 640, gen.integers(0, W, n)),
                          np.where(hot, 360, gen.integers(0, H, n)), ts, ps)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], 0, 0,
                        sensor_size=(H, W))

    def chunk(device):
        with MemMapDataset(path, voxel_method={"method": "t_seconds",
                                               "t": 0.05,
                                               "sliding_window_t": 0},
                           num_bins=10, return_events=False, device=device,
                           representation="stacked_histogram",
                           downsample=2) as ds:
            assert len(ds) == S
            fetch = precon.ChunkFetch(ds, detect.padder(64))
            fetch.on(cuda, 0, S)                                  # build
            torch.cuda.synchronize()
            before = cs.launch_counts()
            got, _ = fetch.on(cuda, 0, S)
            after = cs.launch_counts()
        return got, {r: v - before.get(r, 0) for r, v in after.items()
                     if v != before.get(r, 0)}

    got, delta = chunk("cuda")
    want, _ = chunk("cpu")
    assert delta == {"flat_scatter:direct": 1}, delta
    assert got.device.type == "cuda" and got.shape == (S, 20, 384, 640)
    assert torch.equal(got.cpu(), want.cpu())
    assert float(got.max()) == 10.0


@pytest.mark.cuda
def test_rvt_step_replays_match_the_eager_windows_at_the_cells_shapes(
        cuda):
    """RVT-B at the detection cell's input (20 x 384 x 640, batch 1) over
    6 windows from the zero state: the steps replayed from one captured
    CUDA graph give the eager windows' raw predictions and every stage's
    ``(h, c)`` within the cell's limits (1e-4 of their scale). Prints
    each side's milliseconds a window, host clock, after a warm-up."""
    import time

    from event_utils_tpu_torch.models.networks import build_detector
    from event_utils_tpu_torch.utils import profiling

    class Eager:
        @staticmethod
        def engages(x):
            return False

    torch.manual_seed(0)
    m = build_detector({"architecture": "RVT", "num_classes": 3},
                       20).to(cuda)
    x = torch.randint(0, 4, (6, 20, 384, 640), device=cuda).float()
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        _, raw, state = m.detect(x)
        counts = profiling.take().counts
    finally:
        profiling.enable_spans(was)
    assert counts == {"rvt.windows": 6, "rvt.resets": 1,
                      "rvt.graph_captures": 1}, counts
    eager = build_detector({"architecture": "RVT", "num_classes": 3},
                           20).to(cuda)
    eager.load_state_dict(m.state_dict())
    eager.step_graphs = Eager
    _, raw_want, state_want = eager.detect(x)

    def close(got, want):
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err

    close(raw, raw_want)
    for (h, c), (hw, cw) in zip(state, state_want):
        close(h, hw)
        close(c, cw)
    times = {}
    for name, net in (("replayed", m), ("eager", eager)):
        net.detect(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            net.detect(x)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3 / (3 * len(x))
    print(f"RVT step, ms a window: {times}")
    assert len(m._steps) == 1


@pytest.mark.cuda
def test_pair_fetch_at_the_flow_cells_shapes_stays_on_the_card(
        cuda, gen, tmp_path, monkeypatch):
    """The flow CLI's ``PairFetch`` over its streaming chunk fetch at the
    E-RAFT cell's shapes (8 windows of 307,200 events into combined 15-bin
    480x640 grids, 147 MB), one cold chunk under ``torch.profiler``: no
    device-to-host copy, one ``voxel_scatter_batched:direct`` launch, and
    the grids within 1e-6 of the host fetch's scale."""
    from event_utils_tpu_torch.cli import infer_flow
    from event_utils_tpu_torch.cli import reconstruct as precon
    from event_utils_tpu_torch.data_formats import memmap_packager
    from event_utils_tpu_torch.data_loaders import MemMapDataset
    H, W, k, S = 480, 640, 307_200, 8
    n = S * k
    path = str(tmp_path / "rec")
    with memmap_packager(path) as pk:
        ps = gen.choice([-1, 1], n)
        ts = np.sort(gen.uniform(0, 1.0, n))
        pk.package_events(gen.integers(0, W, n), gen.integers(0, H, n), ts,
                          ps)
        pk.add_metadata(n, int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], 0, 0,
                        sensor_size=(H, W))
    assert cs.voxel_batched_route(S, k, 15, H, W) == "direct"
    args = infer_flow.build_parser().parse_args(
        [path, "--output_dir", str(tmp_path / "out"), "--method", "k_events",
         "--k", str(k), "--num_bins", "15", "--combined_channels",
         "--no_window_cache", "--device", "cuda"])
    with MemMapDataset(path, voxel_method=precon._voxel_method(args),
                       num_bins=15, combined_voxel_channels=True,
                       return_events=False, device="cuda") as ds:
        assert len(ds) == S
        monkeypatch.setenv("EVENT_UTILS_TPU_WINCACHE_LIMIT_MB", "0")
        fetch, _ = precon._window_source(ds, args, S,
                                         pad=precon._pad_to_multiple_hw)
        want, _ = fetch(0, S)
        pairs = infer_flow.PairFetch(fetch, cuda)
        pairs(0, S - 1)                                     # build
        torch.cuda.synchronize()
        before = cs.launch_counts()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            grids, _ = pairs(0, S - 1)
            torch.cuda.synchronize()
        after = cs.launch_counts()
    delta = {r: v - before.get(r, 0) for r, v in after.items()
             if v != before.get(r, 0)}
    assert delta == {"voxel_scatter_batched:direct": 1}, delta
    names = [e.name for e in prof.events()]
    assert any("HtoD" in m for m in names), "the trace holds no copies"
    assert not [m for m in names if "DtoH" in m], sorted(set(names))
    assert grids.device.type == "cuda" and grids.dtype == torch.float32
    assert grids.shape == (S, 15, H, W)
    ref = torch.from_numpy(want)
    err = float((grids.cpu() - ref).abs().max())
    assert err <= 1e-6 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["similarity", "rotate"])
def test_simulation_on_the_card_matches_the_cpu(cuda, scene):
    """The simulator on the card against the CPU on a committed texture:
    event counts and drops within 0.1%, per-window grids within 1e-3 in L1
    (f32 log, exp, sin and cos may differ by an ulp, and a crossing that
    sits on a threshold then moves or drops: at most 2 of L1 each)."""
    from event_utils_tpu_torch.simulation import (SimulatorConfig,
                                                  affine_scene, load_texture,
                                                  rotating_scene,
                                                  simulate_scene,
                                                  texture_path)
    from chip_smoke import window_grids
    tex = load_texture(texture_path(91), (128, 128))
    cfg = SimulatorConfig(c_pos=0.15, c_neg=0.15)
    runs = {}
    for dev in ("cpu", "cuda"):
        sc = (affine_scene(tex, 0.35, 4.0, device=dev)
              if scene == "similarity" else rotating_scene(tex, 2.0,
                                                           device=dev))
        runs[dev] = simulate_scene(sc, 0.5, 100.0, cfg)
    card, host = runs["cuda"][0], runs["cpu"][0]
    assert len(host) > 50_000
    assert abs(len(card) - len(host)) <= 1e-3 * len(host)
    assert abs(card.stats["dropped"] - host.stats["dropped"]) \
        <= 1e-3 * len(host)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=0,
                               atol=1e-5)
    edges = np.linspace(0.0, 0.5, 6)
    for a, b in zip(window_grids(card, edges, 5, 128, 128),
                    window_grids(host, edges, 5, 128, 128)):
        assert np.abs(a - b).sum() <= 1e-3 * np.abs(b).sum()


@pytest.mark.cuda
def test_background_activity_filter_on_the_card_matches_the_cpu(cuda, gen):
    from event_utils_tpu_torch.ops import background_activity_filter
    n, H, W = 200_000, 180, 240
    xs = gen.uniform(-2, W + 1, n)
    ys = gen.uniform(-2, H + 1, n)
    ts = 1.6e9 + np.sort(gen.uniform(0.0, 1.0, n))
    mask = (gen.uniform(size=n) > 0.05).astype(np.float32)
    keep = {dev: background_activity_filter(
        xs, ys, ts, 0.005, sensor_size=(H, W), mask=mask, device=dev).cpu()
        for dev in ("cpu", "cuda")}
    assert torch.equal(keep["cuda"], keep["cpu"])
    assert 0 < int(keep["cpu"].sum()) < n


# the training path's flat scatters: the flow loss's splat (8 x 4 taps x
# 65536 events into 8 x 128 x 128), one polarity grid of a flow batch
# (2 x 8 x 65536 into 8 x 5 x 128 x 128) and of an E2VID batch (2 x 4 x
# 294912 into 24 x 4 x 5 x 128 x 128)
TRAIN_FLAT_SHAPES = [(8 * 4 * 65536, 8 * 128 * 128),
                     (2 * 8 * 65536, 8 * 5 * 128 * 128),
                     (2 * 4 * 294912, 24 * 4 * 5 * 128 * 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,num_buckets", TRAIN_FLAT_SHAPES)
def test_flat_kernel_forward_and_gradient_at_training_shapes(
        cuda, gen, n, num_buckets):
    """``scatter_add_flat_cuda`` (D = 1, the direct route) against the plain
    version, forward, and its autograd adjoint against the plain gather;
    ids -1 (dropped taps) mixed in."""
    idx = torch.as_tensor(gen.integers(-1, num_buckets, n),
                          dtype=torch.int32, device=cuda)
    w = torch.as_tensor(gen.normal(size=n), dtype=torch.float32,
                        device=cuda).requires_grad_(True)
    assert cs.flat_route(1, n, num_buckets) == "direct"
    before = cs.launch_counts()["flat_scatter:direct"]
    out = cs.scatter_add_flat_cuda(idx, w, num_buckets)
    assert cs.launch_counts()["flat_scatter:direct"] == before + 1
    assert_rel(out, cs.flat_scatter_plain(idx, w.detach()[None],
                                          num_buckets)[0])
    g = torch.randn(num_buckets, device=cuda)
    out.backward(g)
    ok = idx >= 0
    assert torch.equal(w.grad, torch.where(ok, g[torch.where(ok, idx, 0)
                                                 .long()], 0.0))


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Each trainer at 32x32 on one simulated batch, under 'pallas' on the
    card and on the CPU, from the same weights: the first step's gradients
    leaf by leaf (cosine >= 0.9999, 1e-3 of the leaf's scale, as
    ``chip_smoke.py``'s ``STEP_GRAD_*``), then two
    steps: losses to 1e-4 relative, every weight within twice the summed
    learning rate (Adam turns the card's rounding on a zero or near-zero
    gradient into a step of up to ~lr: ``chip_smoke.py``'s
    ``STEP_PARAM_*``). Each flow step launches ``flat_scatter:direct``
    once (its loss), each batch's grids ``voxel_scatter_batched`` once."""
    from event_utils_tpu_torch._device import no_tf32
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                ReconstructionTrainer)
    from event_utils_tpu_torch.training import in_the_loop as itl
    prev = get_default_impl()
    set_default_impl("pallas")
    try:
        ev, mask, gt = itl.simulate_flow_batch(
            1, 0, 2, (32, 32), 4096, omega_max=6.0, s_max=0.6, burn_in=1,
            device=cuda)
        grids = "voxel_scatter_batched:" + cs.voxel_batched_route(
            2, 4096, 5, 32, 32, split=True)
        before = cs.launch_counts()
        vox = itl.voxelize_batch(ev, mask, 5, (32, 32))
        after = cs.launch_counts()
        assert {k: v - before[k] for k, v in after.items()
                if v != before[k]} == {grids: 1}
        voxels, frames = itl.simulate_recon_batch(1, 0, 2, (32, 32), 20000,
                                                  3, device=cuda)
        batches = ((vox, ev, mask, itl.dense_gt(gt, (32, 32))),
                   (voxels, frames))
        kw = {"base_features": 8, "recurrent_levels": 3}
        runs = {}
        for dev in ("cpu", "cuda"):
            flow = FlowTrainer((32, 32), learning_rate=1e-3,
                               supervised_weight=1.0, device=dev)
            recon = ReconstructionTrainer((32, 32), learning_rate=1e-3,
                                          lpips_weight=0.1, burn_in=1,
                                          model_kwargs=kw, ema_decay=0.9,
                                          device=dev)
            fb, rb = ([a.to(dev) for a in b] for b in batches)
            with no_tf32():
                flow.loss(*fb).backward()
                recon.sequence_loss(*rb, burn_in=1)[0].backward()
            grads = [{k: p.grad.cpu() for k, p in t.model.named_parameters()}
                     for t in (flow, recon)]
            before = cs.launch_counts()["flat_scatter:direct"]
            losses = [flow.train_batch(*fb) for _ in range(2)]
            assert cs.launch_counts()["flat_scatter:direct"] == before + (
                2 if dev == "cuda" else 0)
            losses += [recon.train_sequence(*rb) for _ in range(2)]
            runs[dev] = (losses, grads, flow.model.state_dict(),
                         recon.ema_model.state_dict())
    finally:
        set_default_impl(prev)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for got, ref in zip(runs["cuda"][1], runs["cpu"][1]):
        for k, b in ref.items():
            a, b = got[k].reshape(-1).double(), b.reshape(-1).double()
            if b.abs().max() > 0:
                assert float(torch.nn.functional.cosine_similarity(
                    a, b, dim=0)) >= 0.9999, k
                assert float((a - b).abs().max()) <= 1e-3 * float(
                    b.abs().max()), k
    for i in (2, 3):
        d = max(float((a.cpu() - runs["cpu"][i][k]).abs().max())
                for k, a in runs["cuda"][i].items())
        assert d <= 2.0 * 2e-3, d


def window_recording(path, n=40_000, H=32, W=48, seed=3):
    """A memmap recording of ``n`` random events (the port's packager)."""
    from event_utils_tpu_torch.data_formats import memmap_packager

    g = np.random.default_rng(seed)
    mp = memmap_packager(path)
    mp.package_events(g.integers(0, W, n), g.integers(0, H, n),
                      np.sort(g.uniform(0, 1, n)), g.choice([-1.0, 1.0], n))
    mp.add_metadata(n, 0, 0, 1.0, 0.0, 1.0, 0, 0, sensor_size=(H, W))
    return path


@pytest.mark.cuda
def test_pinned_prefetch_under_a_slow_consumer(cuda, tmp_path):
    """Every device batch equals the host batch it was copied from, though
    the consumer lags and the loader rotates only four host buffers."""
    import time

    from event_utils_tpu_torch.data_loaders import (NativeWindowedLoader,
                                                    device_prefetch)

    rec = window_recording(str(tmp_path / "mm"))
    kw = dict(k=1000, batch_size=2)
    want = [{k: np.array(v) for k, v in b.items()}
            for b in NativeWindowedLoader(rec, **kw)]
    got = []
    for b in device_prefetch(NativeWindowedLoader(rec, **kw),
                             prefetch_depth=3, device=cuda):
        assert b["events"].is_cuda and b["events"].dtype == torch.float32
        torch.cuda._sleep(2_000_000)  # the consumer's stream lags the copies
        time.sleep(0.002)
        got.append({k: v.cpu().numpy() for k, v in b.items()})
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.cuda
def test_native_fill_into_pinned_memory_matches_the_device_batch(cuda):
    from event_utils_tpu_torch import native

    g = np.random.default_rng(1)
    n = 300_000
    t = np.sort(g.uniform(0, 2, n))
    xy = g.integers(0, 240, (n, 2)).astype(np.int16)
    p = g.integers(0, 2, n).astype(np.uint8)
    windows = native.k_event_windows(n, 20_000, 0)[:8]
    events = torch.empty((8, 32768, 4), pin_memory=True)
    mask = torch.empty((8, 32768), pin_memory=True)
    native.fill_padded_batches(t, xy, p, windows, 32768,
                               out=(events.numpy(), mask.numpy()))
    dev = events.to(cuda, non_blocking=True), mask.to(cuda, non_blocking=True)
    ref = native.fill_padded_batches_plain(t, xy, p, windows, 32768)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(dev[0].cpu().numpy(), ref[0])
    np.testing.assert_array_equal(dev[1].cpu().numpy(), ref[1])


@pytest.mark.cuda
def test_fit_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    from event_utils_tpu_torch.data_loaders import NativeWindowedLoader
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    from event_utils_tpu_torch.training import FlowTrainer

    rec = window_recording(str(tmp_path / "mm"), H=32, W=32)
    prev = get_default_impl()
    set_default_impl("pallas")
    try:
        losses = {}
        for dev in ("cpu", "cuda"):
            t = FlowTrainer((32, 32), learning_rate=1e-3, seed=4, device=dev)
            before = cs.launch_counts()
            losses[dev] = t.fit(NativeWindowedLoader(rec, k=2000,
                                                     batch_size=4),
                                epochs=1, log_every=0)[:2]
            if dev == "cuda":
                # 5 steps: one batched launch for the grids and the loss's
                # splat each
                grids = "voxel_scatter_batched:" + cs.voxel_batched_route(
                    4, 2000, 5, 32, 32, split=True)
                after = cs.launch_counts()
                assert {k: v - before[k] for k, v in after.items()
                        if v != before[k]} == {grids: 5,
                                               "flat_scatter:direct": 5}
    finally:
        set_default_impl(prev)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def densify_events(gen, n, H=180, W=240):
    xs = gen.integers(0, W, n).astype(np.int32)
    ys = gen.integers(0, H, n).astype(np.int32)
    ts = np.sort(gen.uniform(0, 0.5, n))
    ps = gen.choice(np.array([-1.0, 1.0]), n)
    return xs, ys, ts, ps


def assert_streams_equal(a, b, valid_only=True):
    a = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in a]
    b = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in b]
    np.testing.assert_array_equal(a[4], b[4])
    sel = a[4] != 0 if valid_only else slice(None)
    for u, v in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(u[sel], v[sel])


@pytest.mark.cuda
def test_densify_routes_agree_on_the_card(cuda, gen):
    """Integer and float coordinates, 'auto' and the global sort give one
    stream from the same draws on the card, and the CPU port's core gives
    it too from those draws, on every slot."""
    from event_utils_tpu_torch.augmentation import event_augmentation as ea
    n = 200_000
    xs, ys, ts, ps = densify_events(gen, n)
    mask = (np.arange(n) < n - 1000).astype(np.float32)
    z = torch.randn((3, n), generator=torch.Generator(device=cuda)
                    .manual_seed(0), device=cuda)
    outs = {}
    for name, (x, y, blk) in {
            "int, auto": (xs, ys, "auto"),
            "float, auto": (xs.astype(np.float32), ys.astype(np.float32),
                            "auto"),
            "int, global": (xs, ys, None)}.items():
        outs[name] = ea._densify_core(x, y, ts, ps, mask, *z, sort_block=blk,
                                      device=cuda)
    for name in ("float, auto", "int, global"):
        assert_streams_equal(outs[name], outs["int, auto"])
    cpu = ea._densify_core(xs, ys, ts, ps, mask, *z.cpu(), device="cpu")
    assert_streams_equal(cpu, outs["int, auto"], valid_only=False)
    t = torch.as_tensor(outs["int, auto"][2])
    m = outs["int, auto"][4].cpu() != 0
    assert bool((t[m][1:] >= t[m][:-1]).all())


@pytest.mark.cuda
def test_densified_grids_launch_their_kernels(cuda, gen):
    """The voxel grid (B=5, masked) and the event image of a densified
    stream of 2^20 slots launch ``voxel_scatter_batched:vector`` and
    ``flat_scatter:direct`` once each, and match the CPU port's."""
    from event_utils_tpu_torch.augmentation import event_augmentation as ea
    from event_utils_tpu_torch.representations import (events_to_image,
                                                       events_to_voxel)
    n = 1 << 19
    xs, ys, ts, ps = densify_events(gen, n)
    g = torch.Generator(device=cuda).manual_seed(1)
    cx, cy, ct, cp, cm = ea.add_correlated_events_torch(
        xs, ys, ts, ps, generator=g)
    before = cs.launch_counts()
    vox = events_to_voxel(cx, cy, ct, cp, 5, mask=cm, impl="matmul")
    img = events_to_image(cx, cy, cp, mask=cm, impl="matmul")
    after = cs.launch_counts()
    diff = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert diff == {"voxel_scatter_batched:vector": 1,
                    "flat_scatter:direct": 1}
    host = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            for a in (cx, cy, ct, cp, cm)]
    assert_rel(vox.cpu(), events_to_voxel(*host[:4], 5, mask=host[4],
                                          impl="matmul", device="cpu"))
    assert_rel(img.cpu(), events_to_image(host[0], host[1], host[3],
                                          mask=host[4], impl="matmul",
                                          device="cpu"))


# ---------------------------------------------------------------------------
# The batched splat (the grid searches' samples in one launch)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S,n,K,shared,H,W", [
    (1, 50_000, 1, True, 181, 241), (25, 20_000, 1, True, 181, 241),
    (7, 3001, 3, False, 37, 53), (5, 20_000, 4, False, 181, 241),
    (9, 777, 4, True, 181, 241)])
def test_batched_bilinear_matches_plain_and_single_launches(
        cuda, gen, S, n, K, shared, H, W):
    """Every route against its plain version and against S single
    splats; NaN, huge and wholly-off samples drop their taps."""
    x = torch.as_tensor(gen.uniform(-2, W + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, H + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    x[0, ::13] = float("nan")
    y[0, 5::17] = 1e30
    if S > 1:
        x[1] = -50.0
    w = torch.as_tensor(gen.normal(size=(K, n) if shared else (S, K, n)),
                        dtype=torch.float32, device=cuda)
    route = cs.bilinear_batched_route(K, H, W, n, S)
    before = cs.launch_counts()[f"bilinear_scatter_batched:{route}"]
    got = cs.bilinear_scatter_batched(x, y, w, H, W)
    assert cs.launch_counts()[f"bilinear_scatter_batched:{route}"] == (
        before + 1)
    assert_rel(got, cs.bilinear_scatter_batched_plain(x, y, w, H, W))
    single = torch.stack([cs.bilinear_scatter(x[s], y[s],
                                              w if shared else w[s], H, W)
                          for s in range(S)])
    assert_rel(got, single)
    if S > 1:
        assert float(got[1].abs().max()) == 0.0
    for r in sorted(cs._bilinear_allowed(K, H, W)):
        assert_rel(cs.bilinear_scatter_batched(x, y, w, H, W, route=r), got)


@pytest.mark.cuda
def test_batched_bilinear_launches_one_chunk_at_a_time(cuda, gen,
                                                       monkeypatch):
    """S across the samples one launch takes: one launch per chunk, each
    chunk's planes written."""
    S, n, H, W = 11, 4096, 181, 241
    monkeypatch.setattr(cs, "BATCH_MAX_SAMPLES", 4)
    x = torch.as_tensor(gen.uniform(0, W, (S, n)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(0, H, (S, n)), dtype=torch.float32,
                        device=cuda)
    w = torch.ones(1, n, device=cuda)
    before = cs.launch_counts()
    got = cs.bilinear_scatter_batched(x, y, w, H, W)
    after = cs.launch_counts()
    diff = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert diff == {"bilinear_scatter_batched:private": 3}
    assert_rel(got, cs.bilinear_scatter_batched_plain(x, y, w, H, W))


@pytest.mark.cuda
def test_batched_bilinear_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (here a grid past 65535 samples) raises:
    nothing falls back to the plain version or to single splats."""
    from event_utils_tpu_torch.errors import NativeBuildError
    monkeypatch.setattr(cs, "BATCH_MAX_SAMPLES", 70_000)
    x = torch.zeros(70_000, 1, device=cuda)
    before = cs.launch_counts()
    with pytest.raises(NativeBuildError):
        cs.bilinear_scatter_batched(x, x, torch.ones(1, 1, device=cuda), 8,
                                    8)
    assert cs.launch_counts() == before


# ---------------------------------------------------------------------------
# The private kernel (bilinear_scatter_batched:private, one image at S = 1)
# at the blocks a sample private_blocks picks,
# across a wave and at every blocks count, and the few-patch shapes (the
# direct route), held per pixel within chip_smoke's splat_limits rule at no
# more than half of it
# ---------------------------------------------------------------------------

def _limit_share(got, x, y, w, H, W):
    """Largest share of a pixel's rounding limit that ``got`` uses against
    the plain version in float64 (x, y (S, n); w (K, n) or (S, K, n))."""
    from chip_smoke import splat_limits
    ref = cs.bilinear_scatter_batched_plain(x.double(), y.double(),
                                            w.double(), H, W)
    limit = splat_limits(torch, x, y, w, H, W)
    err = (got.double() - ref).abs()
    assert bool((err[limit == 0] == 0).all())
    return float((err / limit.clamp_min(1e-300)).max())


def _patch_share(got, x, y, w, P, C, PH, PW):
    """``_limit_share`` of a (K, P, PH, PW) patch splat: each patch is a
    sample of C slots."""
    K = w.shape[0]
    wp = w.view(K, P, C).permute(1, 0, 2).contiguous()
    return _limit_share(got.permute(1, 0, 2, 3), x.view(P, C), y.view(P, C),
                        wp, PH, PW)


def _batched_counts(fn):
    before = cs.launch_counts()
    out = fn()
    after = cs.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,shared", [(1, 200_000, True),
                                        (3, 60_000, False),
                                        (25, 20_000, True)])
def test_private_splat_matches_plain_per_pixel(cuda, gen, S, n, shared):
    """The wrapper's blocks at a single image, a few samples and a stream
    grid level, with NaN, huge and wholly-off coordinates."""
    H, W = 181, 241
    x = torch.as_tensor(gen.uniform(-2, W + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, H + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    x[0, ::13] = float("nan")
    y[0, 5::17] = 1e30
    x[0, 7::19] = -1.0
    x[0, 11::23] = W - 1
    if S > 1:
        x[1] = -50.0
    w = torch.as_tensor(gen.normal(size=(1, n) if shared else (S, 1, n)),
                        dtype=torch.float32, device=cuda)
    got, diff = _batched_counts(
        lambda: cs.bilinear_scatter_batched(x, y, w, H, W))
    assert diff == {"bilinear_scatter_batched:private": 1}
    assert _limit_share(got, x, y, w, H, W) <= 0.5
    if S > 1:
        assert float(got[1].abs().max()) == 0.0
    if S == 1:
        one, diff = _batched_counts(
            lambda: cs.bilinear_scatter(x[0], y[0], w, H, W))
        assert diff == {"bilinear_scatter_batched:private": 1}
        assert _limit_share(one[None], x, y, w, H, W) <= 0.5


@pytest.mark.cuda
def test_private_blocks_across_a_wave(cuda, gen):
    """A loss chunk of 83 samples of 98304 events: 3 blocks a sample, 249
    blocks in two waves of the 132 SMs, each adding its copy; every
    sample's image is written; one block a sample stores its image."""
    from event_utils_tpu_torch.ops import build
    H, W, n, S = 181, 241, cs.PRIVATE_MIN_EVENTS, 83
    assert cs.private_blocks(S, n) == 3
    x = torch.as_tensor(gen.uniform(0, W, (S, n)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(0, H, (S, n)), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=(1, n)), dtype=torch.float32,
                        device=cuda)
    got, diff = _batched_counts(
        lambda: cs.bilinear_scatter_batched(x, y, w, H, W))
    assert diff == {"bilinear_scatter_batched:private": 1}
    assert _limit_share(got, x, y, w, H, W) <= 0.5
    out = torch.empty(S, 1, H, W, device=cuda)
    build.check(build.library().bilinear_scatter_batched_private(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), S, n, 0, 1, H, W,
        out.data_ptr(), 1, torch.cuda.current_stream().cuda_stream),
        "private")
    assert _limit_share(out, x, y, w, H, W) <= 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2, 3, 5, 7, 44, 132])
def test_private_every_blocks_count(cuda, gen, blocks):
    """Blocks a sample from one (stored) to 132 (each adding its copy),
    launched directly, with shares that do not divide the events, K = 2."""
    from event_utils_tpu_torch.ops import build
    S, n, K, H, W = 3, 9001, 2, 37, 53
    x = torch.as_tensor(gen.uniform(-2, W + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, H + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=(S, K, n)), dtype=torch.float32,
                        device=cuda)
    alloc = torch.empty if blocks == 1 else torch.zeros
    out = alloc((S, K, H, W), dtype=torch.float32, device=cuda)
    build.check(build.library().bilinear_scatter_batched_private(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), S, n, K * n, K, H, W,
        out.data_ptr(), blocks, torch.cuda.current_stream().cuda_stream),
        "private")
    assert _limit_share(out, x, y, w, H, W) <= 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("S", [65535, 65536])
def test_private_at_the_chunk_boundary(cuda, gen, S):
    """S at and across the samples one launch takes, 4 events a sample
    into 6x8: one launch and two."""
    x = torch.as_tensor(gen.uniform(-1, 9, (S, 4)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-1, 7, (S, 4)), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=(1, 4)), dtype=torch.float32,
                        device=cuda)
    got, diff = _batched_counts(
        lambda: cs.bilinear_scatter_batched(x, y, w, 6, 8))
    assert diff == {"bilinear_scatter_batched:private": -(-S // 65535)}
    assert _limit_share(got, x, y, w, 6, 8) <= 0.5


@pytest.mark.cuda
def test_private_on_one_pixel(cuda, gen):
    """Every event of every sample on one pixel: the longest chains of the
    shared-memory CAS loop, and the flush of one hot pixel."""
    S, n, H, W = 5, 100_000, 181, 241
    x = torch.full((S, n), 100.25, device=cuda)
    y = torch.full((S, n), 50.75, device=cuda)
    w = torch.as_tensor(gen.uniform(0.5, 1.5, (1, n)), dtype=torch.float32,
                        device=cuda)
    got = cs.bilinear_scatter_batched(x, y, w, H, W)
    assert _limit_share(got, x, y, w, H, W) <= 0.5
    one = cs.bilinear_scatter(x[0], y[0], w, H, W)
    assert _limit_share(one[None], x[:1], y[:1], w, H, W) <= 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("P,C,K,pile", [(1, 2048, 1, False),
                                        (108, 2048, 1, False),
                                        (108, 1024, 4, False),
                                        (767, 300, 2, False),
                                        (108, 2048, 1, True)])
def test_few_patches_stay_direct_and_match_plain(cuda, gen, P, C, K, pile):
    """Fewer than 768 (64, 128) patches take the direct kernel (a cluster
    variant only tied it over whole ROI solves): one patch, a descent step,
    stream_flow's 1024 slots at K = 4, the most patches it takes, and every
    slot on one pixel, each within the per-pixel limit."""
    PH, PW = 64, 128
    assert cs.bilinear_patches_route(P, PH, PW) == "direct"
    if pile:
        x = torch.full((P * C,), 60.5, device=cuda)
        y = torch.full((P * C,), 30.25, device=cuda)
    else:
        x = torch.as_tensor(gen.uniform(-2, PW + 1, P * C),
                            dtype=torch.float32, device=cuda)
        y = torch.as_tensor(gen.uniform(-2, PH + 1, P * C),
                            dtype=torch.float32, device=cuda)
        x[::29] = float("nan")
        y[3::31] = -1e30
    w = torch.as_tensor(gen.normal(size=(K, P * C)), dtype=torch.float32,
                        device=cuda)
    got, diff = _batched_counts(
        lambda: cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW))
    assert diff == {"bilinear_patches_scatter:direct": 1}
    assert got.shape == (K, P, PH, PW)
    assert _patch_share(got, x, y, w, P, C, PH, PW) <= 0.5


@pytest.mark.cuda
def test_private_launch_refused_raises_and_replays_in_a_graph(cuda, gen):
    """A private launch the card refuses (planes past 227 KB, no block)
    raises; an accepted one captures into a CUDA graph and its replay
    writes the same image."""
    from event_utils_tpu_torch.errors import NativeBuildError
    from event_utils_tpu_torch.ops import build
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.as_tensor(gen.uniform(0, 241, (2, 5000)), dtype=torch.float32,
                        device=cuda)
    w = torch.ones(4, 5000, device=cuda)
    out = torch.zeros(2, 4, 181, 241, device=cuda)
    with pytest.raises(NativeBuildError):     # 697 KB a plane group
        build.check(lib.bilinear_scatter_batched_private(
            x.data_ptr(), x.data_ptr(), w.data_ptr(), 2, 5000, 0, 4, 181, 241,
            out.data_ptr(), 2, stream), "private")
    with pytest.raises(NativeBuildError):     # no block
        build.check(lib.bilinear_scatter_batched_private(
            x.data_ptr(), x.data_ptr(), w.data_ptr(), 2, 5000, 0, 1, 181, 241,
            out.data_ptr(), 0, stream), "private")
    y = x.flip(1).contiguous() * 0.7
    w1 = w[:1].contiguous()
    want = cs.bilinear_scatter_batched(x, y, w1, 181, 241)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cs.bilinear_scatter_batched(x, y, w1, 181, 241)
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert _limit_share(got, x, y, w1, 181, 241) <= 0.5
    assert_rel(got, want)


# ---------------------------------------------------------------------------
# The vector kernel (K >= 2 channels innermost), held per pixel within
# chip_smoke's splat_limits rule at no more than half of it
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_vector_route_stores_every_element(cuda, gen):
    """The vector route's output is uninitialised memory: a block the
    caching allocator hands it pre-filled with NaN comes back with every
    element stored by the unpack pass (events on a few rows only, so most
    pixels receive no tap)."""
    H, W, K, n = 181, 241, 4, 2048
    x = torch.as_tensor(gen.uniform(0, W - 1, n), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(40, 42, n), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=(K, n)), dtype=torch.float32,
                        device=cuda)
    from event_utils_tpu_torch.ops import build
    ref = cs.bilinear_scatter_plain(x, y, w, H, W)
    reused = 0
    for _ in range(3):
        junk = [torch.full((K, H, W), float("nan"), device=cuda)
                for _ in range(4)]
        ptrs = {j.data_ptr() for j in junk}
        del junk
        got = cs.bilinear_scatter(x, y, w, H, W, route="vector")
        reused += got.data_ptr() in ptrs
        assert bool(torch.isfinite(got).all())
        assert_rel(got, ref)
    assert reused                         # a NaN block came back
    out = torch.full((K, H, W), float("nan"), device=cuda)
    scratch = torch.zeros((H * W, 4), device=cuda)
    build.check(build.library().bilinear_scatter_batched_vector(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), 1, n, 0, K, H, W, 4,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "vector")
    assert bool(torch.isfinite(out).all())
    assert_rel(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,K,shared,H,W", [
    (1, 200_000, 4, True, 181, 241), (1, 60_000, 2, True, 181, 241),
    (1, 50_000, 3, True, 240, 256), (4, 40_000, 4, False, 181, 241),
    (3, 20_001, 5, False, 37, 53), (2, 50_000, 2, False, 480, 640)])
def test_vector_route_matches_plain_per_pixel(cuda, gen, S, n, K, shared, H,
                                              W):
    """The vector route (float2 for K = 2, float4 for K = 3, 4, two float4s
    for K = 5) with NaN, huge and wholly-off coordinates, single and
    batched, shared and per-sample weights."""
    x = torch.as_tensor(gen.uniform(-2, W + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, H + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    x[0, ::13] = float("nan")
    y[0, 5::17] = 1e30
    x[0, 7::19] = -1.0
    y[0, 11::23] = H - 1
    w = torch.as_tensor(gen.normal(size=(K, n) if shared else (S, K, n)),
                        dtype=torch.float32, device=cuda)
    w[:, ::29] = 0.0
    got, diff = _batched_counts(lambda: cs.bilinear_scatter_batched(
        x, y, w, H, W, route="vector"))
    assert diff == {"bilinear_scatter_batched:vector": 1}
    assert _limit_share(got, x, y, w, H, W) <= 0.5
    w0 = w if shared else w[0]
    one, diff = _batched_counts(lambda: cs.bilinear_scatter(
        x[0], y[0], w0, H, W, route="vector"))
    assert diff == {"bilinear_scatter_batched:vector": 1}
    assert _limit_share(one[None], x[:1], y[:1], w0, H, W) <= 0.5


@pytest.mark.cuda
def test_vector_route_launches_one_chunk_at_a_time(cuda, gen, monkeypatch):
    """Zhu's K = 4 stack in chunks of 2 samples: one launch per chunk, the
    scratch zeroed again for each, every chunk's planes written."""
    S, n, H, W = 5, 30_000, 181, 241
    monkeypatch.setattr(cs, "VECTOR_CHUNK_BYTES", 2 * H * W * 16)
    assert cs.vector_chunk(4, H, W) == 2
    x = torch.as_tensor(gen.uniform(-2, W + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, H + 1, (S, n)), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.uniform(0, 1, (S, 4, n)), dtype=torch.float32,
                        device=cuda)
    got, diff = _batched_counts(lambda: cs.bilinear_scatter_batched(
        x, y, w, H, W, route="vector"))
    assert diff == {"bilinear_scatter_batched:vector": 3}
    assert _limit_share(got, x, y, w, H, W) <= 0.5


@pytest.mark.cuda
def test_vector_replays_in_a_graph_and_refused_launches_raise(
        cuda, gen, monkeypatch):
    """The vector route captures into a CUDA graph and its replays write
    the same images; a launch the card refuses (a scratch of 3 columns)
    raises and counts nothing: nothing falls back to the direct route or
    the plain version."""
    from event_utils_tpu_torch.errors import NativeBuildError
    H, W = 181, 241
    x = torch.as_tensor(gen.uniform(-2, W + 1, 30_000), dtype=torch.float32,
                        device=cuda)
    y = torch.as_tensor(gen.uniform(-2, H + 1, 30_000), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(gen.normal(size=(4, 30_000)), dtype=torch.float32,
                        device=cuda)
    want = cs.bilinear_scatter(x, y, w, H, W, route="vector")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cs.bilinear_scatter(x, y, w, H, W, route="vector")
    got.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert_rel(got, want)
    monkeypatch.setattr(cs, "vector_channels", lambda K: 3)
    before = cs.launch_counts()
    with pytest.raises(NativeBuildError):
        cs.bilinear_scatter(x, y, w, H, W, route="vector")
    with pytest.raises(NativeBuildError):
        cs.bilinear_scatter_batched(x[None], y[None], w, H, W,
                                    route="vector")
    assert cs.launch_counts() == before


def _voxel_rows(cuda, gen, S, n, H, W):
    xs = torch.as_tensor(gen.integers(-2, W + 2, (S, n)), device=cuda)
    ys = torch.as_tensor(gen.integers(-2, H + 2, (S, n)), device=cuda)
    ts = torch.sort(torch.rand(S, n, device=cuda), dim=1).values
    ps = torch.as_tensor(gen.choice([-1.0, 1.0], (S, n)),
                         dtype=torch.float32, device=cuda)
    return xs, ys, ts, ps


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("route", ["vector", "direct", "private"])
@pytest.mark.parametrize("B", [1, 5, 9])
def test_batched_voxel_matches_plain_and_single_launches(cuda, gen, route, B,
                                                         split):
    """S rows on each route, one launch, against the plain version and
    against S single ``voxel_scatter`` launches (2S with the polarity
    split; on the same route, for 'private' on one grid's rule's): whole
    rows, masks with an all-masked row and a row of one event, per-row
    ``t1`` overrides that pin a third of each row to ``t_norm = B-1``
    exactly, and NaN, +-inf and huge bins."""
    S, n, H, W = 23, 20_001, 45, 67
    xs, ys, ts, ps = _voxel_rows(cuda, gen, S, n, H, W)
    mask = torch.rand(S, n, device=cuda) > 0.3
    mask[1] = False
    mask[2] = False
    mask[2, n // 2] = True
    cases = [cs.voxel_inputs_batched(xs, ys, ts, ps, B, (H, W), split=split,
                                     **kw)
             for kw in ({}, {"mask": mask}, {"t1": ts[:, 2 * n // 3]})]
    assert int((cases[2][2] == B - 1).sum()) >= S * n // 3
    odd = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                        -1.0, -0.25, float(B)], device=cuda)
    t_odd = cases[0][2].clone()
    t_odd[:, ::5] = odd[torch.arange(t_odd[:, ::5].shape[1],
                                     device=cuda) % len(odd)]
    cases.append((cases[0][0], cases[0][1], t_odd, cases[0][3]))
    name = f"voxel_scatter_batched:{route}"
    for args in cases:
        before = cs.launch_counts()[name]
        got = cs.voxel_scatter_batched(*args, B, H, W, split=split,
                                       route=route)
        assert cs.launch_counts()[name] == before + 1
        assert got.shape == (S, (2 if split else 1) * B, H, W)
        assert_rel(got, cs.voxel_scatter_batched_plain(*args, B, H, W,
                                                       split))
        x, y, t, p = args
        weights = ((torch.where(p > 0, p, 0.0), torch.where(p < 0, -p, 0.0))
                   if split else (p,))
        one = None if route == "private" else route
        single = torch.stack([cs.voxel_scatter(x[s], y[s], t[s], w[s], B, H,
                                               W, route=one)
                              for s in range(S) for w in weights])
        assert_rel(got, single.view(got.shape))
    masked = cs.voxel_scatter_batched(*cases[1], B, H, W, split=split,
                                      route=route)
    assert float(masked[1].abs().max()) == 0.0
    assert abs(float(masked[2].sum())) == 1.0      # one event


@pytest.mark.cuda
@pytest.mark.parametrize("H, W, split, S", [(128, 128, True, 30),
                                            (180, 240, False, 40),
                                            (184, 240, True, 20)])
def test_batched_voxel_private_at_the_paths_planes(cuda, gen, H, W, split,
                                                   S):
    """The private route at the planes the paths send it, with more blocks
    than the card's 132 SMs: the split 128x128 grids (30 rows: 300
    blocks), the 180x240 grids (40 rows: 200 blocks) and the split 184x240
    grids (20 rows: 200 blocks), one launch each, against the plain
    version and S (2S) single launches; the rows' dispatch."""
    B, n = 5, 12_288
    xs, ys, ts, ps = _voxel_rows(cuda, gen, S, n, H, W)
    mask = torch.rand(S, n, device=cuda) > 0.25
    mask[3] = False
    args = cs.voxel_inputs_batched(xs, ys, ts, ps, B, (H, W), mask=mask,
                                   split=split)
    name = "voxel_scatter_batched:private"
    before = cs.launch_counts()[name]
    got = cs.voxel_scatter_batched(*args, B, H, W, split=split,
                                   route="private")
    assert cs.launch_counts()[name] == before + 1
    assert_rel(got, cs.voxel_scatter_batched_plain(*args, B, H, W, split))
    x, y, t, p = args
    weights = ((torch.where(p > 0, p, 0.0), torch.where(p < 0, -p, 0.0))
               if split else (p,))
    single = torch.stack([cs.voxel_scatter(x[s], y[s], t[s], w[s], B, H, W)
                          for s in range(S) for w in weights])
    assert_rel(got, single.view(got.shape))
    assert float(got[3].abs().max()) == 0.0
    G = 2 if split else 1
    assert cs.voxel_batched_route(S, n, B, H, W, split) == (
        "private" if S * G * B * H * W * 4 >= cs.PRIVATE_MIN_GRID_BYTES
        else "direct")


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
def test_batched_voxel_vector_launches_one_chunk_at_a_time(cuda, gen, split):
    """More rows than one vector launch keeps in the L2: one launch per
    chunk of ``voxel_batched_chunk`` rows, the scratch zeroed between
    them."""
    B, H, W = 5, 180, 240
    chunk = cs.voxel_batched_chunk(B, H, W, split)
    S, n = 2 * chunk + 3, 5000
    args = cs.voxel_inputs_batched(*_voxel_rows(cuda, gen, S, n, H, W), B,
                                   (H, W), split=split)
    before = cs.launch_counts()["voxel_scatter_batched:vector"]
    got = cs.voxel_scatter_batched(*args, B, H, W, split=split,
                                   route="vector")
    assert cs.launch_counts()["voxel_scatter_batched:vector"] == before + 3
    assert_rel(got, cs.voxel_scatter_batched_plain(*args, B, H, W, split))


@pytest.mark.cuda
def test_batched_voxel_gradients_and_grids_on_the_card(cuda, gen):
    """``voxel_matmul_batched``'s gradients in ``ts`` and ``ps`` against
    the CPU's, and ``voxel_grids_fixed_n(impl='matmul')``: one batched
    launch, no single-grid one, the grids of the exact route."""
    from event_utils_tpu_torch.representations import voxel_grids_fixed_n
    S, n, B, H, W = 6, 30_000, 5, 60, 80
    xs, ys, ts, ps = _voxel_rows(cuda, gen, S, n, H, W)
    mask = torch.rand(S, n, device=cuda) > 0.2
    tgt = torch.randn(S, B, H, W, device=cuda)
    grads = {}
    for dev in ("cuda", "cpu"):
        t = ts.to(dev, copy=True).requires_grad_(True)
        p = ps.to(dev, copy=True).requires_grad_(True)
        out = cs.voxel_matmul_batched(xs.to(dev), ys.to(dev), t, p, B,
                                      (H, W), mask=mask.to(dev))
        grads[dev] = torch.autograd.grad((out * tgt.to(dev)).sum(), (t, p))
    for a, b in zip(*grads.values()):
        assert_rel(a.cpu(), b)
    flat = (xs.reshape(-1), ys.reshape(-1), ts.reshape(-1), ps.reshape(-1))
    before = cs.launch_counts()
    got = voxel_grids_fixed_n(*flat, B, n, sensor_size=(H, W), impl="matmul")
    after = cs.launch_counts()
    route = cs.voxel_batched_route(S, n, B, H, W)
    assert {k: v - before[k] for k, v in after.items()
            if v != before[k]} == {f"voxel_scatter_batched:{route}": 1}
    assert_rel(got, voxel_grids_fixed_n(*flat, B, n, sensor_size=(H, W),
                                        impl="xla"))


# ---------------------------------------------------------------------------
# The ROI solvers' GD refine replayed from a CUDA graph
# ---------------------------------------------------------------------------

STREAM_K = 20_000          # events a window, as stream_flow's default


def _rotating_windows(n_windows, seed=3):
    """``n_windows`` consecutive 20k-event windows of the rotating scene
    (400 points turning at 1.2 rad/s about the centre of a 180x240 sensor,
    1 M draws a second, 0.2 px jitter, integer pixels), host numpy."""
    rng = np.random.default_rng(seed)
    H, W = 180, 240
    n = int(STREAM_K * n_windows * 1.1)
    px, py = rng.uniform(10, W - 10, 400), rng.uniform(10, H - 10, 400)
    pol = rng.choice([-1.0, 1.0], 400)
    idx = rng.integers(0, 400, n)
    ts = np.sort(rng.uniform(0, n / 1e6, n))
    rx, ry = px[idx] - W / 2, py[idx] - H / 2
    ca, sa = np.cos(1.2 * ts), np.sin(1.2 * ts)
    xs = W / 2 + ca * rx - sa * ry + rng.normal(0, 0.2, n)
    ys = H / 2 + sa * rx + ca * ry + rng.normal(0, 0.2, n)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    ev = [np.floor(xs[keep]), np.floor(ys[keep]), ts[keep], pol[idx][keep]]
    ev = [a.astype(np.float32) for a in ev]
    return [tuple(a[j * STREAM_K:(j + 1) * STREAM_K] for a in ev)
            for j in range(n_windows)]


class _EagerOnTheCard:
    """A refine-graph backend that never engages: the eager refine on the
    card."""

    @staticmethod
    def engages(device):
        return False


def _stream_solve(window, x0):
    from event_utils_tpu_torch.contrast_max import grid_cmax_batched
    return grid_cmax_batched(*window, roi_size=(20, 20), img_size=(180, 240),
                             min_events=10, maxiter=30, x0=x0, pyramid=1,
                             device="cuda")


@pytest.mark.cuda
def test_refine_replay_issues_no_synchronisation(cuda, monkeypatch):
    """Once captured, a warm refine (copies in, replay, copies out) makes no
    call that waits for the card."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    monkeypatch.setattr(ec, "_REFINE_GRAPHS", ec.RefineGraphs())
    (window,) = _rotating_windows(1)
    bx, by, bt, bp, bm, org, _ = ec.bucket_events_by_roi(
        *window, (180, 240), (20, 20), device="cuda")
    ev = (bx, by, bt, bp, bm, org.to(torch.float32))
    x0 = torch.zeros((bx.shape[0], 2), device=cuda)
    x0[:, 0] = 5.0
    trust = torch.full((bx.shape[0],), torch.inf, device=cuda)
    refine = ec._warm_roi_solver(ec.linvel_warp(), ec.variance_objective(),
                                 (180, 240), (20, 20), 1.0, 30, "gd", 4.0)
    eager = refine(*ev, x0, trust)           # first sighting: eager
    refine(*ev, x0, trust)                   # second: warm-up, capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed = refine(*ev, x0, trust)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(ec._REFINE_GRAPHS.entries) == 1
    assert eager[0].shape == replayed[0].shape
    assert bool(torch.isfinite(replayed[1]).all())


@pytest.mark.cuda
def test_refine_graph_agrees_with_eager_over_50_windows(cuda, monkeypatch):
    """50 warm windows of the rotating scene, each solved from the same
    warm start by the eager refine and by the graph's replay: the parity
    rules of the descent (per ROI 1.5 px/s unless the graph's answer's
    loss is no worse than eager's by more than 1%, the valid-ROI median
    0.5 px/s), each ROI's loss at the graph's answer no worse than at
    eager's by more than 1% of the window's scale, and the same launches a
    window: 33 of the fused patch-loss kernel, one an evaluation."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.utils import profiling
    eager_cache = ec.RefineGraphs(_EagerOnTheCard())
    graph_cache = ec.RefineGraphs()
    windows = _rotating_windows(51)
    was = profiling.enable_spans(True)
    profiling.take()
    try:
        monkeypatch.setattr(ec, "_REFINE_GRAPHS", eager_cache)
        p, _, _, valid = _stream_solve(windows[0], None)    # cold start
        prev = torch.where(valid[:, None], p, 0.0).cpu().numpy()
        replays, departed = 0, 0
        for j, window in enumerate(windows[1:]):
            out, launches = {}, {}
            for name, cache in (("eager", eager_cache),
                                ("graph", graph_cache)):
                monkeypatch.setattr(ec, "_REFINE_GRAPHS", cache)
                before = cs.launch_counts()
                profiling.take()
                out[name] = [a.cpu() for a in _stream_solve(window, prev)]
                counts = profiling.take().counts
                launches[name] = {k: v - before[k] for k, v in
                                  cs.launch_counts().items() if v != before[k]}
                if name == "graph":
                    replayed = (counts.get(ec.GRAPH_REPLAYS, 0) == 1
                                and not counts.get(ec.GRAPH_CAPTURES, 0))
                    replays += counts.get(ec.GRAPH_REPLAYS, 0)
            (pe, _, fe, ve), (pg, _, fg, vg) = out["eager"], out["graph"]
            assert torch.equal(ve, vg)
            v = ve
            scale = torch.maximum(fe[v].abs(), fe[v].abs().median())
            assert float(((fg[v] - fe[v]) / scale).max()) <= 1e-2, j
            far = (pg[v] - pe[v]).abs().amax(-1) > 1.5
            departed += int(far.sum())
            med = (pg[v].median(0).values - pe[v].median(0).values).abs()
            assert float(med.max()) <= 0.5, j
            if replayed:        # a key met before: no warm-up, no capture
                assert launches["graph"] == launches["eager"], j
                assert launches["eager"] == {"patch_variance_vg": 33}
            prev = torch.where(ve[:, None], pe, 0.0).numpy()
    finally:
        profiling.enable_spans(was)
        profiling.take()
    keys = len(graph_cache.entries) + len(graph_cache.seen)
    assert replays >= 50 - 2 * keys
    print(f"replays {replays} of 50 windows, {len(graph_cache.entries)} "
          f"graphs, ROIs past 1.5 px/s (loss no worse): {departed}")
