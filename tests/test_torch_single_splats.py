"""One grid and one image are the batched splats at S = 1, on the CPU.

``voxel_scatter`` and ``bilinear_scatter`` hold no route logic of their
own: each calls its batched wrapper with one row, and ``voxel_matmul`` /
``bilinear_matmul`` are the one-row cases of ``voxel_matmul_batched`` /
``bilinear_matmul_batched``. Two things are held here:

- the merged rules against frozen copies of the rules they replaced (the
  single grid's ``voxel_route``, the single image's ``bilinear_route`` and
  the batched ``bilinear_batched_route``, their constants written out), over
  a grid of shapes: at S = 1 the single rules' answers, at S > 1 the
  batched rule's; and, where one image goes 'private', the same number of
  blocks as the single wrapper launched;
- each single wrapper, with every route its shape allows forced, equal to
  its batched wrapper at S = 1 and to the single plain version bit for bit,
  and the one-row matmul functions' gradients equal to the batched ones'.

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); on the CPU a wrapper answers with its plain version
whatever the route, so the forced routes check the dispatch, not the
kernels.
"""

import numpy as np
import pytest
import torch

import event_utils_tpu_torch as P
from event_utils_tpu_torch.ops import cuda_scatter as cs

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The replaced rules, frozen (constants as they were measured on an H100)
# ---------------------------------------------------------------------------

def _vector_pays(saved, scratch_floats):
    return (saved >= 262144 and scratch_floats <= 4 * saved
            and scratch_floats * 4 <= 16 << 20)


def frozen_voxel_route(n, B, H, W):
    """The single grid's rule: 'vector' where one reduction saved per
    event outweighs the two bins-innermost accumulators."""
    return ("vector" if _vector_pays(n, 2 * H * W * ((B + 2) & ~1))
            else "direct")


def _bilinear_vector_pays(K, H, W, n, S):
    if K < 2:
        return False
    Kp = 2 if K == 2 else -(-K // 4) * 4
    saved = 4 * S * n * (K - (1 if K == 2 else Kp // 4))
    return saved >= 3 * 65536 and S * H * W * Kp <= 4 * saved


def frozen_bilinear_route(K, H, W, n):
    """The single image's rule: 'private' from 98304 events where the
    image fits 227 KB, else 'vector' where it pays, else 'direct'."""
    if K * H * W * 4 <= 232448:
        return "private" if n >= 98304 else "direct"
    return "vector" if _bilinear_vector_pays(K, H, W, n, 1) else "direct"


def frozen_bilinear_batched_route(K, H, W, n, S):
    """The batched rule: 'private' wherever a sample's image fits."""
    if K * H * W * 4 <= 232448:
        return "private"
    return "vector" if _bilinear_vector_pays(K, H, W, n, S) else "direct"


SENSORS = [(8, 8), (21, 21), (41, 61), (181, 241), (241, 241), (480, 640),
           (720, 1280)]
EVENTS = [0, 1, 1024, 1025, 2048, 16_383, 16_384, 20_000, 65_536, 98_303,
          98_304, 131_072, 200_000, 262_143, 262_144, 1 << 20, 1 << 21,
          1 << 24]
SAMPLES = [1, 2, 25, 66, 67, 83, 400]


@pytest.mark.parametrize("sensor", SENSORS)
def test_merged_rules_against_the_frozen_rules(sensor):
    """At S = 1 the merged rules answer as the single rules did; at S > 1
    as the batched rule did; the voxel rule at S = 1 as the single grid's."""
    H, W = sensor
    for n in EVENTS:
        for B in (1, 2, 5, 9, 200):
            assert cs.voxel_batched_route(1, n, B, H, W) == \
                frozen_voxel_route(n, B, H, W), (n, B)
        for K in (1, 2, 3, 4, 8):
            assert cs.bilinear_batched_route(K, H, W, n) == \
                frozen_bilinear_route(K, H, W, n), (K, n)
            for S in SAMPLES:
                want = (frozen_bilinear_route(K, H, W, n) if S == 1
                        else frozen_bilinear_batched_route(K, H, W, n, S))
                assert cs.bilinear_batched_route(K, H, W, n, S) == want, \
                    (K, n, S)


def test_one_private_image_launches_the_blocks_it_did():
    """Where one image goes 'private' (98304 events or more), the batched
    private kernel at S = 1 runs as many blocks as the single wrapper did:
    one per 1024 events, at least 2, at most 132; at 1024 events or fewer
    one block, the one-block form the single wrapper's 'single' route
    forced."""
    for n in (98_304, 131_072, 135_168, 135_169, 200_000, 1 << 21):
        assert cs.private_blocks(1, n) == max(2, min(132, -(-n // 1024)))
    for n in (1, 512, 1024):
        assert cs.private_blocks(1, n) == 1


# ---------------------------------------------------------------------------
# Single wrappers against their batched wrappers at S = 1
# ---------------------------------------------------------------------------

def voxel_events(rng, n, H, W):
    xs = torch.as_tensor(rng.integers(-2, W + 2, n))
    ys = torch.as_tensor(rng.integers(-2, H + 2, n))
    ts = torch.as_tensor(np.sort(rng.uniform(0, 0.5, n)).astype(np.float32))
    ps = torch.as_tensor(rng.choice([-1.0, 1.0], n).astype(np.float32))
    return xs, ys, ts, ps


def splat_events(rng, K, n, H, W):
    x = torch.as_tensor(rng.uniform(-2, W + 1, n).astype(np.float32))
    y = torch.as_tensor(rng.uniform(-2, H + 1, n).astype(np.float32))
    w = torch.as_tensor(rng.normal(0, 1, (K, n)).astype(np.float32))
    return x, y, w


VOXEL_CASES = [(5, 24, 32, "vector"), (5, 24, 32, "direct"),
               (5, 24, 32, "private"), (4, 300, 300, "vector"),
               (4, 300, 300, "direct")]
SPLAT_CASES = [(1, 21, 21, "direct"), (1, 21, 21, "private"),
               (2, 37, 53, "direct"), (2, 37, 53, "private"),
               (2, 37, 53, "vector"), (4, 181, 241, "direct"),
               (4, 181, 241, "vector"), (1, 181, 241, "private")]


@pytest.mark.parametrize("kind,K,H,W,route",
                         [("voxel",) + c for c in VOXEL_CASES]
                         + [("bilinear",) + c for c in SPLAT_CASES])
def test_single_wrapper_is_the_batched_wrapper_at_one_row(kind, K, H, W,
                                                          route, monkeypatch):
    """Values: the single wrapper on a forced route equals the batched one
    at S = 1 on that route and, bit for bit, the single plain version.
    Gradients: the one-row matmul function, with the rule patched to the
    route, equals the batched one at S = 1 in every input's gradient. A
    CPU call launches nothing."""
    rng = np.random.default_rng(K * H * W)
    cs.reset_launch_counts()
    n = 700
    if kind == "voxel":
        ev = voxel_events(rng, n, H, W)
        args = cs.voxel_inputs(*ev, K, (H, W))
        got = cs.voxel_scatter(*args, K, H, W, route=route)
        batched = cs.voxel_scatter_batched(*(a[None] for a in args), K, H, W,
                                           route=route)
        assert got.shape == (K, H, W)
        assert torch.equal(got, batched[0])
        assert torch.equal(got, cs.voxel_scatter_plain(*args, K, H, W))
        monkeypatch.setattr(cs, "voxel_batched_route", lambda *a: route)
        tgt = torch.as_tensor(rng.normal(size=(K, H, W)).astype(np.float32))

        def grads(fn, one_row):
            tt = ev[2].clone().requires_grad_(True)
            pt = ev[3].clone().requires_grad_(True)
            if one_row:
                out = fn(ev[0], ev[1], tt, pt, K, (H, W))
            else:
                out = fn(ev[0][None], ev[1][None], tt[None], pt[None], K,
                         (H, W))[0]
            return (out,) + torch.autograd.grad((out * tgt).sum(), (tt, pt))

        one = grads(cs.voxel_matmul, True)
        many = grads(cs.voxel_matmul_batched, False)
    else:
        x, y, w = splat_events(rng, K, n, H, W)
        got = cs.bilinear_scatter(x, y, w, H, W, route=route)
        batched = cs.bilinear_scatter_batched(x[None], y[None], w, H, W,
                                              route=route)
        assert got.shape == (K, H, W)
        assert torch.equal(got, batched[0])
        assert torch.equal(got, cs.bilinear_scatter_plain(x, y, w, H, W))
        monkeypatch.setattr(cs, "bilinear_batched_route", lambda *a: route)
        tgt = torch.as_tensor(rng.normal(size=(K, H, W)).astype(np.float32))

        def grads(fn, one_row):
            leaves = [a.clone().requires_grad_(True) for a in (x, y, w)]
            a, b, c = leaves
            out = (fn(a, b, c, (H, W)) if one_row
                   else fn(a[None], b[None], c, (H, W))[0])
            return (out,) + torch.autograd.grad((out * tgt).sum(), leaves)

        one = grads(cs.bilinear_matmul, True)
        many = grads(cs.bilinear_matmul_batched, False)
    for a, b in zip(one, many):
        assert a.shape == b.shape
        assert torch.equal(a, b)
    assert not any(cs.launch_counts().values())


def test_single_wrappers_refuse_the_routes_their_shape_does_not_allow():
    """A route the shape does not serve raises, on the single wrappers as on
    the batched ones; 'single' is no route any more."""
    rng = np.random.default_rng(0)
    x, y, w = splat_events(rng, 4, 50, 181, 241)
    with pytest.raises(P.errors.ConfigurationError):   # 697 KB: no private
        cs.bilinear_scatter(x, y, w, 181, 241, route="private")
    with pytest.raises(P.errors.ConfigurationError):   # one channel
        cs.bilinear_scatter(x, y, w[:1].contiguous(), 181, 241,
                            route="vector")
    with pytest.raises(P.errors.ConfigurationError):
        cs.bilinear_scatter(x, y, w[:1].contiguous(), 21, 21, route="single")
    args = cs.voxel_inputs(*voxel_events(rng, 50, 24, 32), 5, (24, 32))
    with pytest.raises(P.errors.ConfigurationError):   # 360 KB planes
        cs.voxel_scatter(*args, 5, 300, 300, route="private")
    assert not any(r.startswith(("voxel_scatter:", "bilinear_scatter:"))
                   for r in cs.ROUTES)
