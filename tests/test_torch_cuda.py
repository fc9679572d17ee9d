"""The port's CUDA kernels on the card, against their plain versions.

Card-only: every test here carries the ``cuda`` marker and skips without a
CUDA device (the kernels have no CPU mode; the CPU tests cover the plain
versions against the JAX package). The file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the output's max |value| — float atomics change only
the order of the f32 sums.
"""

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
    before = cs.bilinear_scatter.launches
    assert_rel(cs.bilinear_scatter(x, y, w, H, W),
               cs.bilinear_scatter_plain(x, y, w, H, W))
    assert cs.bilinear_scatter.launches == before + 1


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
