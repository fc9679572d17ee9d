"""The patch form of the bilinear splat and the per-tile voxel kernel's
contract (unsorted slots, any number of bins), on the CPU.

The wrappers run their plain versions here; the same numpy inputs from a
seed go through the JAX package, whose Pallas kernels run in interpret
mode. Tolerances, relative to the output's max |value|:

- the per-tile voxel function against the JAX 'hilo' kernel: 1e-5;
- the patch form against the JAX 'hilo' bilinear kernel: 3e-5, the
  tolerance ``tests/test_torch_ops.py`` holds ``bilinear_matmul`` to (the
  hi/lo bf16 split of the weights keeps ~1e-5 per tap);
- the patch form against the atlas route it replaced, on coordinates that
  are multiples of 1/64 (exact in f32 with the atlas offsets added): 1e-6;
- ``P = 1`` against ``bilinear_scatter_plain``: 1e-7 (the same sums);
- the gather backward against autograd through ``index_add_``: 1e-5;
- ``make_patch_loss`` against JAX's bf16 one-hot product: 4e-3.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu.contrast_max import events_cmax as jc
from event_utils_tpu.ops import pallas_scatter as jps
from event_utils_tpu_torch.contrast_max import events_cmax as pc
from event_utils_tpu_torch.convert import objective_from_jax
from event_utils_tpu_torch.ops import cuda_scatter as cs

torch.set_num_threads(1)

CPU = "cpu"
F32_REL = 1e-5
HILO_REL = 3e-5
BF16_REL = 4e-3


def assert_rel(got, ref, rel, floor=1.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), floor)
    err = float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def t(a):
    return torch.as_tensor(np.asarray(a))


def patch_inputs(rng, P_, C, PH, PW, K, margin=2.0):
    """Patch-local coordinates reaching ``margin`` px beyond the patch, so
    that some slots lose taps and some lose all of them."""
    n = P_ * C
    x = rng.uniform(-margin, PW + margin, n).astype(np.float32)
    y = rng.uniform(-margin, PH + margin, n).astype(np.float32)
    w = rng.normal(0, 1, (K, n)).astype(np.float32)
    return x, y, w


SHAPES = [(7, 300, 24, 40, 1), (3, 257, 19, 23, 4), (2, 500, 64, 128, 2)]


# ---------------------------------------------------------------------------
# (a) against the Pallas bilinear kernel, patch by patch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P_,C,PH,PW,K", SHAPES)
def test_patches_plain_matches_jax_kernel_per_patch(rng, P_, C, PH, PW, K):
    x, y, w = patch_inputs(rng, P_, C, PH, PW, K)
    got = cs.bilinear_patches_scatter(t(x), t(y), t(w), P_, C, PH, PW)
    assert got.shape == (K, P_, PH, PW) and got.dtype == torch.float32
    for q in range(P_):
        run = slice(q * C, (q + 1) * C)
        ref = np.asarray(jps.bilinear_matmul(
            x[run], y[run], w[0, run] if K == 1 else w[:, run], (PH, PW),
            chunk=1024, interpret=True))
        assert_rel(got[:, q], ref.reshape(K, PH, PW), HILO_REL)


# ---------------------------------------------------------------------------
# (b) against the atlas route the patch form replaced
# ---------------------------------------------------------------------------

def atlas_route(x, y, w, P_, C, PH, PW):
    """Every patch splatted by ``bilinear_scatter_plain`` into one
    near-square atlas, then un-tiled: the same function where every slot
    with a tap outside its patch has weight 0."""
    K = w.shape[0]
    ncol = max(1, int(round(np.sqrt(P_ * PH / PW))))
    nrow = -(-P_ // ncol)
    q = torch.arange(P_).repeat_interleave(C)
    x0, y0 = torch.floor(x), torch.floor(y)
    inpatch = (x0 >= 0) & (x0 + 1 < PW) & (y0 >= 0) & (y0 + 1 < PH)
    ax = torch.where(inpatch, x + (q % ncol * PW).float(), -2.0)
    ay = torch.where(inpatch, y + (q // ncol * PH).float(), -2.0)
    img = cs.bilinear_scatter_plain(ax, ay, w, nrow * PH, ncol * PW)
    img = img.view(K, nrow, PH, ncol, PW).permute(0, 1, 3, 2, 4)
    return img.reshape(K, nrow * ncol, PH, PW)[:, :P_]


@pytest.mark.parametrize("P_,C,PH,PW,K", SHAPES)
def test_patches_plain_matches_atlas_route(rng, P_, C, PH, PW, K):
    x, y, w = patch_inputs(rng, P_, C, PH, PW, K)
    x, y = (torch.round(t(a) * 64) / 64 for a in (x, y))   # exact offsets
    x0, y0 = torch.floor(x), torch.floor(y)
    inpatch = (x0 >= 0) & (x0 + 1 < PW) & (y0 >= 0) & (y0 + 1 < PH)
    w = t(w) * inpatch.float()          # the patch loss's rule
    assert 0 < int(inpatch.sum()) < inpatch.numel()
    got = cs.bilinear_patches_scatter(x, y, w, P_, C, PH, PW)
    assert_rel(got, atlas_route(x, y, w, P_, C, PH, PW).numpy(), 1e-6)


# ---------------------------------------------------------------------------
# (c) one patch is the whole-image splat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3])
def test_one_patch_equals_bilinear_scatter(rng, K):
    H, W, n = 24, 32, 2000
    x, y, w = patch_inputs(rng, 1, n, H, W, K)
    x[::50] = np.nan
    y[7::50] = 1e30
    got = cs.bilinear_patches_scatter(t(x), t(y), t(w), 1, n, H, W)
    assert_rel(got[:, 0], cs.bilinear_scatter_plain(t(x), t(y), t(w), H,
                                                    W).numpy(), 1e-7)
    # nothing wraps: a run wholly out of its patch leaves zeros
    away = cs.bilinear_patches_scatter(t(x) * 0 - 5.0, t(y), t(w), 1, n, H, W)
    assert float(away.abs().sum()) == 0.0


def test_patches_check_inputs_and_counts(rng):
    x, y, w = (t(a) for a in patch_inputs(rng, 2, 10, 8, 8, 1))
    with pytest.raises(P.errors.ConfigurationError):
        cs.bilinear_patches_scatter(x, y, w, 3, 10, 8, 8)       # P*C != N
    with pytest.raises(P.errors.ConfigurationError):
        cs.bilinear_patches_scatter(x, y, w[0], 2, 10, 8, 8)    # w is (K, N)
    with pytest.raises(P.errors.ConfigurationError):
        cs.bilinear_patches_scatter(x.double(), y, w, 2, 10, 8, 8)
    cs.reset_launch_counts()
    empty = cs.bilinear_patches_scatter(x[:0], y[:0], w[:, :0], 2, 0, 8, 8)
    assert empty.shape == (1, 2, 8, 8) and float(empty.abs().sum()) == 0.0
    assert not any(cs.launch_counts().values())     # the CPU launches none
    # routes are a matter of shape alone
    assert cs.bilinear_patches_route(2700, 64, 128) == "patch"
    assert cs.bilinear_patches_route(108, 64, 128) == "direct"
    assert cs.bilinear_patches_route(2700, 240, 256) == "direct"
    assert cs.voxel_tiles_route(5, 96, 128) == "private"
    assert cs.voxel_tiles_route(9, 96, 128) == "private"
    assert cs.voxel_tiles_route(5, 240, 256) == "direct"
    assert cs.bilinear_batched_route(4, 181, 241, 200_000) == "vector"
    assert cs.bilinear_batched_route(1, 181, 241, 200_000) == "private"
    assert cs.bilinear_batched_route(1, 181, 241, 2000) == "direct"
    assert cs.bilinear_batched_route(1, 41, 61, 32768) == "direct"


# ---------------------------------------------------------------------------
# (d) the gather backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P_,C,PH,PW,K", SHAPES)
def test_patches_backward_matches_autograd_of_plain(rng, P_, C, PH, PW, K):
    x, y, w = patch_inputs(rng, P_, C, PH, PW, K)
    tgt = t(rng.normal(size=(K, P_, PH, PW)).astype(np.float32))
    outs, grads = [], []
    for fn in (cs.bilinear_patches_scatter, cs.bilinear_patches_scatter_plain):
        leaves = [torch.tensor(a, requires_grad=True) for a in (x, y, w)]
        out = fn(*leaves, P_, C, PH, PW)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * tgt).sum(), leaves))
    assert torch.equal(*outs)
    for got, ref in zip(*grads):
        assert_rel(got, ref.numpy(), F32_REL)


def test_patches_backward_matches_jax_vjp(rng):
    """Per patch, the cotangents of x, y and w equal the JAX custom VJP of
    the Pallas bilinear kernel."""
    P_, C, PH, PW, K = 3, 400, 24, 40, 2
    x, y, w = patch_inputs(rng, P_, C, PH, PW, K, margin=0.0)
    tgt = rng.normal(size=(K, P_, PH, PW)).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, y, w)]
    out = cs.bilinear_patches_scatter(*leaves, P_, C, PH, PW)
    gx, gy, gw = torch.autograd.grad((out * t(tgt)).sum(), leaves)
    for q in range(P_):
        run = slice(q * C, (q + 1) * C)

        def jloss(xq, yq, wq):
            img = jps.bilinear_matmul(xq, yq, wq, (PH, PW), chunk=1024,
                                      interpret=True)
            return jnp.sum(img * tgt[:, q])

        jg = jax.grad(jloss, argnums=(0, 1, 2))(x[run], y[run], w[:, run])
        assert_rel(gx[run], np.asarray(jg[0]), 3e-4)
        assert_rel(gy[run], np.asarray(jg[1]), 3e-4)
        assert_rel(gw[:, run], np.asarray(jg[2]), 3e-4)


# ---------------------------------------------------------------------------
# (e) the patch loss on the patch form
# ---------------------------------------------------------------------------

def flow_scene(rng, vx, vy, n_events, sensor, n_points=25, t_max=1.0,
               noise=0.1):
    H, W = sensor
    mx = abs(vx) * t_max + 2
    my = abs(vy) * t_max + 2
    px = rng.uniform(mx if vx < 0 else 2, W - 2 - (mx if vx > 0 else 0),
                     n_points)
    py = rng.uniform(my if vy < 0 else 2, H - 2 - (my if vy > 0 else 0),
                     n_points)
    pol = rng.choice([-1.0, 1.0], n_points)
    idx = rng.integers(0, n_points, n_events)
    ts = np.sort(rng.uniform(0, t_max, n_events))
    xs = px[idx] + vx * ts + rng.normal(0, noise, n_events)
    ys = py[idx] + vy * ts + rng.normal(0, noise, n_events)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    return xs[keep], ys[keep], ts[keep], pol[idx][keep]


@pytest.mark.parametrize("name", ["variance", "zhu"])
@pytest.mark.parametrize("patch", [(64, 128), (48, 64)])
def test_make_patch_loss_on_patch_form_matches_jax(name, patch):
    """Value and gradient of the batched loss (4 ROIs, 2 samples each)
    against JAX's vmapped per-ROI loss, and no atlas on the way: the loss
    hands patch-local coordinates to ``bilinear_patches_scatter``."""
    r = np.random.default_rng(11)
    xs, ys, ts, ps = flow_scene(r, -12.0, 9.0, 3000, (40, 40))
    jb = jc.bucket_events_by_roi(xs, ys, ts, ps, (40, 40), (20, 20), 1024)
    pb = pc.bucket_events_by_roi(xs, ys, ts, ps, (40, 40), (20, 20), 1024,
                                 device=CPU)
    R = pb[0].shape[0]
    params = (np.array([[-11.0, 8.0]], np.float32)
              + r.normal(0, 2, (R, 2, 2)).astype(np.float32))
    jobj = J.models.get_objective(name)
    jl = jc.make_patch_loss(J.models.linvel_warp(), (20, 20), jobj,
                            patch=patch, full_pixels=41 * 41)
    pl = pc.make_patch_loss(P.models.linvel_warp(), (20, 20),
                            objective_from_jax(jobj), patch=patch,
                            full_pixels=41 * 41)
    per_sample = jax.vmap(jax.value_and_grad(jl),
                          in_axes=(0, None, None, None, None, None, None))
    jv, jg = jax.jit(jax.vmap(per_sample))(
        jnp.asarray(params), *jb[:5], jnp.asarray(jb[5], jnp.float32))

    seen = []
    splat = pc.bilinear_patches_scatter

    def spy(x, y, w, P_, C, PH, PW):
        seen.append((tuple(x.shape), tuple(w.shape), P_, C, PH, PW,
                     float(x.detach().abs().max())))
        return splat(x, y, w, P_, C, PH, PW)

    pc.bilinear_patches_scatter = spy
    try:
        pt = torch.tensor(params, requires_grad=True)
        pv = pl(pt, *pb[:5], pb[5].float())
        (pg,) = torch.autograd.grad(pv.sum(), pt)
    finally:
        pc.bilinear_patches_scatter = splat
    assert_rel(pv, np.asarray(jv), BF16_REL, floor=1e-6)
    assert_rel(pg, np.asarray(jg), BF16_REL, floor=1e-6)
    C = pb[0].shape[1]
    K = 4 if name == "zhu" else 1
    (xshape, wshape, P_, C_, PH, PW, xmax), = seen
    assert (xshape, wshape) == ((R * 2 * C,), (K, R * 2 * C))
    assert (P_, C_, PH, PW) == (R * 2, C, *patch)
    # patch-local: no atlas offset rides on the coordinates
    assert xmax < 40 + patch[1]
    assert not hasattr(pc, "_patch_atlas")


# ---------------------------------------------------------------------------
# (f) the per-tile voxel function: slots in any order, any number of bins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [5, 9])
@pytest.mark.parametrize("case", ["window", "mask", "override"])
def test_voxel_tiles_plain_unsorted_matches_jax_on_sorted(rng, B, case):
    """The JAX kernel needs each tile's slots time-sorted; the port's
    function does not. Shuffled slots through the port against the sorted
    permutation of the same slots through ``voxel_matmul_tiles``."""
    T, cap, tile = 3, 700, (16, 24)
    bx = rng.integers(-2, tile[1] + 2, (T, cap))
    by = rng.integers(-2, tile[0] + 2, (T, cap))
    bt = rng.uniform(0, 1, (T, cap)).astype(np.float32)      # not sorted
    bp = rng.choice([-1.0, 1.0], (T, cap)).astype(np.float32)
    mask = ((rng.random((T, cap)) > 0.25).astype(np.float32)
            if case == "mask" else None)
    t0, t1 = (0.15, 0.7) if case == "override" else (0.0, 1.0)
    order = np.argsort(bt, axis=1, kind="stable")
    srt = lambda a: np.take_along_axis(a, order, axis=1)
    ref = np.asarray(jps.voxel_matmul_tiles(
        srt(bx), srt(by), srt(bt), srt(bp), B, tile, np.float32(t0),
        np.float32(t1), mask=None if mask is None else srt(mask)))
    assert not np.all(np.diff(bt, axis=1) >= 0)
    got = cs.voxel_matmul_tiles(t(bx), t(by), t(bt), t(bp), B, tile, t0, t1,
                                mask=mask)
    assert got.shape == (T, B) + tile
    assert_rel(got, ref, F32_REL)
    # and the sorted slots through the port give the same grid
    same = cs.voxel_matmul_tiles(t(srt(bx)), t(srt(by)), t(srt(bt)),
                                 t(srt(bp)), B, tile, t0, t1,
                                 mask=None if mask is None else srt(mask))
    assert_rel(got, same.numpy(), 1e-6)
