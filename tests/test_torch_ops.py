"""Parity of the PyTorch port's ops against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``event_utils_tpu_torch`` with ``device="cpu"``. The Pallas
kernels run on the JAX side in interpret mode; the port's CUDA kernel
wrappers run their plain versions for CPU tensors.

Tolerances (relative to the output's max |value|):
- f32 paths (exact scatter, sort, the kernels' plain versions): 1e-5;
- against the JAX one-hot-matmul kernels at 'hilo' precision: 3e-5;
- against JAX 'bf16': 4e-3.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.ndimage
import torch

import event_utils_tpu as J
import event_utils_tpu_torch as P
from event_utils_tpu.ops import pallas_scatter as jps
from event_utils_tpu_torch.ops import build, cuda_scatter as cs

torch.set_num_threads(1)

CPU = "cpu"
SENSOR = (24, 32)
F32_REL = 1e-5
HILO_REL = 3e-5
BF16_REL = 4e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_rel(got, ref, rel, floor=1.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), floor)
    err = float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def float_events(rng, n=2000, sensor=SENSOR, margin=2.0):
    H, W = sensor
    x = rng.uniform(-margin, W + margin, n).astype(np.float32)
    y = rng.uniform(-margin, H + margin, n).astype(np.float32)
    w = rng.normal(0, 1, n).astype(np.float32)
    return x, y, w


# ---------------------------------------------------------------------------
# Package boundary
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, the ROI-bucketed, serving, simulation,
    training and augmentation paths' entry points and ``chip_smoke`` import
    without jax or
    the JAX package, and without the packages the card machine lacks
    (h5py, matplotlib, flax, orbax: each is imported only by the function
    that needs it)."""
    code = ("import sys, pkgutil, importlib, event_utils_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "from event_utils_tpu_torch.contrast_max import (\n"
            "    bucket_events_by_roi, fit_global_motion, grid_cmax,\n"
            "    grid_cmax_batched, make_patch_loss)\n"
            "from event_utils_tpu_torch.representations import (\n"
            "    events_to_voxel_tiled, voxel_grids_fixed_n)\n"
            "from event_utils_tpu_torch.ops.cuda_scatter import (\n"
            "    voxel_tiles_scatter, voxel_tiles_scatter_plain)\n"
            "from event_utils_tpu_torch.cli import (\n"
            "    eval_cmax, infer_flow, reconstruct, simulate, train_flow,\n"
            "    train_reconstruction)\n"
            "for cli in (eval_cmax, infer_flow, reconstruct, simulate,\n"
            "            train_flow, train_reconstruction):\n"
            "    assert callable(cli.main)\n"
            "from event_utils_tpu_torch.ops import (\n"
            "    background_activity_filter, filter_background_activity)\n"
            "from event_utils_tpu_torch.simulation import (\n"
            "    SimulatorConfig, affine_scene, hot_pixel_map, load_texture,\n"
            "    rotating_scene, simulate_events, simulate_events_device,\n"
            "    simulate_scene, smooth_texture, texture_path,\n"
            "    translating_scene)\n"
            "from event_utils_tpu_torch.convert import load_params_npz\n"
            "from event_utils_tpu_torch.data_formats import (\n"
            "    hdf5_packager, memmap_packager, read_h5_events_dict)\n"
            "from event_utils_tpu_torch.data_loaders import (\n"
            "    DynamicH5Dataset, MemMapDataset, NpyDataset)\n"
            "from event_utils_tpu_torch.models import E2VID, EVFlowNet\n"
            "from event_utils_tpu_torch.training import (\n"
            "    FlowTrainer, ReconstructionTrainer, cosine_decay_schedule,\n"
            "    simulate_flow_batch, simulate_recon_batch,\n"
            "    train_flow_in_the_loop, train_reconstruction_in_the_loop)\n"
            "from event_utils_tpu_torch.training.checkpointing import (\n"
            "    load_params_npz, save_params_npz, save_trainer_checkpoint)\n"
            "from event_utils_tpu_torch.models import (\n"
            "    contrast_flow_loss, perceptual_distance,\n"
            "    reconstruction_loss)\n"
            "from event_utils_tpu_torch.transforms import warp_events_flow\n"
            "from event_utils_tpu_torch.utils import (\n"
            "    average_endpoint_error, flow2bgr_np, psnr, write_gray_png)\n"
            "from event_utils_tpu_torch.augmentation import (\n"
            "    add_correlated_events, add_correlated_events_torch,\n"
            "    add_random_events, flip_events_x_torch, jitter_events_torch,\n"
            "    remove_events_mask_torch, rotate_events_torch)\n"
            "from event_utils_tpu_torch.ops.sort import (\n"
            "    nearly_sorted_sort, sort_block_for, time_sort)\n"
            "from event_utils_tpu_torch.ops import bilinear_scatter_matmul\n"
            "from event_utils_tpu_torch.data_formats import (\n"
            "    BagExtractor, add_attribute, extract_rosbag, h5_to_memmap,\n"
            "    memmap_to_h5, read_txt_events, txt_to_h5, write_txt_events)\n"
            "from event_utils_tpu_torch.visualization import (\n"
            "    crop_to_size, parse_crop, plot_between_frames, plot_events,\n"
            "    plot_events_sliding, plot_voxel_grid, motion_compensate,\n"
            "    get_visualizer, draw_plane_figure, draw_event_stream_mayavi)\n"
            "from event_utils_tpu_torch.parallel import (\n"
            "    make_mesh, sharded_events_to_voxel, sharded_grid_cmax)\n"
            "from event_utils_tpu_torch.contrast_max import (\n"
            "    draw_objective_function)\n"
            "from event_utils_tpu_torch.cli import (augment_demo, cmax_demo,\n"
            "    visualize, visualize_events, visualize_flow, visualize_voxel)\n"
            "assert callable(augment_demo.main)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'event_utils_tpu.')) or "
            "m == 'event_utils_tpu' or m.split('.')[0] in "
            "('h5py', 'matplotlib', 'flax', 'orbax'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_point_without_device_needs_a_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    xs = rng.integers(0, 32, 10)
    with pytest.raises(P.errors.DeviceUnavailableError):
        P.representations.events_to_voxel(xs, xs, np.arange(10.0), xs, 3,
                                          sensor_size=SENSOR)
    with pytest.raises(P.errors.DeviceUnavailableError):
        P.ops.scatter_add_flat(xs, np.ones(10), 40)
    # tensors that come in keep their device: no device argument needed
    out = P.ops.scatter_add_flat(torch.as_tensor(xs), torch.ones(10), 40)
    assert out.device.type == "cpu"


@pytest.mark.parametrize("name", [
    "EventUtilsError", "ConfigurationError", "SensorLimitError",
    "RegistryError", "DataError", "DataNotFoundError", "DataFormatError",
    "DatasetInitError", "NativeBuildError"])
def test_error_taxonomy_matches(name):
    jcls = getattr(J.errors, name)
    pcls = getattr(P.errors, name)
    jbases = [b.__name__ for b in jcls.__mro__]
    pbases = [b.__name__ for b in pcls.__mro__]
    assert jbases == pbases


def test_float64_inputs_become_float32(rng):
    x, y, w = float_events(rng, 100)
    img = P.ops.bilinear_scatter(x.astype(np.float64), y.astype(np.float64),
                                 w.astype(np.float64), SENSOR, device=CPU)
    assert img.dtype == torch.float32


# ---------------------------------------------------------------------------
# Scatter primitives, every impl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "sort", "pallas"])
def test_scatter_add_flat_parity_and_drop(rng, impl):
    n, nb = 3000, 500
    idx = rng.integers(-50, nb + 50, n)
    w = rng.normal(0, 1, n).astype(np.float32)
    ref = np.asarray(J.ops.scatter_add_flat(idx, w, nb, impl="xla"))
    got = P.ops.scatter_add_flat(idx, w, nb, impl=impl, device=CPU)
    assert_rel(got, ref, F32_REL)
    if impl != "xla":
        jgot = np.asarray(J.ops.scatter_add_flat(idx, w, nb, impl=impl))
        assert_rel(got, jgot, HILO_REL)
    # dropped, never wrapped
    only_bad = P.ops.scatter_add_flat(np.array([-1, -nb, nb, nb + 7]),
                                      np.ones(4, np.float32), nb, impl=impl,
                                      device=CPU)
    assert float(only_bad.abs().sum()) == 0.0


def test_scatter_add_flat_rejects_matmul_impl():
    with pytest.raises(P.errors.ConfigurationError):
        P.ops.scatter_add_flat(np.zeros(3, int), np.ones(3), 4,
                               impl="matmul", device=CPU)
    with pytest.raises(P.errors.ConfigurationError):
        P.ops.set_default_impl("matmul")


def test_set_default_impl_routes(rng):
    idx = rng.integers(0, 50, 200)
    w = rng.normal(0, 1, 200).astype(np.float32)
    ref = P.ops.scatter_add_flat(idx, w, 50, device=CPU)
    try:
        P.ops.set_default_impl("sort")
        assert P.ops.get_default_impl() == "sort"
        assert_rel(P.ops.scatter_add_flat(idx, w, 50, device=CPU), ref,
                   F32_REL)
    finally:
        P.ops.set_default_impl("xla")


@pytest.mark.parametrize("impl", ["xla", "sort", "pallas", "matmul",
                                  "matmul_bf16"])
def test_scatter_add_2d_parity_truncates(rng, impl):
    H, W = SENSOR
    n = 2000
    ix = rng.uniform(-3, W + 3, n).astype(np.float32)   # trunc, incl. < 0
    iy = rng.uniform(-3, H + 3, n).astype(np.float32)
    w = rng.normal(0, 1, n).astype(np.float32)
    mask = (rng.random(n) > 0.3).astype(np.float32)
    ref = np.asarray(J.ops.scatter_add_2d(ix, iy, w, SENSOR, mask=mask,
                                          impl="xla"))
    got = P.ops.scatter_add_2d(ix, iy, w, SENSOR, mask=mask, impl=impl,
                               device=CPU)
    assert_rel(got, ref, F32_REL)
    if impl.startswith("matmul"):
        jgot = np.asarray(J.ops.scatter_add_2d(ix, iy, w, SENSOR, mask=mask,
                                               impl=impl))
        assert_rel(got, jgot, BF16_REL if impl == "matmul_bf16" else HILO_REL)


@pytest.mark.parametrize("impl", ["xla", "sort", "pallas", "matmul"])
def test_bilinear_scatter_parity(rng, impl):
    x, y, w = float_events(rng)
    mask = (rng.random(len(x)) > 0.2).astype(np.float32)
    ref = np.asarray(J.ops.bilinear_scatter(x, y, w, SENSOR, mask=mask))
    got = P.ops.bilinear_scatter(x, y, w, SENSOR, mask=mask, impl=impl,
                                 device=CPU)
    assert_rel(got, ref, F32_REL)
    if impl == "matmul":
        jgot = np.asarray(J.ops.bilinear_scatter(x, y, w, SENSOR, mask=mask,
                                                 impl="matmul"))
        assert_rel(got, jgot, HILO_REL)


@pytest.mark.parametrize("impl", ["xla", "sort", "matmul"])
def test_bilinear_scatter_derivative_parity(rng, impl):
    x, y, w = float_events(rng, 1500)
    jx = rng.normal(0, 1, (2, len(x))).astype(np.float32)
    jy = rng.normal(0, 1, (2, len(x))).astype(np.float32)
    mask = rng.random(len(x)) > 0.25
    ref = np.asarray(J.ops.bilinear_scatter_derivative(
        x, y, jx, jy, w, SENSOR, mask=mask))
    got = P.ops.bilinear_scatter_derivative(x, y, jx, jy, w, SENSOR,
                                            mask=mask, impl=impl, device=CPU)
    assert_rel(got, ref, F32_REL)
    if impl == "matmul":
        jgot = np.asarray(J.ops.bilinear_scatter_derivative(
            x, y, jx, jy, w, SENSOR, mask=mask, impl="matmul"))
        assert_rel(got, jgot, HILO_REL)


def test_bilinear_gather_parity(rng):
    x, y, _ = float_events(rng, 1000)
    img = rng.normal(0, 1, (3,) + SENSOR).astype(np.float32)
    mask = rng.random(len(x)) > 0.5
    ref = np.asarray(J.ops.bilinear_gather(x, y, img, mask=mask))
    got = P.ops.bilinear_gather(x, y, img, mask=mask, device=CPU)
    assert_rel(got, ref, F32_REL)


def test_sort_impl_is_deterministic_and_matches_jax_sort(rng):
    """The port's deterministic route: bitwise equal from run to run."""
    idx = rng.integers(0, 64, 4000)
    w = rng.normal(0, 1, 4000).astype(np.float32)
    a = P.ops.scatter_add_flat(idx, w, 64, impl="sort", device=CPU)
    b = P.ops.scatter_add_flat(idx, w, 64, impl="sort", device=CPU)
    assert torch.equal(a, b)
    ref = np.asarray(J.ops.scatter_add_flat(idx, w, 64, impl="sort"))
    assert_rel(a, ref, 1e-5 * np.sqrt(4000))  # f32 cumsum differences


# ---------------------------------------------------------------------------
# The three kernel drivers against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["hilo", "bf16", "int8"])
@pytest.mark.parametrize("case", ["plain", "mask", "t0t1", "t1_inside"])
def test_voxel_matmul_parity(rng, precision, case):
    n, B = 3000, 5
    H, W = SENSOR
    xs = rng.integers(-2, W + 2, n)
    ys = rng.integers(-2, H + 2, n)
    ts = np.sort(rng.uniform(0, 0.5, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    kw = {}
    if case == "mask":
        kw["mask"] = (rng.random(n) > 0.3).astype(np.float32)
        kw["mask"][:5] = 0  # the window starts at the first *valid* event
    elif case == "t0t1":
        kw.update(t0=float(ts[0]), t1=float(ts[-1]))
    elif case == "t1_inside":
        kw.update(t1=float(ts[n // 2]))  # out-of-window events fold
    jref = np.asarray(jps.voxel_matmul(xs, ys, ts, ps, B, SENSOR, chunk=512,
                                       precision=precision, interpret=True,
                                       **{k: (jnp.asarray(v) if k == "mask"
                                              else v) for k, v in kw.items()}))
    exact = np.asarray(J.representations.events_to_voxel(
        xs, ys, ts, ps, B, SENSOR, **kw))
    got = cs.voxel_matmul(torch.as_tensor(xs), torch.as_tensor(ys),
                          torch.as_tensor(ts), torch.as_tensor(ps), B, SENSOR,
                          precision=precision,
                          **{k: (torch.as_tensor(v) if k == "mask" else v)
                             for k, v in kw.items()})
    assert_rel(got, exact, F32_REL)
    assert_rel(got, jref, BF16_REL if precision == "bf16" else 2e-4)


def test_voxel_matmul_zero_events_and_bad_precision():
    z = torch.zeros(0, dtype=torch.int64)
    out = cs.voxel_matmul(z, z, z.float(), z.float(), 4, SENSOR)
    assert out.shape == (4,) + SENSOR and float(out.abs().sum()) == 0
    with pytest.raises(P.errors.ConfigurationError):
        cs.voxel_matmul(z, z, z.float(), z.float(), 4, SENSOR,
                        precision="fp8")


def test_image_matmul_parity(rng):
    H, W = SENSOR
    n = 2500
    ix = rng.integers(0, W, n)
    iy = rng.integers(0, H, n)
    w = rng.normal(0, 1, n).astype(np.float32)
    jref = np.asarray(jps.image_matmul(ix, iy, w, SENSOR, chunk=1024,
                                       interpret=True))
    got = cs.image_matmul(torch.as_tensor(ix), torch.as_tensor(iy),
                          torch.as_tensor(w), SENSOR)
    assert_rel(got, jref, HILO_REL)


def test_scatter_add_flat_cuda_parity(rng):
    n, nb = 3000, 700
    idx = rng.integers(-10, nb + 10, n)
    w = rng.normal(0, 1, n).astype(np.float32)
    jref = np.asarray(jps.scatter_add_flat_pallas(idx, w, nb, chunk=1024))
    got = cs.scatter_add_flat_cuda(torch.as_tensor(idx), torch.as_tensor(w),
                                   nb)
    assert_rel(got, jref, HILO_REL)
    two = cs.scatter_add_flat_cuda(torch.as_tensor(idx),
                                   torch.as_tensor(np.stack([w, 2 * w])), nb)
    assert_rel(two[1], 2 * jref, HILO_REL)


@pytest.mark.parametrize("K", [1, 4])
def test_bilinear_matmul_parity(rng, K):
    n = 2000
    x = rng.uniform(-3, 243, n).astype(np.float32)
    y = rng.uniform(-3, 183, n).astype(np.float32)
    w = rng.normal(0, 1, (K, n)).astype(np.float32)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    wj = w[0] if K == 1 else w
    jref = np.asarray(jps.bilinear_matmul(x, y, wj, (181, 241), mask=mask,
                                          chunk=1024, interpret=True))
    got = cs.bilinear_matmul(torch.as_tensor(x), torch.as_tensor(y),
                             torch.as_tensor(wj), (181, 241),
                             mask=torch.as_tensor(mask))
    assert_rel(got, jref, HILO_REL)


def test_bilinear_matmul_grads_match_jax_vjp(rng):
    """The autograd Function's gather backward equals the JAX custom VJP."""
    import jax
    n = 1500
    x = rng.uniform(0, 60, n).astype(np.float32)
    y = rng.uniform(0, 40, n).astype(np.float32)
    w = rng.normal(0, 1, (2, n)).astype(np.float32)
    tgt = rng.normal(0, 1, (2, 41, 61)).astype(np.float32)

    def jloss(x, y, w):
        img = jps.bilinear_matmul(x, y, w, (41, 61), chunk=1024,
                                  interpret=True)
        return jnp.sum(img * tgt)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(x, y, w)
    xt, yt, wt = (torch.tensor(a, requires_grad=True) for a in (x, y, w))
    loss = (cs.bilinear_matmul(xt, yt, wt, (41, 61))
            * torch.as_tensor(tgt)).sum()
    pg = torch.autograd.grad(loss, (xt, yt, wt))
    for a, b in zip(pg, jg):
        assert_rel(a, np.asarray(b), HILO_REL * 10)


def test_voxel_matmul_grads_match_jax_vjp(rng):
    import jax
    n, B = 1000, 4
    H, W = SENSOR
    xs = rng.integers(0, W, n)
    ys = rng.integers(0, H, n)
    ts = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    tgt = rng.normal(size=(B, H, W)).astype(np.float32)
    t0, t1 = float(ts[10]), float(ts[-10])  # edge folds on both sides

    def jloss(p, t):
        v = jps.voxel_matmul(xs, ys, t, p, B, SENSOR, chunk=256,
                             interpret=True, t0=t0, t1=t1)
        return jnp.sum(v * tgt)

    jgp, jgt = jax.grad(jloss, argnums=(0, 1))(ps, ts)
    pt = torch.tensor(ps, requires_grad=True)
    tt = torch.tensor(ts, requires_grad=True)
    v = cs.voxel_matmul(torch.as_tensor(xs), torch.as_tensor(ys), tt, pt, B,
                        SENSOR, t0=t0, t1=t1)
    gp, gt = torch.autograd.grad((v * torch.as_tensor(tgt)).sum(), (pt, tt))
    assert_rel(gp, np.asarray(jgp), 1e-4)
    assert_rel(gt, np.asarray(jgt), 1e-4)


def test_flat_scatter_grad_is_gather(rng):
    idx = torch.as_tensor(rng.integers(-5, 60, 300))
    w = torch.tensor(rng.normal(size=(2, 300)).astype(np.float32),
                     requires_grad=True)
    g = torch.as_tensor(rng.normal(size=(2, 55)).astype(np.float32))
    (gw,) = torch.autograd.grad((cs.scatter_add_flat_cuda(idx, w, 55) * g)
                                .sum(), (w,))
    ok = (idx >= 0) & (idx < 55)
    ref = torch.where(ok[None], g[:, idx.clamp(0, 54)], 0.0)
    assert torch.equal(gw, ref)


def test_kernel_wrappers_run_plain_on_cpu_and_check_inputs(rng):
    cs.reset_launch_counts()
    x, y, w = (torch.as_tensor(a) for a in float_events(rng, 300))
    out = cs.bilinear_scatter(x, y, w[None], *SENSOR)
    assert torch.equal(out, cs.bilinear_scatter_plain(x, y, w[None],
                                                      *SENSOR))
    idx = torch.as_tensor(rng.integers(0, 100, 300), dtype=torch.int32)
    assert torch.equal(cs.flat_scatter(idx, w[None], 100),
                       cs.flat_scatter_plain(idx, w[None], 100))
    bx = idx.view(3, 100) % 8
    bt = torch.rand(3, 100)
    assert torch.equal(cs.voxel_tiles_scatter(bx, bx, bt, w.view(3, 100), 2,
                                              8, 8),
                       cs.voxel_tiles_scatter_plain(bx, bx, bt,
                                                    w.view(3, 100), 2, 8, 8))
    counts = cs.launch_counts()
    assert set(counts) == set(cs.ROUTES) == set(cs.KERNEL_WRAPPERS)
    assert {r.split(":")[0] for r in counts} == {
        "voxel_scatter", "voxel_scatter_batched", "voxel_tiles_scatter",
        "flat_scatter", "bilinear_scatter", "bilinear_scatter_batched",
        "bilinear_patches_scatter", "patch_variance_vg"}
    assert not any(counts.values())
    with pytest.raises(P.errors.ConfigurationError):
        cs.flat_scatter(idx.long(), w[None], 100)       # wrong id type
    with pytest.raises(P.errors.ConfigurationError):     # (T, cap) shapes
        cs.voxel_tiles_scatter(bx, bx[:2], bt, w.view(3, 100), 2, 8, 8)
    with pytest.raises(P.errors.ConfigurationError):
        cs.bilinear_scatter(x, y, w, *SENSOR)           # w must be (K, N)


# ---------------------------------------------------------------------------
# Blur and the build module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [0.7, 1.0, 2.5])
def test_gaussian_filter_parity(rng, sigma):
    img = rng.normal(size=(30, 41)).astype(np.float32)
    got = P.ops.gaussian_filter(img, sigma, device=CPU)
    assert_rel(got, np.asarray(J.ops.gaussian_filter(jnp.asarray(img),
                                                     sigma)), F32_REL)
    assert_rel(got, scipy.ndimage.gaussian_filter(img.astype(np.float64),
                                                  sigma, mode="reflect"),
               F32_REL)


def test_gaussian_filter_small_axis_subset_and_int(rng):
    stack = rng.normal(size=(2, 20, 25)).astype(np.float32)
    got = P.ops.gaussian_filter(torch.as_tensor(stack), 1.0)   # all axes
    assert_rel(got, scipy.ndimage.gaussian_filter(stack.astype(np.float64),
                                                  1.0), F32_REL)
    sp = P.ops.gaussian_blur_image(torch.as_tensor(stack), 1.5)
    assert_rel(sp, np.asarray(J.ops.gaussian_blur_image(jnp.asarray(stack),
                                                        1.5)), F32_REL)
    counts = rng.integers(0, 9, (16, 16)).astype(np.int32)
    gi = P.ops.gaussian_filter(torch.as_tensor(counts), 1.0)
    assert gi.dtype == torch.int32
    assert np.array_equal(gi.numpy(), np.asarray(
        J.ops.gaussian_filter(jnp.asarray(counts), 1.0)))


def test_blur_and_bfgs_run_without_tf32(monkeypatch):
    """cuDNN would run the blur's f32 conv1d in TF32: the blur and the BFGS
    turn both TF32 flags off for their duration and restore them."""
    import torch.nn.functional as F
    from event_utils_tpu_torch.contrast_max.bfgs import minimize_bfgs
    from event_utils_tpu_torch.ops import blur

    seen = []
    real_conv = F.conv1d

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real_conv(*a, **k)

    monkeypatch.setattr(blur.F, "conv1d", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    P.ops.gaussian_filter(torch.ones(8, 8), 1.0)

    def vg(x):
        img = P.ops.gaussian_filter((x[0] - torch.ones(8, 8)) ** 2, 1.0)
        return img.sum(), 2 * (x - 1)

    minimize_bfgs(vg, torch.zeros(2), maxiter=2)
    assert seen and all(s == (False, False) for s in seen)
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_build_cache_key_and_missing_nvcc(monkeypatch, tmp_path):
    p1 = build._lib_path("scatter_kernels")
    assert p1 == build._lib_path("scatter_kernels")
    assert p1.parent.parent == build.BUILD_DIR
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._lib_path("scatter_kernels") != p1
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(P.errors.NativeBuildError):
        build._nvcc()
