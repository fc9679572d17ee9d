"""The port's native ingest runtime (``event_utils_tpu_torch.native``)
against the JAX package's, on the CPU.

Every entry point is held to JAX's exactly (integer tables and float32
arrays equal element for element: both assemble the same f64 differences
and cast them to f32 once), and to the port's own numpy ``*_plain``
versions exactly. The port's ``csrc/evio.cpp`` is the JAX source byte for
byte. A failed build raises ``NativeBuildError``; nothing falls back to
numpy. The JAX functions run as they are (native when JAX's library was
built before, else its numpy fallbacks, which compute the same arrays).
"""

import os

import numpy as np
import pytest

from event_utils_tpu import native as jnative
from event_utils_tpu.contrast_max.events_cmax import \
    bucket_events_by_roi as j_bucket
from event_utils_tpu.errors import ConfigurationError as JConfigurationError
from event_utils_tpu.errors import DataFormatError as JDataFormatError
from event_utils_tpu_torch import native
from event_utils_tpu_torch.contrast_max.events_cmax import \
    bucket_events_by_roi
from event_utils_tpu_torch.errors import (ConfigurationError,
                                          DataFormatError, NativeBuildError)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stream(seed, n, W=240, H=180, t_max=1.0):
    g = np.random.default_rng(seed)
    t = np.sort(g.uniform(0, t_max, n))
    xy = np.stack([g.integers(0, W, n), g.integers(0, H, n)],
                  1).astype(np.int16)
    p = g.integers(0, 2, n).astype(np.uint8)
    return t, xy, p


def assert_fill_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_evio_source_is_the_jax_source_byte_for_byte():
    with open(os.path.join(ROOT, "event_utils_tpu", "native", "evio.cpp"),
              "rb") as f:
        ref = f.read()
    assert native.SRC.read_bytes() == ref


def test_library_builds_into_the_port_build_dir():
    native.library()
    assert native.available()
    path = native.lib_path()
    assert path.exists() and path.parent.parent == native.BUILD_DIR


def test_build_key_holds_the_host_target(monkeypatch):
    """The library is built with ``-march=native``: its key holds what the
    compiler makes of that here, so one built on another CPU (a carried
    ``_build/``) is never loaded."""
    here = native.lib_path()
    assert "-march=" in native.host_target()
    monkeypatch.setattr(native, "host_target",
                        lambda compiler=native.CXX: "another host's target")
    assert native.lib_path() != here
    assert native.lib_path().parent.parent == here.parent.parent


@pytest.mark.parametrize("compiler", ["no-such-compiler", "false"])
def test_failed_build_raises_instead_of_falling_back(tmp_path, compiler):
    cxx = str(tmp_path / compiler) if compiler.startswith("no-") else \
        compiler
    with pytest.raises(NativeBuildError):
        native.build(compiler=cxx, build_dir=tmp_path)
    assert not native.lib_path(cxx, tmp_path).exists()


def test_entry_points_raise_when_the_library_cannot_be_built(monkeypatch):
    def broken():
        raise NativeBuildError("no toolchain")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    t, xy, p = stream(0, 100)
    with pytest.raises(NativeBuildError):
        native.fill_padded_batches(t, xy, p, np.array([[0, 50]]), 64)
    with pytest.raises(NativeBuildError):
        native.bucket_fill(xy[:, 0], xy[:, 1], t, p, (20, 20), (9, 12), 64)


def test_searchsorted_matches_jax():
    t, _, _ = stream(1, 5000)
    for x in (-1.0, 0.0, 0.33, float(t[17]), float(t[-1]), 2.0):
        for side in ("left", "right"):
            want = jnative.searchsorted_f64(t, x, side)
            assert native.searchsorted_f64(t, x, side) == want
            assert native.searchsorted_f64_plain(t, x, side) == want


@pytest.mark.parametrize("n,k,overlap", [(10000, 1000, 0), (10000, 1000, 500),
                                         (10007, 999, 333), (500, 1000, 0),
                                         (1000, 1000, 0)])
def test_k_event_windows_match_jax(n, k, overlap):
    want = jnative.k_event_windows(n, k, overlap)
    got = native.k_event_windows(n, k, overlap)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.k_event_windows_plain(n, k, overlap),
                                  want)


@pytest.mark.parametrize("width,overlap", [(0.25, 0.0), (0.1, 0.03),
                                           (0.07, 0.05), (2.0, 0.0)])
def test_t_second_windows_match_jax(width, overlap):
    t, _, _ = stream(2, 10000)
    want = jnative.t_second_windows(t, width, overlap)
    got = native.t_second_windows(t, width, overlap)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.t_second_windows_plain(t, width, overlap), got)
    assert native.t_second_windows(np.zeros(0), width, overlap).shape == \
        (0, 2)


def test_degenerate_strides_raise_like_jax():
    for fn, jfn, args in (
            (native.k_event_windows, jnative.k_event_windows, (1000, 100,
                                                               100)),
            (native.k_event_windows_plain, jnative.k_event_windows,
             (1000, 100, 150)),
            (native.t_second_windows, jnative.t_second_windows,
             (np.linspace(0, 1, 100), 0.1, 0.1)),
            (native.t_second_windows_plain, jnative.t_second_windows,
             (np.linspace(0, 1, 100), 0.1, 0.2))):
        with pytest.raises(JConfigurationError):
            jfn(*args)
        with pytest.raises(ConfigurationError, match="never advances"):
            fn(*args)


# windows: in range, truncated past capacity, clamped past the end,
# inverted, empty, and from a negative start
WINDOWS = np.array([[0, 1000], [1000, 3500], [4000, 6000], [5900, 7000],
                    [300, 200], [10, 10], [-50, 500]], np.int64)


@pytest.mark.parametrize("relative_time", [True, False])
@pytest.mark.parametrize("nthreads", [1, 3, 0])
def test_fill_padded_batches_match_jax(relative_time, nthreads):
    t, xy, p = stream(3, 6000)
    kw = dict(relative_time=relative_time)
    want = jnative.fill_padded_batches(t, xy, p, WINDOWS, 2048, **kw)
    assert want[2] > 0  # the second window is truncated
    got = native.fill_padded_batches(t, xy, p, WINDOWS, 2048,
                                     nthreads=nthreads, **kw)
    assert_fill_equal(got, want)
    assert_fill_equal(native.fill_padded_batches_plain(t, xy, p, WINDOWS,
                                                       2048, **kw), want)
    assert got[1][4].sum() == 0 and got[1][5].sum() == 0  # all padding
    # into persistent buffers
    out = (np.full((len(WINDOWS), 2048, 4), 7, np.float32),
           np.full((len(WINDOWS), 2048), 7, np.float32))
    again = native.fill_padded_batches(t, xy, p, WINDOWS, 2048, out=out,
                                       nthreads=nthreads, **kw)
    assert again[0] is out[0] and again[1] is out[1]
    assert_fill_equal(again, want)


@pytest.mark.parametrize("relative_time", [True, False])
@pytest.mark.parametrize("nthreads", [1, 8])
def test_fill_padded_batches_components_match_jax(relative_time, nthreads):
    t, xy, p = stream(4, 6000)
    xs, ys = xy[:, 0].astype(np.int32), xy[:, 1].astype(np.uint16)
    kw = dict(relative_time=relative_time)
    want = jnative.fill_padded_batches_components(t, xs, ys, p, WINDOWS,
                                                  1024, **kw)
    got = native.fill_padded_batches_components(t, xs, ys, p, WINDOWS, 1024,
                                                nthreads=nthreads, **kw)
    assert_fill_equal(got, want)
    assert_fill_equal(native.fill_padded_batches_components_plain(
        t, xs, ys, p, WINDOWS, 1024, **kw), want)
    # the interleaved form of the same events gives the same batch
    assert_fill_equal(native.fill_padded_batches(t, xy, p, WINDOWS, 1024,
                                                 **kw), got)


def test_one_thread_matches_many():
    t, xy, p = stream(5, 20000)
    windows = native.k_event_windows(len(t), 512, 100)
    assert_fill_equal(native.fill_padded_batches(t, xy, p, windows, 512,
                                                 nthreads=1),
                      native.fill_padded_batches(t, xy, p, windows, 512,
                                                 nthreads=16))


@pytest.mark.parametrize("bad", ["events_shape", "mask_dtype",
                                 "events_order"])
def test_out_guard_raises_before_any_write(bad):
    t, xy, p = stream(6, 1000)
    w = np.array([[0, 500], [500, 1000]])
    events = np.zeros((2, 512, 4), np.float32)
    mask = np.zeros((2, 512), np.float32)
    if bad == "events_shape":
        events = np.zeros((2, 256, 4), np.float32)
    elif bad == "mask_dtype":
        mask = np.zeros((2, 512), np.float64)
    else:
        # right shape and type, not C-contiguous: the port refuses it too
        events = np.asfortranarray(events)
    before = events.copy()
    if bad != "events_order":
        with pytest.raises(JDataFormatError):
            jnative.fill_padded_batches(t, xy, p, w, 512, out=(events, mask))
    with pytest.raises(DataFormatError):
        native.fill_padded_batches(t, xy, p, w, 512, out=(events, mask))
    with pytest.raises(DataFormatError):
        native.fill_padded_batches_components(t, xy[:, 0], xy[:, 1], p, w,
                                              512, out=(events, mask))
    np.testing.assert_array_equal(events, before)


def roi_stream(seed, n, H, W):
    g = np.random.default_rng(seed)
    return (g.uniform(-0.5, W - 0.5, n), g.uniform(-0.5, H - 0.5, n),
            np.sort(g.uniform(0, 1, n)), g.choice([-1.0, 1.0], n))


@pytest.mark.parametrize("H,W,roi", [(180, 240, (20, 20)), (96, 128, (32, 32)),
                                     (100, 130, (24, 40))])
def test_bucket_fill_matches_jax_bucketing(H, W, roi):
    xs, ys, ts, ps = roi_stream(7, 20000, H, W)
    ny, nx = -(-H // roi[0]), -(-W // roi[1])
    want = j_bucket(xs, ys, ts, ps, (H, W), roi, capacity_cap=None)
    assert want[6] == 0  # no ROI overflows: the fill JAX shortcuts
    cap = want[0].shape[1]
    got = native.bucket_fill(xs, ys, ts, ps, roi, (ny, nx), cap)
    plain = native.bucket_fill_plain(xs, ys, ts, ps, roi, (ny, nx), cap)
    for a, b, c in zip(got[:5], plain[:5], want[:5]):
        np.testing.assert_array_equal(a, np.asarray(c))
        np.testing.assert_array_equal(b, np.asarray(c))
    assert got[5] == plain[5] == 0
    # the port's bucketing takes the native fill and returns the same
    port = bucket_events_by_roi(xs, ys, ts, ps, (H, W), roi,
                                capacity_cap=None, device="cpu")
    for a, c in zip(port[:6], want[:6]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert port[6] == 0


def test_bucket_fill_truncates_in_time_order():
    xs, ys, ts, ps = roi_stream(8, 5000, 40, 40)
    got = native.bucket_fill(xs, ys, ts, ps, (20, 20), (2, 2), 512)
    plain = native.bucket_fill_plain(xs, ys, ts, ps, (20, 20), (2, 2), 512)
    for a, b in zip(got[:5], plain[:5]):
        np.testing.assert_array_equal(a, b)
    assert got[5] == plain[5] == 5000 - 4 * 512
    assert (got[4] == 1).all() and (np.diff(got[2], axis=1) >= 0).all()
    # coordinates out of the grid clamp to its edge buckets
    edge = native.bucket_fill([-30.0, 500.0], [-2.0, 900.0], [0.0, 1.0],
                              [1.0, -1.0], (20, 20), (2, 2), 4)
    assert edge[4][0, 0] == 1 and edge[4][3, 0] == 1 and edge[5] == 0
