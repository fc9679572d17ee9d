"""Parity of the port's time sorts (``ops/sort.py``) with the JAX
package's, on the CPU.

The same numpy keys (k-sorted and random, with ties, +inf pads, ``n <=
block`` and a block too small for the displacement, so that JAX's fallback
runs) go through both packages: JAX's row passes and fallback, the port's
one stable global sort. Sorts are stable, so the permutations, sorted keys
and payloads must be identical; the displacement bound and the block
picked must be equal integers.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from event_utils_tpu.ops import sort as jsort
from event_utils_tpu_torch.ops import sort as psort

torch.set_num_threads(1)


def k_sorted(rng, n, block, ties=False, pad=True):
    """Keys whose displacement is at most ``block // 2`` (as in
    ``tests/test_ops.py``), optionally with duplicates and a +inf tail."""
    base = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    spacing = np.median(np.diff(base))
    keys = base + (rng.uniform(-1, 1, n).astype(np.float32) * spacing
                   * (block // 4) * 0.5)
    if ties:
        keys = np.round(keys * 200) / 200  # many equal keys
        keys = keys.astype(np.float32)
    if pad:
        keys[-n // 50:] = np.inf
    return keys


CASES = [
    ("k-sorted", 1 << 12, 64, dict()),
    ("k-sorted, odd length", 3000, 128, dict()),
    ("k-sorted, short", 513, 32, dict()),
    ("ties", 2048, 64, dict(ties=True)),
    ("no pads", 1000, 32, dict(pad=False)),
]


@pytest.mark.parametrize("name,n,block,kw", CASES, ids=[c[0] for c in CASES])
def test_nearly_sorted_argsort_matches_jax(rng, name, n, block, kw):
    """JAX's row passes (their bound holds) and the port's global sort give
    one permutation, the stable argsort's."""
    keys = k_sorted(rng, n, block, **kw)
    got = psort.nearly_sorted_argsort(torch.as_tensor(keys), block)
    want = np.asarray(jsort.nearly_sorted_argsort(jnp.asarray(keys), block))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("block", [1, 2048, 4096, 1 << 14])
def test_block_at_least_n_and_tiny_blocks_sort_globally(rng, block):
    """``n <= block`` (and a block < 2): JAX's global sort, the port's."""
    keys = rng.uniform(0, 1, 2048).astype(np.float32)
    keys[::7] = keys[3]  # ties
    order = psort.nearly_sorted_argsort(torch.as_tensor(keys), block)
    want = np.asarray(jsort.nearly_sorted_argsort(jnp.asarray(keys), block))
    np.testing.assert_array_equal(order.numpy(), want)
    k = psort.nearly_sorted_sort(torch.as_tensor(keys), block=block)[0]
    np.testing.assert_array_equal(k.numpy(), keys[want])


def test_fallback_on_a_block_too_small(rng):
    """Random keys (displacement ~ n) against block 32: JAX's row passes
    fail its check and its global sort runs; the port's answer is that
    sort's."""
    keys = rng.uniform(0, 1, 4096).astype(np.float32)
    order = psort.nearly_sorted_argsort(torch.as_tensor(keys), 32)
    want = np.asarray(jsort.nearly_sorted_argsort(jnp.asarray(keys), 32))
    np.testing.assert_array_equal(order.numpy(), want)
    k = psort.nearly_sorted_sort(torch.as_tensor(keys), block=32)[0]
    np.testing.assert_array_equal(k.numpy(), np.sort(keys))


@pytest.mark.parametrize("block", [None, 64, 128, 32])
def test_payload_sorts_match_jax(rng, block):
    """time_sort and nearly_sorted_sort permute payloads as JAX's do (JAX's
    block 64 honours the bound, 128 is loose, 32 falls back)."""
    n = 3000
    base = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    keys = base + rng.uniform(-1, 1, n).astype(np.float32) * 16 * \
        np.median(np.diff(base))
    keys[-40:] = np.inf
    pay_i = rng.integers(0, 240, n).astype(np.int32)
    pay_f = rng.normal(size=n).astype(np.float32)
    if block is None:
        got = psort.time_sort(torch.as_tensor(keys), torch.as_tensor(pay_i),
                              torch.as_tensor(pay_f))
        want = jsort.time_sort(jnp.asarray(keys), jnp.asarray(pay_i),
                               jnp.asarray(pay_f))
    else:
        got = psort.nearly_sorted_sort(torch.as_tensor(keys),
                                       torch.as_tensor(pay_i), pay_f,
                                       block=block)
        want = jsort.nearly_sorted_sort(jnp.asarray(keys),
                                        jnp.asarray(pay_i),
                                        jnp.asarray(pay_f), block=block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("pad", [False, True])
def test_displacement_bound_and_block_match_jax(rng, pad):
    """The bound and the block of an interleaved jittered stream equal
    JAX's (+inf pads left out of the max), the bound covers the true
    displacement, and JAX's row passes at that block and the port's sort
    give the stable argsort."""
    n = 20000
    ts = np.sort(rng.uniform(0, 0.25, n)).astype(np.float32)
    delta = 0.001 * 6
    keys = np.concatenate([ts, np.full(n // 4, np.inf, np.float32)]) \
        if pad else ts
    d = psort.displacement_bound(torch.as_tensor(keys), delta, copies=2)
    assert d.dtype == torch.int32
    assert int(d) == int(jsort.displacement_bound(jnp.asarray(keys), delta,
                                                  copies=2))
    # delta as a device scalar gives the same
    assert int(psort.displacement_bound(
        torch.as_tensor(keys), torch.tensor(delta), copies=2)) == int(d)
    block = psort.sort_block_for(torch.as_tensor(keys), delta, copies=2)
    assert block == jsort.sort_block_for(jnp.asarray(keys), delta, copies=2)
    jit_ts = ts + rng.normal(0, 0.001, n).astype(np.float32)
    inter = np.stack([ts, jit_ts], 1).reshape(-1)
    want = np.argsort(inter, kind="stable")
    pos = np.empty(2 * n, np.int64)
    pos[want] = np.arange(2 * n)
    assert int(d) >= np.abs(pos - np.arange(2 * n)).max()
    np.testing.assert_array_equal(np.asarray(jsort.nearly_sorted_argsort(
        jnp.asarray(inter), block)), want)
    np.testing.assert_array_equal(psort.nearly_sorted_argsort(
        torch.as_tensor(inter), block).numpy(), want)


@pytest.mark.parametrize("delta,block", [(0.0, 4), (7.0, 128),
                                         (1000.0, 1 << 14), (1100.0, None)])
def test_sort_block_for_limits(delta, block):
    """Stamps 0, 1, 2, ...: the bound at an integer delta is 2 (4 delta + 1),
    its block the power of two at least twice it, None above
    MAX_SORT_BLOCK; JAX's block too."""
    ts = np.arange(40000, dtype=np.float32)
    got = psort.sort_block_for(torch.as_tensor(ts), delta, copies=2)
    assert got == block
    assert got == jsort.sort_block_for(jnp.asarray(ts), delta, copies=2)
    assert psort.MAX_SORT_BLOCK == jsort.MAX_SORT_BLOCK
