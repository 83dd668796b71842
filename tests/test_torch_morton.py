"""Parity of the port's morton codes and occupancy-bitfield packing
(laenerf_tpu_torch/ops/morton.py) with the JAX package's
(laenerf_tpu/ops/morton.py), on seeded numpy inputs. Every comparison is
exact: the port computes the uint32 values in int64 with 32-bit masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laenerf_tpu.ops import morton as jm
from laenerf_tpu_torch.ops import morton as tm


def _coords(seed, n=4096, high=1024):
    coords = np.random.RandomState(seed).randint(0, high, (n, 3)).astype(
        np.int32)
    # the corners of the 10-bit range, and each axis alone at its top
    coords[:5] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 0], [0, 1023, 0],
                  [0, 0, 1023]]
    return coords


@pytest.mark.parametrize("seed", [0, 1])
def test_morton3d_matches_jax(seed):
    coords = _coords(seed)
    ref = np.asarray(jm.morton3d(jnp.asarray(coords))).astype(np.int64)
    got = tm.morton3d(torch.tensor(coords))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0] == 0 and ref[1] == (1 << 30) - 1
    # the inverse, from the same codes, and the round trip
    inv = tm.morton3d_invert(got)
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jm.morton3d_invert(
            jnp.asarray(ref.astype(np.uint32)))))
    np.testing.assert_array_equal(inv.numpy(), coords)


def test_morton3d_wraps_as_uint32():
    """Coordinates past 10 bits and negative ones (the int32 -> uint32
    cast) give JAX's uint32 codes, and codes with the top bits set invert
    as JAX inverts them."""
    rng = np.random.RandomState(2)
    coords = rng.randint(-(1 << 31), (1 << 31) - 1, (2048, 3)).astype(
        np.int32)
    ref = np.asarray(jm.morton3d(jnp.asarray(coords))).astype(np.int64)
    np.testing.assert_array_equal(tm.morton3d(torch.tensor(coords)).numpy(),
                                  ref)
    codes = rng.randint(0, 1 << 32, 2048, dtype=np.int64)
    np.testing.assert_array_equal(
        tm.morton3d_invert(torch.tensor(codes)).numpy(),
        np.asarray(jm.morton3d_invert(jnp.asarray(codes.astype(np.uint32)))))


@pytest.mark.parametrize("shape,thresh", [((512,), 0.5), ((2, 4, 64), 0.2),
                                          ((1, 32 ** 3), 0.9)])
def test_packbits_round_trip_matches_jax(shape, thresh):
    grid = np.random.RandomState(3).rand(*shape).astype(np.float32)
    ref = np.asarray(jm.packbits(jnp.asarray(grid), thresh))
    got = tm.packbits(torch.tensor(grid), thresh)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    bits = tm.unpackbits(got)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jm.unpackbits(jnp.asarray(ref))))
    np.testing.assert_array_equal(bits.numpy(),
                                  (grid > thresh).astype(np.uint8))
    np.testing.assert_array_equal(tm.packbits(bits.float(), 0.5).numpy(),
                                  ref)
