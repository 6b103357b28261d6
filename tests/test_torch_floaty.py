"""Floaty removal in the PyTorch port against the JAX package.

Both modules are host code (numpy/scipy, and the same native C++ core
through ctypes), so everything is held exactly: the clustering, the cleaned
grid and the cluster count, on seeded multi-blob grids whose blobs cross
mip boundaries; in the port, native == scipy.
"""

import subprocess

import numpy as np
import pytest

from nerf_glasses_tpu.models import floaty as jfloaty
from nerf_glasses_tpu_torch.models import _native_floaty as tnative
from nerf_glasses_tpu_torch.models import floaty as tfloaty

SEEDS = [0, 1, 2]


def _no_library():
    raise OSError("no native library in this test")


def scipy_remove(grid):
    """The port's remove_floaties with the native library out of reach:
    its numpy/scipy path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "_load", _no_library)
        out = tfloaty.remove_floaties(grid)
    assert tfloaty.last_backend == "scipy"
    return out


def _ball(g, mip, centre, radius):
    idx = np.arange(128)
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    cx, cy, cz = centre
    g[mip][(x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 < radius * radius] = 1


def make_grid(seed):
    """(8, 128, 128, 128) occupancy: a main blob at the centre of mip 0, a
    blob that leaves mip 0 through its +x face and continues in mip 1, a
    blob in mip 1's outer shell that reaches into mip 2, and seeded small
    floaters on mips 0-2; coarser mips pooled as bitfield_max_pool does."""
    rng = np.random.default_rng(seed)
    g = np.zeros((8, 128, 128, 128), np.uint8)
    _ball(g, 0, (64, 64, 64), 12)
    _ball(g, 0, (124, 40, 60), 6)          # cut by the x = 127 face of mip 0
    _ball(g, 1, (97, 52, 62), 4)           # its continuation in mip 1
    _ball(g, 1, (125, 100, 20), 5)         # cut by the x = 127 face of mip 1
    _ball(g, 2, (97, 82, 42), 3)
    for _ in range(6):
        mip = int(rng.integers(0, 3))
        c = rng.integers(6, 122, 3)
        _ball(g, mip, tuple(c), int(rng.integers(2, 5)))
    for _ in range(4):                     # single cells: noise
        mip = int(rng.integers(0, 2))
        x, y, z = rng.integers(2, 30, 3)
        g[mip, z, y, x] = 1
    for lvl in range(1, 8):
        pooled = g[lvl - 1].reshape(64, 2, 64, 2, 64, 2).max(axis=(1, 3, 5))
        g[lvl][32:96, 32:96, 32:96] |= pooled
    return g


@pytest.fixture(scope="module", params=SEEDS)
def grid(request):
    return make_grid(request.param)


def test_point_set_and_clusters_equal_jax(grid):
    labels_j, pts_j, n_j = jfloaty.cluster(grid)
    labels_t, pts_t, n_t = tfloaty.cluster(grid)
    assert n_t == n_j and n_t >= 4
    for a, b in zip(pts_t, pts_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(labels_t, labels_j)
    assert pts_t[0].max() >= 2                # points beyond mip 1
    np.testing.assert_array_equal(
        tfloaty.cluster_importance(labels_t, pts_t[0], n_t),
        jfloaty.cluster_importance(labels_j, pts_j[0], n_j))


def test_cleaned_grid_equals_jax(grid):
    """The port's numpy/scipy path against the JAX package's
    remove_floaties (whichever of its two paths runs here)."""
    out_j, count_j = jfloaty.remove_floaties(grid)
    out_t, count_t = scipy_remove(grid)
    assert count_t == count_j and count_t >= 4
    np.testing.assert_array_equal(out_t, out_j)
    assert out_t.dtype == np.uint8
    assert out_t[0, 64, 64, 64] == 1 and out_t[1, 64, 64, 64] == 1
    assert out_t.sum() < grid.sum()
    # what survives was there before
    assert not (out_t & ~grid.astype(bool)).any()


def test_native_equals_scipy_in_the_port(grid):
    out_s, count_s = scipy_remove(grid)
    out_n, count_n = tfloaty.remove_floaties(grid)
    if tfloaty.last_backend != "native":
        pytest.skip(f"native core unavailable: {tfloaty.last_native_error}")
    assert tfloaty.last_native_error is None
    assert count_n == count_s
    np.testing.assert_array_equal(out_n, out_s)


def test_cluster_crosses_mip_boundary():
    """Only the blob cut by mip 0's +x face and its continuation in mip 1:
    one cluster, and it survives whole."""
    g = np.zeros((8, 128, 128, 128), np.uint8)
    _ball(g, 0, (124, 40, 60), 6)
    _ball(g, 1, (97, 52, 62), 4)
    labels, (m, x, y, z), n = tfloaty.cluster(g)
    assert n == 1 and set(np.unique(m)) == {0, 1}
    out, count = scipy_remove(g)
    assert count == 1
    assert out[0, 60, 40, 124] == 1 and out[1, 62, 52, 97] == 1


def test_empty_grid():
    g = np.zeros((8, 128, 128, 128), np.uint8)
    out, count = scipy_remove(g)
    assert count == 0 and not out.any()


@pytest.mark.parametrize("error", [
    OSError("wrong ELF class"),
    subprocess.CalledProcessError(2, ["make"])], ids=["load", "build"])
def test_native_failure_is_recorded(monkeypatch, error):
    """When the library neither loads nor builds the scipy path runs, and
    the module says so and why."""
    def fail():
        raise error

    monkeypatch.setattr(tnative, "_load", fail)
    g = make_grid(0)
    out, count = tfloaty.remove_floaties(g)
    assert tfloaty.last_backend == "scipy"
    assert type(error).__name__ in tfloaty.last_native_error
    ref, ref_count = jfloaty.remove_floaties(g)
    assert count == ref_count
    np.testing.assert_array_equal(out, ref)
