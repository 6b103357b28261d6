"""Floaty removal: multi-mip occupancy clustering, keep the main cluster.

Port of nerf_glasses_tpu/models/floaty.py (host code, numpy and scipy; no
tensor framework). Reimplements NgpGrid (reference: src/floatyremover.h:
11-267) with vectorized connected components instead of a per-point
flood fill:

- point set = occupied cells over all 8 mips, where mips > 0 skip the
  interior region [32, 96)^3 (covered by the finer mip) - floatyremover.h:41
- edges: 6-neighborhood within a mip, plus cross-mip edges where a mip-m
  boundary cell (coord 0 or 127) touches the adjacent mip-(m+1) cell
  (coords 31 / 96), and the reverse parent->child pairs
- connected components via scipy.sparse.csgraph (union-find equivalent)
- cluster importance = sum over points of (16 - 2^level)
  (floatyremover.h:253-266)
- the winning cluster is re-rasterized into the grid, each point also
  setting its ancestors in all coarser mips (to_ngp_grid,
  floatyremover.h:236-251).

The C++ core (native/floaty.cpp through models/_native_floaty.py) runs
when its library loads or builds; otherwise this numpy/scipy code does,
which is also the test oracle. Both give the same grid. `last_backend`
says which ran ("native" or "scipy"), and `last_native_error` why the
native core did not.
"""

from __future__ import annotations

import subprocess

import numpy as np

GRID = 128
N_MIPS = 8

last_backend = None         # "native" | "scipy": what remove_floaties ran
last_native_error = None    # why the native core did not run, else None


def _keys(m, x, y, z):
    return (((m.astype(np.int64) * GRID + z) * GRID + y) * GRID + x)


def build_point_set(occ_linear: np.ndarray):
    """occ_linear: (8, 128, 128, 128) uint8/bool in [mip, z, y, x] layout.
    Returns (m, x, y, z) int arrays of points (interior of mips>0 skipped).
    """
    occ = occ_linear.astype(bool).copy()
    interior = slice(32, 96)
    occ[1:, interior, interior, interior] = False
    m, z, y, x = np.nonzero(occ)
    return m.astype(np.int32), x.astype(np.int32), y.astype(np.int32), z.astype(np.int32)


def _edges_within_mip(m, x, y, z, key_set):
    edges = []
    for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        nx, ny, nz = x + dx, y + dy, z + dz
        ok = (nx < GRID) & (ny < GRID) & (nz < GRID)
        kk = _keys(m[ok], nx[ok], ny[ok], nz[ok])
        src = np.nonzero(ok)[0]
        edges.append((src, kk))
    return edges


def _edges_cross_mip(m, x, y, z, key_set):
    """Child boundary (coord 0/127) -> parent cells 31/96 at mip+1
    (floatyremover.h:84-101); the reverse direction is implied for
    connectivity purposes."""
    edges = []
    mx = 32 + x // 2
    my = 32 + y // 2
    mz = 32 + z // 2
    child_ok = m < N_MIPS - 1
    for axis, coord, parent_val in (
            (0, 0, 31), (0, GRID - 1, 96),
            (1, 0, 31), (1, GRID - 1, 96),
            (2, 0, 31), (2, GRID - 1, 96)):
        c = (x, y, z)[axis]
        sel = child_ok & (c == coord)
        if not sel.any():
            continue
        px, py, pz = mx[sel], my[sel], mz[sel]
        if axis == 0:
            px = np.full_like(px, parent_val)
        elif axis == 1:
            py = np.full_like(py, parent_val)
        else:
            pz = np.full_like(pz, parent_val)
        kk = _keys(m[sel] + 1, px, py, pz)
        src = np.nonzero(sel)[0]
        edges.append((src, kk))
    return edges


def cluster(occ_linear: np.ndarray):
    """-> (labels (P,), points (m,x,y,z), n_clusters).

    Isolated points (no neighbors) are treated as noise and excluded from
    clusters (floatyremover.h:198-234 discards them).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    m, x, y, z = build_point_set(occ_linear)
    n = len(m)
    if n == 0:
        return np.zeros(0, np.int32), (m, x, y, z), 0
    keys = _keys(m, x, y, z)
    order = np.argsort(keys)
    sorted_keys = keys[order]

    def lookup(target_keys):
        idx = np.searchsorted(sorted_keys, target_keys)
        idx = np.clip(idx, 0, n - 1)
        ok = sorted_keys[idx] == target_keys
        return order[idx], ok

    rows, cols = [], []
    for src, kk in (_edges_within_mip(m, x, y, z, sorted_keys)
                    + _edges_cross_mip(m, x, y, z, sorted_keys)):
        dst, ok = lookup(kk)
        rows.append(src[ok])
        cols.append(dst[ok])
    if rows:
        r = np.concatenate(rows)
        c = np.concatenate(cols)
    else:
        r = c = np.zeros(0, np.int64)
    g = coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(n, n))
    n_comp, labels = connected_components(g, directed=False)

    # noise filter: components of size 1 with no self-edges
    sizes = np.bincount(labels, minlength=n_comp)
    has_edge = np.zeros(n, bool)
    has_edge[r] = True
    has_edge[c] = True
    noise = (sizes[labels] == 1) & ~has_edge
    labels = np.where(noise, -1, labels)
    return labels.astype(np.int32), (m, x, y, z), n_comp


def cluster_importance(labels, mips, n_clusters):
    """score = sum(16 - 2^level) over cluster points (floatyremover.h:253)."""
    w = 16.0 - np.exp2(mips.astype(np.float64))
    scores = np.zeros(n_clusters)
    valid = labels >= 0
    np.add.at(scores, labels[valid], w[valid])
    return scores


def remove_floaties(occ_linear: np.ndarray):
    """-> (cleaned occupancy (8,128,128,128) uint8, n_clusters)."""
    global last_backend
    native = _try_native(occ_linear)
    if native is not None:
        return native
    last_backend = "scipy"
    labels, (m, x, y, z), n_comp = cluster(occ_linear)
    if n_comp == 0:
        return occ_linear.astype(np.uint8), 0
    scores = cluster_importance(labels, m, n_comp)
    winner = int(np.argmax(scores))
    keep = labels == winner

    out = np.zeros_like(occ_linear, dtype=np.uint8)
    km, kx, ky, kz = m[keep], x[keep], y[keep], z[keep]
    out[km, kz, ky, kx] = 1
    # set ancestors in coarser mips (to_ngp_grid, floatyremover.h:244-249)
    cm, cx, cy, cz = km.copy(), kx.copy(), ky.copy(), kz.copy()
    while True:
        sel = cm < N_MIPS - 1
        if not sel.any():
            break
        cm = cm[sel] + 1
        cx = 32 + cx[sel] // 2
        cy = 32 + cy[sel] // 2
        cz = 32 + cz[sel] // 2
        out[cm, cz, cy, cx] = 1
    n_real = int(len(np.unique(labels[labels >= 0])))
    return out, n_real


def _try_native(occ_linear):
    global last_backend, last_native_error
    from nerf_glasses_tpu_torch.models import _native_floaty
    try:
        out = _native_floaty.remove_floaties(occ_linear)
    except (OSError, subprocess.CalledProcessError) as e:
        # no compiler, or a library built for another machine
        last_native_error = repr(e)
        return None
    last_backend, last_native_error = "native", None
    return out
