"""The network forward's kernels (ops/network_cuda.py, csrc/network.cu):
a numpy model of each kernel against its plain version, the plain
versions against the JAX package, the routing rule, the wrappers'
validation, the contract, and the kernels themselves on the card. The
fused encode + density MLP (nmr_encode_mlp) is the encode's model
composed with the tensor-core chain's, its A tile rounded to bf16 as the
kernel rounds it.

Widths: TEST_CFG (16 levels x 2, 2^15 rows, dense and hashed levels, the
dense ones of non-power-of-two size), NGPConfig.native_fast() (8 x 4,
every level a 2^15 hash table) and NGPConfig() (16 x 2, 2^19 rows), with
the MLPs 32 -> 64 -> 16 and 32 (48 with 8 latent dims) -> 64 -> 64 -> 16.

Tolerances:
- the numpy models against the plain versions: network_cuda.
  compare_with_plain's contract (the kernels' own): the encode to rtol
  1e-5 / atol 1e-6 at f32, one bf16 ulp at bf16; the MLPs and rgb to 1e-4
  x max(1, |ref|) at f32 compute, 2e-2 absolute on all but 1e-5 of the
  rows and 8e-2 on every row at bf16. The corner indices and weights the encode model computes equal
  the plain version's bit for bit (integer and float32 arithmetic in the
  same order); only the 8-corner sum and the MLP sums run in another
  order than aten's. The models are float32 numpy code that follows each
  kernel line by line, one thread's work vectorised over threads; the
  kernels' fmaf is an exactly rounded fused multiply-add (`_fma32`).
  At the bf16 compute dtype the MLP kernels run on the tensor cores
  (wgmma): `_tc_layers_model` takes each k16 step's 16 products summed
  exactly and rounded to f32 once into the f32 accumulator, the
  instruction's order; the hardware's step sum is wider than f32 and
  truncates, so the model stands for the order, held under the same
  contract, not for the last bit.
- the plain versions against JAX: tests/test_torch_network.py's bars,
  1e-5 / 1e-6 for the f32 encode, 1e-4 after an f32 MLP, 2e-2 absolute
  at bf16 (hidden activations rounded to bf16 on both sides; an f32 sum
  one ulp apart can round to the neighbouring bf16 value), and a bf16
  encode to 2 bf16 ulps (XLA and aten may order the bf16 sum apart).
- the kernels against the plain versions (marked `cuda`, skipped without
  a card; `python -m pytest tests/test_torch_network_kernels.py -m cuda`):
  compare_with_plain's contract; the fused kernel against hash_encode
  followed by mlp on the card bit for bit (the same corner sums, A tile
  and wgmma chain).
- encode_mlp_reference against the JAX package's density_raw: 1e-4 at
  the f32 compute dtype (rtol and atol, tests/test_torch_network.py's
  bar after an f32 MLP), 2e-2 at bf16.
"""

import functools

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.ops import hashgrid as jhash
from nerf_glasses_tpu.ops import network as jnet
from nerf_glasses_tpu.ops.mlp import mlp_apply as jmlp
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.ops import hashgrid as thash
from nerf_glasses_tpu_torch.ops import network_cuda as nc
from nerf_glasses_tpu_torch.ops.network import params_from_jax

torch.set_num_threads(1)

F32 = np.float32
# tests/helpers.py's TEST_CFG, made here: the card's machine cannot import
# tests.helpers, and this file's `cuda` cases run there
TEST_CFG = JCfg(log2_hashmap_size=15)
CONFIGS = {"test_cfg": TEST_CFG, "native_fast": JCfg.native_fast(),
           "ngp": JCfg()}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tcfg(jc):
    return TCfg(**{f: getattr(jc, f) for f in TCfg.__dataclass_fields__})


# ---------------------------------------------------------------------------
# Inputs, made with numpy from a seed
# ---------------------------------------------------------------------------

def _positions(jc, n=192, seed=0):
    """Uniform positions, the cube's corners and faces (0 and 1), and
    points on cell boundaries of every level (pos * scale + 0.5 an
    integer or within an ulp of one)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(F32)
    pos[:6] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 0.25],
               [0.5, 0.5, 0.5], [0.25, 0.75, 1.0]]
    scales = jhash.level_constants(jc)[0]
    k = 6
    for s in scales:
        if k + 2 > n:
            break
        cell = rng.integers(1, max(2, int(s)), 3)
        pos[k] = ((cell - 0.5) / s).astype(F32)
        pos[k + 1] = np.nextafter(pos[k], F32(2.0))
        k += 2
    return np.clip(pos, 0.0, 1.0)


def _table(jc, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (jc.n_levels, jhash.padded_table_rows(jc), jc.n_features_per_level)
    ).astype(F32) * F32(0.5)


def _mlp_weights(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * np.sqrt(2.0 / s[1])).astype(F32)
            for s in shapes]


def _dirs(n, seed=3):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    d = ((v + 1.0) / 2.0).astype(F32)
    d[:3] = [[0, 0.5, 0.5], [1, 0.5, 0.5], [0.5, 0.5, 1]]
    return d[:n]


def _params(jc, seed=2):
    d_shapes, r_shapes = jc.mlp_shapes()
    return {"density_mlp": tuple(_mlp_weights(d_shapes, seed)),
            "rgb_mlp": tuple(_mlp_weights(r_shapes, seed + 1)),
            "grid": _table(jc, seed + 2)}


# ---------------------------------------------------------------------------
# The numpy models of the kernels (csrc/network.cu), line for line
# ---------------------------------------------------------------------------

def _bf16(x):
    """__float2bfloat16_rn then back to float32 (round to nearest even)."""
    x = np.asarray(x, F32)
    b = x.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isnan(x), x, r.view(F32))


def _fma32(a, b, c):
    """fmaf(a, b, c): a * b + c rounded to float32 once. The float64
    product is exact; TwoSum gives the float64 sum's exact error, which
    decides the rounding where the sum lies on a float32 midpoint."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = np.broadcast_to(c, p.shape).astype(np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(F32)
    below = np.where(r.astype(np.float64) > s, np.nextafter(r, F32(-np.inf)), r)
    above = np.where(r.astype(np.float64) < s, np.nextafter(r, F32(np.inf)), r)
    mid = (below.astype(np.float64) + above.astype(np.float64)) / 2.0
    tie = (s == mid) & (below != above) & (e != 0.0)
    return np.where(tie, np.where(e > 0.0, above, below), r).astype(F32)


def _encode_level(table, pos, jc, lvl, bf16):
    """encode_point on level lvl for each position -> (out (N, F) float32
    holding the output dtype's values, idx (N, 8) uint32, weight (N, 8)
    float32)."""
    scales, res, sizes, dense = jhash.level_constants(jc)
    F = jc.n_features_per_level
    n = pos.shape[0]
    scale = F32(scales[lvl])
    w = [[None, None] for _ in range(3)]
    c0 = [None] * 3
    for d in range(3):
        p = (pos[:, d] * scale).astype(F32) + F32(0.5)
        g = np.floor(p)
        frac = p - g
        w[d][0] = F32(1.0) - frac
        w[d][1] = frac
        c0[d] = g.astype(np.int32).astype(np.uint32)
    r = np.uint32(res[lvl])
    r2 = np.uint32((int(res[lvl]) * int(res[lvl])) & 0xFFFFFFFF)
    size = np.uint32(sizes[lvl])
    pow2 = (int(size) & (int(size) - 1)) == 0
    acc = np.zeros((n, F), F32)
    idx_all = np.zeros((n, 8), np.uint32)
    w_all = np.zeros((n, 8), F32)
    for c in range(8):
        bx, by, bz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        wc = (w[0][bx] * w[1][by]) * w[2][bz]
        cx = c0[0] + np.uint32(bx)
        cy = c0[1] + np.uint32(by)
        cz = c0[2] + np.uint32(bz)
        with np.errstate(over="ignore"):
            if dense[lvl]:
                idx = cx + cy * r + cz * r2
            else:
                idx = cx ^ (cy * np.uint32(2654435761)) ^ (
                    cz * np.uint32(805459861))
        idx = idx & (size - np.uint32(1)) if pow2 else idx % size
        v = table[lvl][idx.astype(np.int64)]
        if bf16:
            acc = acc + _bf16(_bf16(v) * _bf16(wc)[:, None])
        else:
            acc = acc + v * wc[:, None]
        idx_all[:, c] = idx
        w_all[:, c] = wc
    return (_bf16(acc) if bf16 else acc), idx_all, w_all


def _encode_model(table, pos, jc, bf16):
    """encode_point on every (sample, level) -> (out (N, L*F) float32
    holding the output dtype's values, idx (L, N, 8) uint32, weight (L, N,
    8) float32)."""
    L, F = jc.n_levels, jc.n_features_per_level
    n = pos.shape[0]
    out = np.zeros((n, L * F), F32)
    idx_all = np.zeros((L, n, 8), np.uint32)
    w_all = np.zeros((L, n, 8), F32)
    for lvl in range(L):
        out[:, lvl * F:(lvl + 1) * F], idx_all[lvl], w_all[lvl] = (
            _encode_level(table, pos, jc, lvl, bf16))
    return out, idx_all, w_all


ENCODE_THREADS, ENCODE_TILE, ENCODE_TILE_BYTES = 256, 64, 24576


def _encode_stride(row):
    """csrc/network.cu's encode_stride: a row of whole 16-byte pieces one
    piece longer where their count is even; other rows contiguous."""
    return row if row % 16 else row + (0 if row // 16 % 2 else 16)


def _encode_tile(stride):
    t = ENCODE_TILE
    while t > 32 and t * stride > ENCODE_TILE_BYTES:
        t //= 2
    return t


def _encode_tiled_model(table, pos, jc, bf16, count=None, grid=None):
    """hash_encode_kernel's work map: blocks of `tile` samples (the
    launcher's choice), warp w of the block taking items w, w + 8, ...,
    item it the level it >> gshift and the 32 samples of group it &
    (tile / 32 - 1), a lane a sample; each lane's features into its
    sample's row of the tile in shared memory (bytes, `stride` apart);
    then the tile's rows out in 16-byte pieces (the bytes past the last
    whole piece of an unpadded tile in 2-byte pieces). With a row count
    (the kernel's in device memory) the rows below it alone, over `grid`
    blocks each taking every grid-th tile (the launcher's capped grid).
    Checks that each (sample, level) below the count is computed once,
    each of its output bytes written once and no byte of a row at or
    above it -> (N, L*F) float32 holding the output dtype's values (zero
    at and above the count)."""
    L, F = jc.n_levels, jc.n_features_per_level
    es = 2 if bf16 else 4
    n = pos.shape[0]
    live = n if count is None else max(0, min(count, n))
    row = L * F * es
    stride = _encode_stride(row)
    tile = _encode_tile(stride)
    gshift = (tile // 32).bit_length() - 1
    out = np.zeros(n * row, np.uint8)
    writes = np.zeros(n * row, np.int64)
    done = np.zeros((n, L), np.int64)
    lanes = np.arange(32)
    blocks = -(-n // tile) if grid is None else grid
    starts = [s0 for b in range(blocks)
              for s0 in range(b * tile, live, blocks * tile)]
    assert sorted(starts) == list(range(0, live, tile))
    for s0 in starts:
        rows = min(tile, live - s0)
        smem = np.zeros(tile * stride, np.uint8)
        for warp in range(ENCODE_THREADS // 32):
            for it in range(warp, L << gshift, ENCODE_THREADS // 32):
                lvl = it >> gshift
                r = ((it & ((1 << gshift) - 1)) << 5) + lanes
                r = r[r < rows]
                if r.size == 0:
                    continue
                vals, _, _ = _encode_level(table, pos[s0 + r], jc, lvl, bf16)
                bits = vals.view(np.uint32)
                data = ((bits >> 16).astype(np.uint16) if bf16 else bits
                        ).view(np.uint8).reshape(r.size, F * es)
                at = (r * stride + lvl * F * es)[:, None] + np.arange(F * es)
                smem[at] = data
                done[s0 + r, lvl] += 1
        nbytes = rows * row
        b = np.arange(0, nbytes & ~15, 16)
        src = b if stride == row else b // row * stride + b % row
        piece = np.arange(16)
        dst = s0 * row + (b[:, None] + piece)
        out[dst] = smem[src[:, None] + piece]
        np.add.at(writes, dst.ravel(), 1)
        tail = np.arange(nbytes & ~15, nbytes)
        out[s0 * row + tail] = smem[tail]
        np.add.at(writes, s0 * row + tail, 1)
    assert np.all(done[:live] == 1) and np.all(writes[:live * row] == 1)
    assert not done[live:].any() and not writes[live * row:].any()
    if bf16:
        return (out.view(np.uint16).astype(np.uint32) << 16).view(
            F32).reshape(n, L * F)
    return out.view(F32).reshape(n, L * F)


def _layers_model(a, weights, n_store):
    """The f32 chain that the register-tiled body (mlp_kernel,
    rgb_head_kernel) computes bit for bit, on the rows `a` (N, width[0]):
    each layer's sums as fmaf chains over the zero-padded input in order
    from 0; ReLU (NaN kept) between layers; the last layer's first n_store
    columns."""
    for k, w in enumerate(weights):
        n_out, n_in = w.shape
        pad = -(-n_in // 16) * 16
        wr = np.zeros((n_out, pad), F32)
        wr[:, :n_in] = w
        x = np.zeros((a.shape[0], pad), F32)
        x[:, :n_in] = a
        acc = np.zeros((a.shape[0], n_out), F32)
        for i in range(pad):
            acc = _fma32(x[:, i:i + 1], wr[None, :, i], acc)
        if k + 1 < len(weights):
            a = np.where(np.isnan(acc) | (acc > 0), acc, F32(0.0))
        else:
            return acc[:, :n_store]


RT_R, RT_C, RT_LAST_C, RT_LAST_TC, RT_LANE_TS = 4, 16, 2, 4, 8


def _row_stride(row):
    """csrc/network.cu's rt_row_stride: a staged row of `row` bytes at an
    odd number of 16-byte pieces."""
    pieces = -(-row // 16)
    return 16 * (pieces if pieces % 2 else pieces + 1)


def _staged_rows(a, x_bf16):
    """mlp_kernel's input rows through its staging area: each tile's rows
    of x copied row-major at _row_stride in 16-, 4- or 2-byte pieces (x
    taken as 16-byte aligned), then read back a 16-byte chunk at a time
    and widened to f32 (bf16 rows: the value's bits in the high half).
    Checks that each byte of x is staged once -> the rows as the row build
    writes them (a: the rows' values, bf16 ones exactly representable)."""
    n, n_in = a.shape
    es = 2 if x_bf16 else 4
    row = n_in * es
    stride = _row_stride(row)
    piece = 16 if row % 16 == 0 else 4 if row % 4 == 0 else 2
    bits = a.astype(F32).view(np.uint32)
    src = ((bits >> 16).astype(np.uint16) if x_bf16 else bits).view(
        np.uint8).reshape(n, row)
    stage = np.zeros((n, stride), np.uint8)
    copies = np.zeros((n, row), np.int64)
    per = row // piece
    e = np.arange(n * per)
    s_, o = e // per, (e % per) * piece
    for k in range(piece):
        stage[s_, o + k] = src[s_, o + k]
        np.add.at(copies, (s_, o + k), 1)
    assert np.all(copies == 1)
    pad = -(-n_in // 16) * 16
    out = np.zeros((n, pad), F32)
    chunk = 16 // es
    for i in range(0, pad, chunk):
        if i >= n_in:
            continue
        q = stage[:, es * i:es * i + 16]
        vals = (q.view(np.uint16).astype(np.uint32) << 16).view(F32) \
            if x_bf16 else q.view(F32)
        m = min(chunk, n_in - i)
        out[:, i:i + m] = vals[:, :m]
    return out


def _tiled_layers_model(a, weights, n_store, grid=3, samples=256,
                        stage=False, x_bf16=False, count=None):
    """mlp_kernel's and rgb_head_kernel's register-tiled f32 body
    (mlp_tiles) on the rows `a` (N, width[0]): `grid` blocks, each an even
    share of the samples in tiles of `samples` (256 at hidden width 64,
    128 at 128; a short tile's missing rows zero), activations k-major and
    zero-padded to pad16; with `stage` the rows come through mlp_kernel's
    staging area (_staged_rows; x_bf16: rows of bf16). A hidden layer's
    items, RT_R samples x RT_C columns of pad16(outputs), are dealt to the
    threads as the kernel deals them (a warp: RT_LANE_TS sample groups x 32
    / RT_LANE_TS column groups). The last layer, where it stores all its
    pad16 columns and its items fit the block (one a thread), the same
    way with items of RT_R samples x RT_LAST_TC columns; else a sample and
    RT_LAST_C columns a thread, the stored ones rounded up. Each output an fmaf chain over k from 0. With a row count
    (the kernel's in device memory) the blocks share the rows below it
    alone. Checks that every (sample, column) of a layer is computed by
    exactly one thread, every stored output below the count written once
    and none at or above it -> the (N, n_store) output, NaN where nothing
    was written."""
    n = a.shape[0] if count is None else max(0, min(count, a.shape[0]))
    if stage:
        a = _staged_rows(a, x_bf16)
    pad = [-(-w.shape[1] // 16) * 16 for w in weights]
    out = np.full((a.shape[0], n_store), np.nan, F32)
    writes = np.zeros((a.shape[0], n_store), np.int64)
    tiled_last = (n_store == -(-weights[-1].shape[0] // 16) * 16 and
                  samples // RT_R * (n_store // RT_LAST_TC) <= 256)
    tiles = [(s0, min(samples, n * (b + 1) // grid - s0))
             for b in range(grid)
             for s0 in range(n * b // grid, n * (b + 1) // grid, samples)]
    for s0, rows in tiles:
        act = np.zeros((pad[0], samples), F32)
        act[:a.shape[1], :rows] = a[s0:s0 + rows].T
        for k, w in enumerate(weights):
            n_out, n_in = w.shape
            last = k + 1 == len(weights)
            cols = (n_store if last and tiled_last
                    else -(-n_store // RT_LAST_C) * RT_LAST_C if last
                    else -(-n_out // 16) * 16)
            wk = np.zeros((pad[k], cols), F32)        # k-major, zero-padded
            m = min(n_out, cols)
            wk[:n_in, :m] = w[:m].T
            if last and not tiled_last:
                it = np.arange(samples * (cols // RT_LAST_C))
                samp = (it % samples)[:, None]
                col = (it // samples * RT_LAST_C)[:, None] + np.arange(
                    RT_LAST_C)[None]
            else:
                c = RT_LAST_TC if last else RT_C
                groups = cols // c
                it = np.arange(samples // RT_R * groups)
                assert it.size <= 256                 # RT_THREADS
                tj = it // RT_LANE_TS % groups
                ts = it % RT_LANE_TS + RT_LANE_TS * (it // RT_LANE_TS // groups)
                samp = ts[:, None] * RT_R + np.arange(RT_R)[None]
                col = tj[:, None] * c + np.arange(c)[None]
                # a warp's threads: RT_LANE_TS sample groups x the rest
                # column groups, each (sample group, column group) once
                for w0 in range(0, it.size, 32):
                    assert len(set(ts[w0:w0 + 32])) * len(
                        set(tj[w0:w0 + 32])) == min(32, it.size - w0)
            # each (sample, column) computed once
            cover = np.zeros((samples, cols), np.int64)
            np.add.at(cover, (samp[:, :, None], col[:, None, :]), 1)
            assert np.all(cover == 1)
            acc = np.zeros((it.size, samp.shape[1], col.shape[1]), F32)
            for kk in range(pad[k]):
                acc = _fma32(act[kk][samp][:, :, None],
                             wk[kk][col][:, None, :], acc)
            if last:
                keep = (samp[:, :, None] < rows) & (col[:, None, :] < n_store)
                si = np.broadcast_to(samp[:, :, None], acc.shape)[keep]
                ci = np.broadcast_to(col[:, None, :], acc.shape)[keep]
                out[s0 + si, ci] = acc[keep]
                np.add.at(writes, (s0 + si, ci), 1)
            else:
                nxt = np.zeros((cols, samples), F32)
                val = np.where(np.isnan(acc) | (acc > 0), acc, F32(0.0))
                val = np.where(col[:, None, :] < n_out, val, F32(0.0))
                nxt[col[:, None, :], samp[:, :, None]] = val
                act = nxt
    assert np.all(writes[:n] == 1) and not writes[n:].any()
    return out


def _tc_layers_model(a, weights, n_store):
    """mlp_kernel_bf16's / rgb_head_kernel_bf16's layer chain on the rows
    `a` (N, width[0]), already rounded to bf16: bf16 weights, each
    layer's K zero-padded to 16 and taken in k16 steps, a step's 16
    products summed exactly (float64) and rounded to f32 once, then added
    to the f32 accumulator; ReLU (NaN kept) and bf16 between layers; the
    last layer's first n_store columns in f32."""
    for k, w in enumerate(weights):
        n_out, n_in = w.shape
        pad = -(-n_in // 16) * 16
        wr = np.zeros((n_out, pad), np.float64)
        wr[:, :n_in] = _bf16(w)
        x = np.zeros((a.shape[0], pad), np.float64)
        x[:, :n_in] = a
        acc = np.zeros((a.shape[0], n_out), F32)
        with np.errstate(invalid="ignore"):
            for c in range(0, pad, 16):
                step = (x[:, c:c + 16] @ wr[:, c:c + 16].T).astype(F32)
                acc = (acc + step).astype(F32)
        if k + 1 < len(weights):
            a = _bf16(np.where(np.isnan(acc) | (acc > 0), acc, F32(0.0)))
        else:
            return acc[:, :n_store]


def _mlp_model(x, weights, bf16, x_bf16=False):
    """nmr_mlp: at bf16 the input row rounded to bf16 and the tensor-core
    chain; at f32 the register-tiled body (its rows staged, x_bf16: rows
    of bf16), bit for bit the f32 chain."""
    if bf16:
        return _tc_layers_model(_bf16(x), weights, weights[-1].shape[0])
    hid = max(w.shape[0] for w in weights)
    return _tiled_layers_model(x, weights, weights[-1].shape[0],
                               samples=256 if hid <= 64 else 128,
                               stage=True, x_bf16=x_bf16)


def _sh_model(d, degree):
    """sh_encode of csrc/network.cu: the plain version's float32 ops in
    its order, Python constants rounded to float32, padding ONE."""
    x = d[:, 0] * F32(2.0) - F32(1.0)
    y = d[:, 1] * F32(2.0) - F32(1.0)
    z = d[:, 2] * F32(2.0) - F32(1.0)
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    sh = np.ones((d.shape[0], 16), F32)
    sh[:, 0] = F32(0.28209479177387814)
    if degree >= 2:
        c1 = F32(0.48860251190291987)
        sh[:, 1] = y * -c1
        sh[:, 2] = z * c1
        sh[:, 3] = x * -c1
    if degree >= 3:
        c4 = F32(1.0925484305920792)
        sh[:, 4] = xy * c4
        sh[:, 5] = yz * -c4
        sh[:, 6] = z2 * F32(0.94617469575755997) - F32(0.31539156525251999)
        sh[:, 7] = xz * -c4
        c8 = F32(0.54627421529603959)
        sh[:, 8] = x2 * c8 - y2 * c8
    if degree >= 4:
        c9, c11 = F32(0.59004358992664352), F32(0.45704579946446572)
        one_5z2 = F32(1.0) - z2 * F32(5.0)
        sh[:, 9] = (y * c9) * (x2 * F32(-3.0) + y2)
        sh[:, 10] = (xy * F32(2.8906114426405538)) * z
        sh[:, 11] = (y * c11) * one_5z2
        sh[:, 12] = (z * F32(0.3731763325901154)) * (z2 * F32(5.0) - F32(3.0))
        sh[:, 13] = (x * c11) * one_5z2
        sh[:, 14] = (z * F32(1.4453057213202769)) * (x2 - y2)
        sh[:, 15] = (x * c9) * (-x2 + y2 * F32(3.0))
    return sh


def _rgb_row(feat, dirs, jc, extra=None):
    """The rgb head's input row [feat, SH(dir), codes, zeros]."""
    n = feat.shape[0]
    row = np.zeros((n, jc.rgb_in_width), F32)
    nf = feat.shape[1]
    row[:, :nf] = feat
    row[:, nf:nf + 16] = _sh_model(dirs, jc.sh_degree)
    if extra is not None:
        row[:, nf + 16:nf + 16 + extra.shape[-1]] = np.broadcast_to(
            extra, (n, extra.shape[-1]))
    return row


def _rgb_head_model(feat, dirs, weights, jc, bf16, extra=None):
    """nmr_rgb_head: the row [feat, SH(dir), codes, zeros], then as
    _mlp_model (at bf16 rounded, the tensor-core chain; at f32 the
    register-tiled body, bit for bit the f32 chain), columns 0-2."""
    row = _rgb_row(feat, dirs, jc, extra)
    if bf16:
        return _tc_layers_model(_bf16(row), weights, 3)
    hid = max(w.shape[0] for w in weights)
    return _tiled_layers_model(row, weights, 3,
                               samples=256 if hid <= 64 else 128)


def _encode_mlp_model(table, pos, jc, weights, bf16_encode):
    """nmr_encode_mlp: the encode kernel's per-level corner sums
    (_encode_model), the A tile's row rounded to bf16 (the f32 sum once,
    or the bf16 encode's value as it is), then the tensor-core chain."""
    enc, _, _ = _encode_model(table, pos, jc, bf16_encode)
    return _tc_layers_model(_bf16(enc), weights, weights[-1].shape[0])


def _assert_contract(kind, model, plain, dtype):
    r = nc.compare_with_plain(kind, torch.as_tensor(model), plain, dtype)
    assert r["ok"], r
    return r


# ---------------------------------------------------------------------------
# (a) The numpy models against the plain versions
# ---------------------------------------------------------------------------

def test_bf16_and_fma_models_round_as_the_card():
    """_bf16 is torch's round-to-nearest-even bf16; _fma32 rounds once."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
         ).astype(F32)
    x[:4] = [0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8]   # ties
    want = torch.as_tensor(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(_bf16(x), want)
    a = np.array([1.0 + 2 ** -12], F32)
    b = np.array([1.0 + 2 ** -12], F32)
    c = np.array([-1.0], F32)
    # exact: 2^-11 + 2^-24; two roundings would drop the 2^-24
    assert _fma32(a, b, c)[0] == F32(2 ** -11 + 2 ** -24)
    # a * a = 1 + 2^-11 + 2^-24 lies on a float32 midpoint; a tiny c
    # decides the side, where a float64 sum would round onto the midpoint
    tiny = np.array([2.0 ** -60], F32)
    assert _fma32(a, b, tiny)[0] == F32(1 + 2 ** -11 + 2 ** -23)
    assert _fma32(a, b, -tiny)[0] == F32(1 + 2 ** -11)
    assert _fma32(a, b, np.zeros(1, F32))[0] == F32(1 + 2 ** -11)   # even


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_model_matches_plain(name, dtype):
    jc = CONFIGS[name]
    tc = _tcfg(jc)
    table = _table(jc)
    pos = _positions(jc)
    bf16 = dtype == "bfloat16"
    out, idx, wts = _encode_model(table, pos, jc, bf16)
    tpos = torch.as_tensor(pos)
    plain = nc.hash_encode_reference(torch.as_tensor(table), tpos, tc,
                                     DTYPES[dtype])
    assert plain.dtype == DTYPES[dtype] and plain.shape == out.shape
    _assert_contract("encode", out, plain, DTYPES[dtype])
    # the kernel's work map gives the same rows
    assert np.array_equal(_encode_tiled_model(table, pos, jc, bf16).view(
        np.uint32), out.view(np.uint32))
    scales, res, sizes, dense = thash.level_constants(tc)
    if name == "test_cfg":
        assert dense.any() and (~dense).any()
        assert any(int(s) & (int(s) - 1) for s in sizes[dense])
    for lvl in range(jc.n_levels):
        ti, tw = thash.corner_indices_and_weights(
            tpos, float(scales[lvl]), int(res[lvl]), int(sizes[lvl]),
            bool(dense[lvl]))
        np.testing.assert_array_equal(idx[lvl].astype(np.int64), ti.numpy())
        np.testing.assert_array_equal(wts[lvl], tw.numpy())


# (levels, features) of the encode tiling's cases: L = 8 and 16 at F = 2
# and 4; F = 8 (f32 rows of 512 bytes: 32-sample tiles) and 5 levels x 1
# (rows of 20 and 10 bytes: an unpadded tile, a bf16 tail in 2-byte stores)
TILED_LF = {"l8f2": (8, 2), "l8f4": (8, 4), "l16f2": (16, 2), "l16f4": (16, 4),
            "l16f8": (16, 8), "l5f1": (5, 1)}


@functools.lru_cache(maxsize=None)
def _lf_case(lf):
    L, F = TILED_LF[lf]
    jc = JCfg(n_levels=L, n_features_per_level=F, log2_hashmap_size=15)
    return jc, _table(jc, seed=L + F)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 300, "count", "count0"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lf", list(TILED_LF))
def test_encode_tiling_is_the_encode_bit_for_bit(lf, dtype, n):
    """The standalone encode's work map (_encode_tiled_model: blocks of
    whole samples, a warp 32 samples on one level, each (sample, level)
    computed once, the rows out through the shared tile in 16-byte pieces,
    each byte once) on tile tails of 0, 1, 31, 33 and 300 samples, at L =
    8 and 16 and F = 2, 4 and 8 (rows of 32-512 bytes, padded, in tiles of
    64 and 32 samples) and at 5 levels x 1 (unpadded rows): bit for bit
    the encode's model, and the plain version under the encode
    contract. "count" and "count0": 300 rows under a row count of 161 and
    of 0 in device memory over a grid of 2 blocks (the launcher's cap),
    each taking every second tile: the rows below the count are the
    encode's model on them bit for bit, no row at or above it is
    written."""
    jc, table = _lf_case(lf)
    count = {"count": 161, "count0": 0}.get(n)
    if count is not None:
        pos = _positions(jc, n=300, seed=7)
        full = _encode_tiled_model(table, pos, jc, dtype == "bfloat16",
                                   count=count, grid=2)
        assert not full[count:].any()
        pos, n = pos[:count], count
        got = full[:count]
    else:
        pos = _positions(jc, n=max(n, 192), seed=n)[:n]
        got = _encode_tiled_model(table, pos, jc, dtype == "bfloat16")
    bf16 = dtype == "bfloat16"
    want, _, _ = _encode_model(table, pos, jc, bf16)
    assert got.shape == (n, jc.n_pos_features)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    plain = nc.hash_encode_reference(torch.as_tensor(table),
                                     torch.as_tensor(pos), _tcfg(jc),
                                     DTYPES[dtype])
    _assert_contract("encode", got, plain, DTYPES[dtype])


@pytest.mark.parametrize("n", [0, 1])
def test_encode_model_edge_counts(n):
    jc = TEST_CFG
    table = _table(jc)
    pos = _positions(jc)[:n]
    for dtype in DTYPES.values():
        out, _, _ = _encode_model(table, pos, jc, dtype == torch.bfloat16)
        plain = nc.hash_encode(torch.as_tensor(table), torch.as_tensor(pos),
                               _tcfg(jc), dtype)
        assert plain.shape == (n, jc.n_pos_features)
        _assert_contract("encode", out, plain, dtype)


@pytest.mark.parametrize("n", [0, 1, 300])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_model_matches_plain(dtype, n):
    jc = JCfg.native_fast()
    weights = _mlp_weights(jc.mlp_shapes()[0], seed=4)
    x = np.random.default_rng(5).standard_normal((n, 32)).astype(F32)
    x[:, :2] *= 50.0                 # large hidden sums on some rows
    bf16 = dtype == "bfloat16"
    tw = [torch.as_tensor(w) for w in weights]
    for xin in (x, _bf16(x)):        # f32 rows, and bf16 rows as the
        tx = torch.as_tensor(xin)    # bf16 encode hands them over
        if xin is not x:
            tx = tx.to(torch.bfloat16)
        plain = nc.mlp_reference(tx, tw, DTYPES[dtype])
        assert plain.shape == (n, 16) and plain.dtype == torch.float32
        _assert_contract("mlp", _mlp_model(xin, weights, bf16,
                                           x_bf16=xin is not x), plain,
                         DTYPES[dtype])


def test_mlp_model_pads_odd_widths():
    """Widths that are not multiples of 16 (a 4-level x 2 encode, a
    hidden width of 24) go through the zero-padded chunks unchanged."""
    rng = np.random.default_rng(6)
    weights = [rng.standard_normal(s).astype(F32) * F32(0.3)
               for s in ((24, 8), (24, 24), (5, 24))]
    x = rng.standard_normal((64, 8)).astype(F32)
    plain = nc.mlp_reference(torch.as_tensor(x),
                             [torch.as_tensor(w) for w in weights],
                             torch.float32)
    _assert_contract("mlp", _mlp_model(x, weights, False), plain,
                     torch.float32)


def _rgb_case(degree=4, E=0):
    jc = JCfg(sh_degree=degree, n_extra_learnable_dims=E,
              log2_hashmap_size=15)
    return jc, _mlp_weights(jc.mlp_shapes()[1], seed=7 + E + degree)


@pytest.mark.parametrize("extra", ["none", "codes", "rows"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rgb_head_model_matches_plain(dtype, extra):
    """E = 0, and E = 8 latent codes as (E,) and as (N, E); omitted codes
    with E = 8 are zeros."""
    E = 0 if extra == "none" else 8
    jc, weights = _rgb_case(E=E)
    n = 257
    rng = np.random.default_rng(8)
    feat = (rng.standard_normal((n, 16)) * 2.0).astype(F32)
    dirs = _dirs(n)
    codes = {"none": None,
             "codes": rng.standard_normal(E).astype(F32),
             "rows": rng.standard_normal((n, E)).astype(F32)}[extra]
    bf16 = dtype == "bfloat16"
    tw = [torch.as_tensor(w) for w in weights]
    plain = nc.rgb_head_reference(
        torch.as_tensor(feat), torch.as_tensor(dirs), tw, _tcfg(jc),
        DTYPES[dtype], None if codes is None else torch.as_tensor(codes))
    model = _rgb_head_model(feat, dirs, weights, jc, bf16, codes)
    assert plain.shape == (n, 3)
    _assert_contract("rgb", model, plain, DTYPES[dtype])
    if E:
        no_codes = nc.rgb_head_reference(torch.as_tensor(feat),
                                         torch.as_tensor(dirs), tw, _tcfg(jc),
                                         DTYPES[dtype])
        _assert_contract("rgb", _rgb_head_model(feat, dirs, weights, jc, bf16),
                         no_codes, DTYPES[dtype])


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_rgb_head_model_low_sh_degree(degree):
    """SH below degree 4: the padding features are ONE."""
    jc, weights = _rgb_case(degree=degree)
    feat = np.random.default_rng(10).standard_normal((65, 16)).astype(F32)
    dirs = _dirs(65)
    sh = _sh_model(dirs, degree)
    assert (sh[:, degree * degree:] == 1.0).all()
    plain = nc.rgb_head_reference(torch.as_tensor(feat), torch.as_tensor(dirs),
                                  [torch.as_tensor(w) for w in weights],
                                  _tcfg(jc), torch.float32)
    _assert_contract("rgb", _rgb_head_model(feat, dirs, weights, jc, False),
                     plain, torch.float32)


def test_sh_model_is_the_plain_sh_bit_for_bit():
    from nerf_glasses_tpu_torch.ops.sh import sh_encode
    dirs = _dirs(512)
    for degree in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            _sh_model(dirs, degree),
            sh_encode(torch.as_tensor(dirs), degree, 16).numpy())


@pytest.mark.parametrize("n", [0, 1])
def test_rgb_head_model_edge_counts(n):
    jc, weights = _rgb_case(E=8)
    feat = np.ones((n, 16), F32)
    dirs = _dirs(3)[:n]
    codes = np.arange(8, dtype=F32)
    plain = nc.rgb_head(torch.as_tensor(feat), torch.as_tensor(dirs),
                        [torch.as_tensor(w) for w in weights], _tcfg(jc),
                        torch.bfloat16, torch.as_tensor(codes))
    assert plain.shape == (n, 3)
    _assert_contract("rgb", _rgb_head_model(feat, dirs, weights, jc, True,
                                            codes), plain, torch.bfloat16)


@pytest.mark.parametrize("n", [1, 63, 300, "tile+44", "count", "count0"])
@pytest.mark.parametrize("hid", [64, 128])
@pytest.mark.parametrize("kind", ["rgb32", "rgb48", "mlp", "odd", "mlp_bf16",
                                  "mlp32", "mlp64"])
def test_tiled_body_is_the_f32_chain_bit_for_bit(kind, hid, n):
    """The register-tiled f32 body's work map (_tiled_layers_model: which
    thread computes which sample and column, each once) on 1, 63 and 300
    samples over three blocks, and on one block's whole tile and a tail of
    44 ("tile+44"): bit for bit the fmaf chains (_layers_model), and the
    plain version under the f32 contract. Kinds: the rgb head at E = 0 and
    8 (its last layer's 3 stored columns); a density MLP (mlp_kernel's
    shape: its rows staged, all 16 columns of the last layer stored, so
    register-tiled) with f32 rows and with bf16 rows ("mlp_bf16", widened
    to f32 in the row build); density MLPs whose last layer stores 32 and
    64 columns ("mlp32", "mlp64": tiled only where its items fit the
    block, 32 columns at hidden width 128, else a sample a thread); and
    hidden widths and a stored width that
    are not multiples of RT_C or RT_LAST_C (its rows staged too). "count"
    and "count0": 300 rows under a row count of 117 and of 0 in device
    memory, the grid sized for the 300: the rows below the count bit for
    bit the chain, none at or above it written."""
    samples = 256 if hid <= 64 else 128
    count = {"count": 117, "count0": 0}.get(n)
    grid, n = ((1, samples + 44) if n == "tile+44" else
               (3, 300) if count is not None else (3, n))
    jc, weights = _tc_case("mlp" if kind in ("odd", "mlp_bf16") else kind,
                           hid)
    x, feat, dirs, codes = _tc_inputs(jc, n, seed=hid + n + 1)
    if kind == "odd":
        rng = np.random.default_rng(hid)
        weights = [rng.standard_normal(sh).astype(F32) * F32(0.3)
                   for sh in ((hid - 4, 32), (hid - 12, hid - 4),
                              (5, hid - 12))]
    x_bf16 = kind == "mlp_bf16"
    if x_bf16:
        x = _bf16(x)
    if kind.startswith("rgb"):
        rows = _rgb_row(feat, dirs, jc, codes if kind == "rgb48" else None)
        n_store = 3
    else:
        rows, n_store = x, weights[-1].shape[0]
    got = _tiled_layers_model(rows, weights, n_store, grid=grid,
                              samples=samples,
                              stage=not kind.startswith("rgb"), x_bf16=x_bf16,
                              count=count)
    if count is not None:
        assert np.isnan(got[count:]).all()
        got, n = got[:count], count
        rows, x, feat, dirs, codes = (v[:count] for v in (rows, x, feat, dirs,
                                                          codes))
    want = _layers_model(rows, weights, n_store)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    tw = [torch.as_tensor(w) for w in weights]
    if kind.startswith("rgb"):
        plain = nc.rgb_head_reference(
            torch.as_tensor(feat), torch.as_tensor(dirs), tw, _tcfg(jc),
            torch.float32,
            torch.as_tensor(codes) if kind == "rgb48" else None)
        _assert_contract("rgb", got, plain, torch.float32)
    else:
        tx = torch.as_tensor(x)
        _assert_contract("mlp", got, nc.mlp_reference(
            tx.to(torch.bfloat16) if x_bf16 else tx, tw, torch.float32),
            torch.float32)


def _tc_case(kind, hid):
    """A density MLP (kind "mlp", 32 -> hid -> 16; "mlp32" and "mlp64":
    -> 32 or 64) or an rgb head of input width 32 ("rgb32") or 48 (8
    latent dims, "rgb48"; hid -> hid -> 16)."""
    E = 8 if kind == "rgb48" else 0
    out = int(kind[3:]) if kind[3:].isdigit() else 16
    jc = JCfg(n_extra_learnable_dims=E, log2_hashmap_size=15,
              density_neurons=hid, rgb_neurons=hid, density_out=out)
    d_shapes, r_shapes = jc.mlp_shapes()
    return jc, _mlp_weights(d_shapes if kind.startswith("mlp") else r_shapes,
                            seed=20 + hid + E + (out if out != 16 else 0))


def _tc_inputs(jc, n, seed, scale=50.0):
    """Density-MLP rows (n, 32), two columns `scale` times the rest (50:
    hidden sums up to ~100 on some rows), features (n, 16), directions
    and per-row codes (n, E), made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, jc.n_pos_features)).astype(F32)
    x[:, :2] *= scale
    feat = (rng.standard_normal((n, 16)) * 2.0).astype(F32)
    codes = rng.standard_normal((n, jc.n_extra_learnable_dims)).astype(F32)
    return x, feat, _dirs(max(n, 3), seed)[:n], codes


def _hold_nan_rows(kind, got, want, dtype, nan_rows):
    """Rows `nan_rows` NaN in every column on both sides; the others under
    compare_with_plain's contract."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert bool(torch.isnan(got[nan_rows]).all())
    assert bool(torch.isnan(want[nan_rows]).all())
    keep = torch.ones(got.shape[0], dtype=torch.bool)
    keep[nan_rows] = False
    r = nc.compare_with_plain(kind, got[keep.to(got.device)],
                              want[keep.to(want.device)], dtype)
    assert r["ok"], r
    return r


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 300])
@pytest.mark.parametrize("hid", [64, 128])
@pytest.mark.parametrize("kind", ["mlp", "rgb32", "rgb48"])
def test_tensor_core_model_matches_plain(kind, hid, n):
    """The wgmma chain's k16-step sums against aten's f32 product of the
    rounded operands, at both hidden widths, both rgb input widths, and
    row counts around the 64-row tile."""
    jc, weights = _tc_case(kind, hid)
    x, feat, dirs, codes = _tc_inputs(jc, n, seed=hid + n)
    tw = [torch.as_tensor(w) for w in weights]
    if kind == "mlp":
        for xin in (x, _bf16(x)):        # an f32 and a bf16 encode
            tx = torch.as_tensor(xin)
            if xin is not x:
                tx = tx.to(torch.bfloat16)
            plain = nc.mlp_reference(tx, tw, torch.bfloat16)
            assert plain.shape == (n, 16)
            _assert_contract("mlp", _mlp_model(xin, weights, True), plain,
                             torch.bfloat16)
        return
    extra = codes if kind == "rgb48" else None
    plain = nc.rgb_head_reference(
        torch.as_tensor(feat), torch.as_tensor(dirs), tw, _tcfg(jc),
        torch.bfloat16, None if extra is None else torch.as_tensor(extra))
    assert plain.shape == (n, 3)
    model = _rgb_head_model(feat, dirs, weights, jc, True, extra)
    _assert_contract("rgb", model, plain, torch.bfloat16)


@pytest.mark.parametrize("hid", [64, 128])
def test_tensor_core_model_keeps_nan(hid):
    """A NaN input stays NaN through ReLU: its row is NaN in every column,
    as in the plain version; the other rows keep the contract."""
    for kind in ("mlp", "rgb48"):
        jc, weights = _tc_case(kind, hid)
        x, feat, dirs, codes = _tc_inputs(jc, 70, seed=5)
        x[3, 7] = np.nan
        feat[3, 5] = np.nan
        tw = [torch.as_tensor(w) for w in weights]
        if kind == "mlp":
            model = _mlp_model(x, weights, True)
            plain = nc.mlp_reference(torch.as_tensor(x), tw, torch.bfloat16)
        else:
            model = _rgb_head_model(feat, dirs, weights, jc, True, codes)
            plain = nc.rgb_head_reference(
                torch.as_tensor(feat), torch.as_tensor(dirs), tw, _tcfg(jc),
                torch.bfloat16, torch.as_tensor(codes))
        _hold_nan_rows(kind[:3], model, plain, torch.bfloat16, [3])


@pytest.mark.parametrize("hid", [64, 128])
@pytest.mark.parametrize("kind", ["mlp", "rgb48"])
def test_tensor_core_model_within_one_bf16_step(kind, hid):
    """At inputs 50x and 200x the encode's scale (hidden sums in the
    hundreds) the wgmma chain's model stays within bf16_step_bound of the
    plain version: a sum rounded apart moves an output by at most one
    bf16 step of each hidden activation carried through |W|."""
    jc, weights = _tc_case(kind, hid)
    tw = [torch.as_tensor(w) for w in weights]
    for scale in (50.0, 200.0):
        x, feat, dirs, codes = _tc_inputs(jc, 2000, seed=hid, scale=scale)
        if kind == "mlp":
            model = torch.as_tensor(_mlp_model(x, weights, True))
            plain = nc.mlp_reference(torch.as_tensor(x), tw, torch.bfloat16)
            bound = nc.bf16_step_bound(torch.as_tensor(x), tw)
        else:
            feat *= scale / 2.0
            t = [torch.as_tensor(a) for a in (feat, dirs, codes)]
            model = torch.as_tensor(
                _rgb_head_model(feat, dirs, weights, jc, True, codes))
            plain = nc.rgb_head_reference(t[0], t[1], tw, _tcfg(jc),
                                          torch.bfloat16, t[2])
            bound = nc.bf16_step_bound(
                nc.rgb_row(t[0], t[1], _tcfg(jc), t[2]), tw)[:, :3]
        assert model.shape == plain.shape == bound.shape
        assert bool(((model - plain).abs() <= bound).all())


# ---------------------------------------------------------------------------
# (b) The plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_versions_match_jax(name):
    jc = CONFIGS[name]
    tc = _tcfg(jc)
    params = _params(jc)
    net = params_from_jax(params, tc)
    jp = {"density_mlp": tuple(jnp.asarray(w) for w in params["density_mlp"]),
          "rgb_mlp": tuple(jnp.asarray(w) for w in params["rgb_mlp"]),
          "grid": jnp.asarray(params["grid"])}
    pos = _positions(jc, n=160, seed=11)
    dirs = _dirs(160, seed=12)
    tpos, tdirs = torch.as_tensor(pos), torch.as_tensor(dirs)
    for enc in ("float32", "bfloat16"):
        want = np.asarray(jhash.hash_encode(jp["grid"], jnp.asarray(pos), jc,
                                            compute_dtype=getattr(jnp, enc)),
                          np.float32)
        got = nc.hash_encode_reference(net.grid, tpos, tc, DTYPES[enc])
        if enc == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        else:
            g = got.float()
            assert bool((g - torch.as_tensor(want)).abs().le(
                2 * nc.bf16_ulp(g.abs().maximum(torch.as_tensor(want).abs()))
            ).all())
    enc = np.array(jhash.hash_encode(jp["grid"], jnp.asarray(pos), jc))
    for cd in ("float32", "bfloat16"):
        tol = 1e-4 if cd == "float32" else 2e-2
        want = np.asarray(jmlp(jnp.asarray(enc), jp["density_mlp"],
                               compute_dtype=getattr(jnp, cd)))
        got = nc.mlp_reference(torch.as_tensor(enc), net.density_mlp,
                               DTYPES[cd])
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
        feat = want[:, :16]
        want_rgb = np.asarray(jnet.rgb_from_features(
            jp, jnp.asarray(feat), jnp.asarray(dirs), jc,
            compute_dtype=getattr(jnp, cd)))
        got_rgb = nc.rgb_head_reference(torch.as_tensor(feat), tdirs,
                                        net.rgb_mlp, tc, DTYPES[cd])
        np.testing.assert_allclose(got_rgb.numpy(), want_rgb, atol=tol,
                                   rtol=tol)
        rgb_j, sig_j = jnet.apply_network(jp, jnp.asarray(pos),
                                          jnp.asarray(dirs), jc,
                                          compute_dtype=getattr(jnp, cd))
        rgb_t, sig_t = net(tpos, tdirs, compute_dtype=DTYPES[cd])
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=tol,
                                   rtol=tol)


def test_plain_rgb_head_matches_jax_with_latent_codes():
    jc, _ = _rgb_case(E=8)
    tc = _tcfg(jc)
    params = _params(jc, seed=13)
    net = params_from_jax(params, tc)
    jp = {k: (tuple(jnp.asarray(w) for w in v) if isinstance(v, tuple)
              else jnp.asarray(v)) for k, v in params.items()}
    rng = np.random.default_rng(14)
    feat = rng.standard_normal((96, 16)).astype(F32)
    dirs = _dirs(96, seed=15)
    for codes in (rng.standard_normal(8).astype(F32),
                  rng.standard_normal((96, 8)).astype(F32)):
        want = np.asarray(jnet.rgb_from_features(
            jp, jnp.asarray(feat), jnp.asarray(dirs), jc,
            compute_dtype=jnp.float32, extra=jnp.asarray(codes)))
        got = nc.rgb_head_reference(torch.as_tensor(feat),
                                    torch.as_tensor(dirs), net.rgb_mlp, tc,
                                    torch.float32, torch.as_tensor(codes))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# (c) The routing rule, the wrappers' validation, the contract
# ---------------------------------------------------------------------------

def _net(jc=TEST_CFG):
    return params_from_jax(_params(jc), _tcfg(jc))


def test_cpu_tensors_take_the_plain_versions():
    net = _net()
    pos = torch.as_tensor(_positions(TEST_CFG, n=64))
    dirs = torch.as_tensor(_dirs(64))
    before, plain_before = dict(nc.launches), dict(nc.plain_on_card)
    rgb, sig = net(pos, dirs)
    d = nc.mlp_reference(nc.hash_encode_reference(net.grid, pos, net.config),
                         net.density_mlp)
    assert torch.equal(sig, d[:, 0])
    assert torch.equal(rgb, nc.rgb_head_reference(d, dirs, net.rgb_mlp,
                                                  net.config))
    assert nc.launches == before and nc.plain_on_card == plain_before


def test_routing_rule():
    card = torch.device("cuda")        # a device object needs no card
    t = types.SimpleNamespace(device=card, requires_grad=False)
    g = types.SimpleNamespace(device=card, requires_grad=True)
    cpu = torch.zeros(1, requires_grad=True)
    before = dict(nc.plain_on_card)
    assert nc.takes_kernel("mlp", t, t)
    assert nc.takes_kernel("mlp", t, None)
    assert not nc.takes_kernel("mlp", t, g)          # needs a gradient
    assert nc.plain_on_card["mlp"] == before["mlp"] + 1
    with torch.no_grad():
        assert nc.takes_kernel("mlp", t, g)          # grad mode off
    assert not nc.takes_kernel("hash_encode", cpu, t)
    assert nc.plain_on_card["hash_encode"] == before["hash_encode"]


def test_kernel_route_plumbing_on_cpu(monkeypatch):
    """With the rule forced to the kernels, NerfNetwork hands the wrappers
    what they take (on CPU tensors they run the plain versions): the same
    outputs, latent codes included. At the bf16 compute dtype the density
    half asks for the fused encode_mlp, at f32 for hash_encode and mlp."""
    jc, _ = _rgb_case(E=8)
    net = _net(jc)
    pos = torch.as_tensor(_positions(jc, n=48))
    dirs = torch.as_tensor(_dirs(48)).T.contiguous().T      # strided
    codes = torch.arange(8, dtype=torch.float32) / 8.0
    want = {cd: net(pos, dirs, compute_dtype=cd, extra=codes)
            for cd in DTYPES.values()}
    seen = []
    monkeypatch.setattr(nc, "takes_kernel",
                        lambda name, *t: seen.append(name) or True)
    for cd, names in ((torch.bfloat16, ["encode_mlp", "rgb_head"]),
                      (torch.float32, ["hash_encode", "mlp", "rgb_head"])):
        seen.clear()
        got = net(pos, dirs, compute_dtype=cd, extra=codes)
        assert seen == names
        for a, b in zip(got, want[cd]):
            assert torch.equal(a, b)
        feat = net.density_raw(pos, cd)
        assert torch.equal(net.rgb_from_features(feat, dirs, cd, extra=codes),
                           got[0])


def test_grad_needing_call_keeps_autograd():
    net = _net()
    net.requires_grad_(True)
    pos = torch.as_tensor(_positions(TEST_CFG, n=32))
    dirs = torch.as_tensor(_dirs(32))
    rgb, sig = net(pos, dirs)
    assert rgb.requires_grad and sig.requires_grad
    (rgb.sum() + sig.sum()).backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in (net.grid, *net.density_mlp, *net.rgb_mlp))
    with torch.no_grad():
        rgb2, _ = net(pos, dirs)
    assert not rgb2.requires_grad and torch.equal(rgb2, rgb.detach())


def test_wrappers_reject_what_the_kernels_do_not_take():
    tc = _tcfg(TEST_CFG)
    net = _net()
    pos = torch.as_tensor(_positions(TEST_CFG, n=16))
    grid = net.grid.detach()
    bad_encode = [
        (grid, pos.double(), tc),                        # dtype
        (grid, pos[:, :2], tc),                          # shape
        (grid, pos.T.contiguous().T, tc),                # not contiguous
        (grid[:, :100], pos, tc),                        # rows < hashmap
        (grid[:8], pos, tc),                             # levels
        (grid, pos.to("meta"), tc),                      # device
        (grid.to("meta"), pos, tc),                      # table elsewhere
        (torch.zeros((40, 8, 2)), pos,
         TCfg(n_levels=40, log2_hashmap_size=3)),        # > 32 levels
        (torch.zeros((2, 64, 3)), pos,
         TCfg(n_levels=2, n_features_per_level=3, log2_hashmap_size=6)),
    ]
    for args in bad_encode:
        with pytest.raises(ValueError):
            nc.hash_encode(*args)
    with pytest.raises(ValueError):
        nc.hash_encode(grid, pos, tc, torch.float16)     # encode dtype
    x = torch.zeros((16, 32))
    ws = [w.detach() for w in net.density_mlp]
    for bad_x, bad_ws, cd in (
            (x.double(), ws, torch.bfloat16),
            (x[:, :31], ws, torch.bfloat16),             # chain
            (x, ws[::-1], torch.bfloat16),
            (x, [ws[0].T.contiguous().T, ws[1]], torch.bfloat16),
            (x, [torch.zeros((200, 32)), torch.zeros((16, 200))],
             torch.bfloat16),                            # hidden > 128
            (x, ws * 5, torch.bfloat16),                 # > 8 layers
            (x, ws, torch.float16)):                     # compute dtype
        with pytest.raises(ValueError):
            nc.mlp(bad_x, bad_ws, cd)
    feat = torch.zeros((16, 16))
    dirs = torch.as_tensor(_dirs(16))
    rw = [w.detach() for w in net.rgb_mlp]
    jc8, w8 = _rgb_case(E=8)
    tw8 = [torch.as_tensor(w) for w in w8]
    for args in (
            (feat, dirs[:, :2], rw, tc),                 # dir shape
            (feat, dirs[:8], rw, tc),                    # dir rows
            (feat.double(), dirs, rw, tc),
            (torch.zeros((16, 40)), dirs, rw, tc),       # row too wide
            (feat, dirs, rw, TCfg(sh_degree=5, log2_hashmap_size=15)),
            (feat, dirs, tw8, _tcfg(jc8), torch.float32, torch.zeros(7)),
            (feat, dirs, tw8, _tcfg(jc8), torch.float32,
             torch.zeros((5, 8)))):                      # code rows
        with pytest.raises(ValueError):
            nc.rgb_head(*args)


# the count cases of the wrappers: rows, and the row counts held in device
# memory (0, some, all, more than the rows: clamped to them)
COUNT_ROWS = 97
COUNTS = (0, 41, COUNT_ROWS, COUNT_ROWS + 5)
COUNT_CALLS = ("hash_encode", "hash_encode_bf16", "mlp", "mlp_bf16",
               "encode_mlp", "rgb_head", "rgb_head_bf16", "rgb_head_codes")


def _count_call(name, device):
    """A wrapper and its arguments on COUNT_ROWS rows -> (call(rows, **kw)
    taking the first `rows` rows of each per-row input, the output's
    width and dtype)."""
    jc, w8 = _rgb_case(E=8)
    net = params_from_jax(_params(TEST_CFG), _tcfg(TEST_CFG), device=device)
    tc = net.config
    pos = torch.as_tensor(_positions(TEST_CFG, n=COUNT_ROWS), device=device)
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.standard_normal((COUNT_ROWS, 32)).astype(F32),
                        device=device)
    feat = torch.as_tensor((rng.standard_normal((COUNT_ROWS, 16)) * 2.0
                            ).astype(F32), device=device)
    dirs = torch.as_tensor(_dirs(COUNT_ROWS), device=device)
    codes = torch.arange(8, dtype=torch.float32, device=device) / 8.0
    tw8 = [torch.as_tensor(w, device=device) for w in w8]
    cd = torch.bfloat16 if name.endswith("bf16") else torch.float32
    L = tc.n_pos_features
    calls = {
        "hash_encode": (lambda r, **kw: nc.hash_encode(
            net.grid, pos[:r], tc, cd, **kw), L, cd),
        "mlp": (lambda r, **kw: nc.mlp(x[:r], net.density_mlp, cd, **kw),
                16, torch.float32),
        "encode_mlp": (lambda r, **kw: nc.encode_mlp(
            net.grid, pos[:r], net.density_mlp, tc, **kw), 16, torch.float32),
        "rgb_head": (lambda r, **kw: nc.rgb_head(
            feat[:r], dirs[:r], net.rgb_mlp, tc, cd, **kw), 3, torch.float32),
        "rgb_head_codes": (lambda r, **kw: nc.rgb_head(
            feat[:r], dirs[:r], tw8, _tcfg(jc), torch.bfloat16, codes, **kw),
            3, torch.float32)}
    return calls[name.replace("_bf16", "")]


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("name", COUNT_CALLS)
def test_wrappers_take_a_row_count(name, count):
    """A wrapper given a row count (one int32 in device memory) and an
    output: the rows below the count bit for bit the call without one on
    those rows, the rows at and above it as they were (a sentinel), the
    output returned is the one given; with no output one is made. On the
    CPU the plain versions read the count on the host."""
    call, width, dtype = _count_call(name, "cpu")
    live = min(count, COUNT_ROWS)
    want = call(live)
    out = torch.full((COUNT_ROWS, width), -7.0).to(dtype)
    c = torch.tensor([count], dtype=torch.int32)
    got = call(COUNT_ROWS, count=c, out=out)
    assert got is out
    assert torch.equal(got[:live], want)
    assert bool((got[live:] == -7.0).all())
    made = call(COUNT_ROWS, count=c)
    assert made.shape == (COUNT_ROWS, width) and made.dtype == dtype
    assert torch.equal(made[:live], want)
    for bad in (torch.tensor([count]), torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError):
            call(COUNT_ROWS, count=bad)
    with pytest.raises(ValueError):
        call(COUNT_ROWS, count=c, out=out[:-1])


@pytest.mark.parametrize("cd", list(DTYPES.values()), ids=list(DTYPES))
def test_network_forward_takes_a_row_count(cd):
    """NerfNetwork's forward with a row count and row_buffers' outputs:
    rgb and sigma below the count bit for bit the forward on those rows,
    views of the buffers; the buffers' rows at and above it untouched; a
    call that needs gradients refuses a count."""
    jc, _ = _rgb_case(E=8)
    net = _net(jc)
    n, count = 64, 37
    pos = torch.as_tensor(_positions(jc, n=n))
    dirs = torch.as_tensor(_dirs(n))
    codes = torch.arange(8, dtype=torch.float32) / 8.0
    rgb_w, sig_w = net(pos[:count], dirs[:count], compute_dtype=cd,
                       extra=codes)
    out = net.row_buffers(n, cd)
    assert ("encode" in out) == (cd == torch.float32)
    for v in out.values():
        v.fill_(-3.0)
    c = torch.tensor([count], dtype=torch.int32)
    rgb, sig = net(pos, dirs, compute_dtype=cd, extra=codes, count=c, out=out)
    assert rgb.data_ptr() == out["rgb"].data_ptr()
    assert sig.data_ptr() == out["density"].data_ptr()
    assert torch.equal(rgb[:count], rgb_w) and torch.equal(sig[:count], sig_w)
    assert bool((out["rgb"][count:] == -3.0).all())
    assert bool((out["density"][count:] == -3.0).all())
    assert rgb.shape == (n, 3) and sig.shape == (n,)
    net.requires_grad_(True)
    with pytest.raises(ValueError):
        net.density_raw(pos, cd, count=c, out=out)


def test_compare_with_plain_counts_under_the_contract():
    g = torch.Generator().manual_seed(0)
    p = torch.randn((5000, 16), generator=g) * 3.0
    r = nc.compare_with_plain("mlp", p.clone(), p, torch.float32)
    assert r["ok"] and r["mismatched_rows"] == 0 and r["allowed"] == 0
    k = p.clone()
    k[:2, 3] += 5e-5 * torch.clamp(p[:2, 3].abs(), min=1.0)
    assert nc.compare_with_plain("mlp", k, p, torch.float32)["ok"]
    k[7, 0] += 2e-4 * max(1.0, float(p[7, 0].abs()))
    r = nc.compare_with_plain("mlp", k, p, torch.float32)
    assert not r["ok"] and r["mismatched_rows"] == 1
    k = p.clone()
    k[:5, 1] += 0.05                                   # 5 of 5000 rows
    r = nc.compare_with_plain("rgb", k[:, :3], p[:, :3], torch.bfloat16)
    assert not r["ok"] and r["mismatched_rows"] == 5 and r["allowed"] == 0
    big = torch.randn((200_000, 3), generator=g)       # 2 of 200,000 rows
    kb = big.clone()
    kb[:2, 1] += 0.05
    r = nc.compare_with_plain("rgb", kb, big, torch.bfloat16)
    assert r["ok"] and r["mismatched_rows"] == 2 and r["allowed"] == 2
    kb[2, 2] += 0.05
    assert not nc.compare_with_plain("rgb", kb, big, torch.bfloat16)["ok"]
    kb = big.clone()
    kb[0, 0] += 0.1                                    # past the 8e-2 cap
    r = nc.compare_with_plain("rgb", kb, big, torch.bfloat16)
    assert not r["ok"] and r["mismatched_rows"] == 1 <= r["allowed"]
    k = p.clone()
    k[3, 3] = float("nan")
    r = nc.compare_with_plain("mlp", k, p, torch.bfloat16)
    assert not r["ok"] and r["nan"] == 1
    e = p.to(torch.bfloat16)
    up = (e.float() + nc.bf16_ulp(e.float())).to(torch.bfloat16)
    assert bool((up != e).all())
    assert nc.compare_with_plain("encode", up, e, torch.bfloat16)["ok"]
    two = (up.float() + nc.bf16_ulp(up.float())).to(torch.bfloat16)
    assert not nc.compare_with_plain("encode", two, e, torch.bfloat16)["ok"]
    f = p.clone()
    f[0, 0] += 2e-5 * abs(float(f[0, 0])) + 1e-6
    assert not nc.compare_with_plain("encode", f, p, torch.float32)["ok"]
    with pytest.raises(ValueError):
        nc.compare_with_plain("march", p, p, torch.float32)


def test_work_counts():
    jc = JCfg.native_fast()
    tc = _tcfg(jc)
    pos = torch.as_tensor(_positions(jc, n=100))
    flops, nbytes = nc.encode_work(torch.zeros(1), pos, tc)
    L, F = 8, 4
    assert flops == 100 * L * (30 + 16 * F)
    # the rows touched: at most 8 a sample and level, at least 1 a level
    assert 100 * 12 + 100 * L * F * 4 + L * F * 4 <= nbytes
    assert nbytes <= 100 * 12 + 100 * L * F * 4 + 100 * 8 * L * F * 4
    ws = [torch.zeros(s) for s in jc.mlp_shapes()[0]]
    x = torch.zeros((10, 32), dtype=torch.bfloat16)
    assert nc.mlp_work(x, ws) == (2 * 10 * 3072, 10 * 64 + 4 * 3072 + 640)
    # the rgb head: its last layer's stored columns only (3 of 16)
    ws = [torch.zeros(s) for s in jc.mlp_shapes()[1]]
    macs = 32 * 64 + 64 * 64 + 3 * 64
    assert nc.rgb_head_work(torch.zeros(10, 16), torch.zeros(10, 3), ws) == (
        10 * (2 * macs + 60), 10 * (64 + 12 + 12) + 4 * macs)


# ---------------------------------------------------------------------------
# The fused encode + density MLP (nmr_encode_mlp)
# ---------------------------------------------------------------------------

FUSED_CONFIGS = {"native_fast": JCfg.native_fast(), "ngp": JCfg()}
# the feature counts the main path does not reach, at input widths (5 and
# 24) that the first layer zero-pads to 16 and 32
ODD_CONFIGS = {
    "f1": JCfg(n_levels=5, n_features_per_level=1, log2_hashmap_size=12),
    "f8": JCfg(n_levels=3, n_features_per_level=8, log2_hashmap_size=12)}


@functools.lru_cache(maxsize=None)
def _fused_table(name):
    return _table({**FUSED_CONFIGS, **ODD_CONFIGS}[name])


def _density_weights(jc, hid, seed=30):
    """The config's density MLP with its hidden layers hid wide."""
    d = jc.mlp_shapes()[0]
    shapes = ([(hid, d[0][1])] + [(hid, hid)] * (len(d) - 2)
              + [(d[-1][0], hid)])
    return _mlp_weights(shapes, seed + hid)


def _fused_positions(jc, n, seed=0):
    return _positions(jc, n=max(n, 192), seed=seed)[:n]


@pytest.mark.parametrize("n", [1, 63, 65, 4099])
@pytest.mark.parametrize("encode", list(DTYPES))
@pytest.mark.parametrize("hid", [64, 128])
@pytest.mark.parametrize("name", list(FUSED_CONFIGS))
def test_encode_mlp_model_matches_plain(name, hid, encode, n):
    """The fused kernel's model (the encode's corner sums, the bf16 A
    tile, the tensor-core chain) against encode_mlp_reference under the
    bf16 contract, at native_fast and NGPConfig() widths, both hidden
    widths, both encode dtypes and row counts around the 64-row tile."""
    jc = FUSED_CONFIGS[name]
    table = _fused_table(name)
    pos = _fused_positions(jc, n, seed=n)
    weights = _density_weights(jc, hid)
    plain = nc.encode_mlp_reference(
        torch.as_tensor(table), torch.as_tensor(pos),
        [torch.as_tensor(w) for w in weights], _tcfg(jc), torch.bfloat16,
        DTYPES[encode])
    assert plain.shape == (n, 16) and plain.dtype == torch.float32
    model = _encode_mlp_model(table, pos, jc, weights, encode == "bfloat16")
    _assert_contract("mlp", model, plain, torch.bfloat16)


@pytest.mark.parametrize("encode", list(DTYPES))
@pytest.mark.parametrize("name", list(ODD_CONFIGS))
def test_encode_mlp_model_other_feature_counts(name, encode):
    """As above at F = 1 and F = 8, input widths 5 and 24 (zero-padded
    columns in the A tile), N = 65 and 300."""
    jc = ODD_CONFIGS[name]
    table = _fused_table(name)
    weights = _density_weights(jc, 64)
    assert weights[0].shape[1] == jc.n_levels * jc.n_features_per_level
    for n in (65, 300):
        pos = _fused_positions(jc, n, seed=n)
        plain = nc.encode_mlp_reference(
            torch.as_tensor(table), torch.as_tensor(pos),
            [torch.as_tensor(w) for w in weights], _tcfg(jc), torch.bfloat16,
            DTYPES[encode])
        model = _encode_mlp_model(table, pos, jc, weights,
                                  encode == "bfloat16")
        _assert_contract("mlp", model, plain, torch.bfloat16)


@pytest.mark.parametrize("cd", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_mlp_reference_matches_jax_density_raw(name, cd):
    """encode_mlp_reference against the JAX package's density_raw on the
    same parameters and positions: 1e-4 at f32 compute, 2e-2 at bf16;
    with the bf16 encode at bf16 compute as the trainer runs it."""
    jc = CONFIGS[name]
    params = _params(jc, seed=17)
    net = params_from_jax(params, _tcfg(jc))
    jp = {"density_mlp": tuple(jnp.asarray(w) for w in params["density_mlp"]),
          "grid": jnp.asarray(params["grid"])}
    pos = _positions(jc, n=160, seed=18)
    tol = 1e-4 if cd == "float32" else 2e-2
    for enc in ("float32", "bfloat16") if cd == "bfloat16" else ("float32",):
        want = np.asarray(jnet.density_raw(
            jp, jnp.asarray(pos), jc, compute_dtype=getattr(jnp, cd),
            encode_dtype=getattr(jnp, enc)))
        got = nc.encode_mlp_reference(net.grid, torch.as_tensor(pos),
                                      net.density_mlp, _tcfg(jc), DTYPES[cd],
                                      DTYPES[enc])
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_fused_routing_rule(monkeypatch):
    """density_raw on a (simulated) card: at bf16 with no gradient the
    fused encode_mlp, at f32 hash_encode and mlp; with a gradient the
    plain versions, counted once in plain_on_card["encode_mlp"] at bf16
    (and in hash_encode's and mlp's at f32), autograd intact. The rule is
    network_cuda.takes_kernel's own, handed the tensors as they would lie
    on a CUDA device."""
    net = _net()
    pos = torch.as_tensor(_positions(TEST_CFG, n=40))
    rule = nc.takes_kernel
    card = torch.device("cuda")
    routed = []

    def on_card(name, *ts):
        took = rule(name, *(None if t is None else types.SimpleNamespace(
            device=card, requires_grad=t.requires_grad) for t in ts))
        routed.append((name, took))
        return took

    monkeypatch.setattr(nc, "takes_kernel", on_card)
    monkeypatch.setattr(nc, "encode_mlp", lambda *a: ("fused", a))
    want = {cd: nc.encode_mlp_reference(net.grid, pos, net.density_mlp,
                                        net.config, cd)
            for cd in DTYPES.values()}
    got = net.density_raw(pos)
    assert got[0] == "fused" and routed == [("encode_mlp", True)]
    grid, p, weights, cfg, cd, ed = got[1]
    assert grid is net.grid and torch.equal(p, pos) and cd == torch.bfloat16
    assert ed == torch.float32 and list(weights) == list(net.density_mlp)
    routed.clear()
    assert torch.equal(net.density_raw(pos, torch.float32),
                       want[torch.float32])
    assert routed == [("hash_encode", True), ("mlp", True)]
    net.requires_grad_(True)
    before = dict(nc.plain_on_card)
    routed.clear()
    out = net.density_raw(pos)
    assert routed == [("encode_mlp", False)] and out.requires_grad
    assert torch.equal(out.detach(), want[torch.bfloat16])
    assert nc.plain_on_card["encode_mlp"] == before["encode_mlp"] + 1
    out.sum().backward()
    assert bool(net.grid.grad.abs().sum() > 0)
    with torch.no_grad():
        routed.clear()
        assert net.density_raw(pos)[0] == "fused"
        assert routed == [("encode_mlp", True)]
    assert nc.plain_on_card["encode_mlp"] == before["encode_mlp"] + 1


def test_encode_mlp_wrapper_validation():
    """encode_mlp takes what hash_encode and mlp take, at the bf16 compute
    dtype; on CPU tensors it runs the plain version."""
    tc = _tcfg(TEST_CFG)
    net = _net()
    grid = net.grid.detach()
    pos = torch.as_tensor(_positions(TEST_CFG, n=16))
    ws = [w.detach() for w in net.density_mlp]
    assert torch.equal(nc.encode_mlp(grid, pos, ws, tc),
                       nc.encode_mlp_reference(grid, pos, ws, tc))
    assert nc.encode_mlp(grid, pos[:0], ws, tc).shape == (0, 16)
    bad = [
        (grid, pos.double(), ws, tc),                    # dtype
        (grid, pos[:, :2], ws, tc),                      # shape
        (grid, pos.T.contiguous().T, ws, tc),            # not contiguous
        (grid[:, :100], pos, ws, tc),                    # rows < hashmap
        (grid[:8], pos, ws, tc),                         # levels
        (grid.to("meta"), pos, ws, tc),                  # table elsewhere
        (grid, pos, ws[::-1], tc),                       # chain
        (grid, pos, [torch.zeros((64, 16)), ws[1]], tc),  # input != L*F
        (grid, pos, [torch.zeros((200, 32)), torch.zeros((16, 200))], tc),
        (grid, pos, ws * 5, tc),                         # > 8 layers
        (grid, pos, [ws[0].T.contiguous().T, ws[1]], tc),
        (torch.zeros((40, 8, 2)), pos, ws,
         TCfg(n_levels=40, log2_hashmap_size=3)),        # > 32 levels
        (torch.zeros((2, 64, 3)), pos, [torch.zeros((64, 6)), ws[1]],
         TCfg(n_levels=2, n_features_per_level=3, log2_hashmap_size=6)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            nc.encode_mlp(*args)
    for cd, ed in ((torch.float32, torch.float32),       # f32 compute
                   (torch.float16, torch.float32),
                   (torch.bfloat16, torch.float16)):
        with pytest.raises(ValueError):
            nc.encode_mlp(grid, pos, ws, tc, cd, ed)


def test_encode_mlp_work_counts():
    jc = JCfg.native_fast()
    tc = _tcfg(jc)
    pos = torch.as_tensor(_positions(jc, n=100))
    ws = [torch.zeros(s) for s in jc.mlp_shapes()[0]]
    for ed in DTYPES.values():
        e_flops, e_bytes = nc.encode_work(torch.zeros(1), pos, tc, ed)
        flops, nbytes = nc.encode_mlp_work(torch.zeros(1), pos, ws, tc,
                                           torch.bfloat16, ed)
        assert flops == e_flops + 2 * 100 * 3072
        enc_out = 100 * 32 * (2 if ed == torch.bfloat16 else 4)
        assert nbytes == e_bytes - enc_out + 4 * 3072 + 4 * 100 * 16
    # no intermediate: pos, the rows touched, weights, the output
    assert nbytes < 100 * 12 + 100 * 8 * 8 * 4 * 4 + 4 * 3072 + 6400


def test_gather_sector_counts():
    """One sample: either gather requests one sector a corner on each
    level (8 a (sample, level)). Samples along a ray share corners: the
    fused kernel's level-major warps request fewer than the standalone's,
    which span L levels; a count done by hand on two samples agrees."""
    for jc in (JCfg.native_fast(), TEST_CFG):
        tc = _tcfg(jc)
        table = torch.zeros((jc.n_levels, jhash.padded_table_rows(jc),
                             jc.n_features_per_level))
        pos = torch.as_tensor(_fused_positions(jc, 2, seed=4))
        assert nc.encode_gather_sectors(table, pos[:1], tc) == (8.0, 8.0)
        scales, res, sizes, dense = thash.level_constants(tc)
        L, F, S = jc.n_levels, jc.n_features_per_level, table.shape[1]
        secs = []
        for lvl in range(L):
            idx, _ = thash.corner_indices_and_weights(
                pos, float(scales[lvl]), int(res[lvl]), int(sizes[lvl]),
                bool(dense[lvl]))
            secs.append(((lvl * S + idx) * F * 4) // 32)
        # both samples in one warp either way (2 L <= 32 items)
        want = sum(len({int(secs[lvl][k, c]) for k in (0, 1)})
                   for lvl in range(L) for c in range(8))
        assert nc.encode_gather_sectors(table, pos, tc) == (
            want / (2 * L), want / (2 * L))
        t = torch.linspace(0.2, 0.8, 4096)[:, None]
        ray = torch.as_tensor([0.1, 0.2, 0.3]) + t * torch.as_tensor(
            [0.7, 0.5, 0.6])
        old, new = nc.encode_gather_sectors(table, ray.contiguous(), tc)
        assert new < old <= 8.0
    assert nc.encode_gather_sectors(table, pos[:0], tc) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# (d) The kernels on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_and_mlp_kernels_match_plain_on_card(name, dtype):
    _needs_card()
    jc = CONFIGS[name]
    tc = _tcfg(jc)
    net = params_from_jax(_params(jc), tc, device="cuda")
    pos = torch.as_tensor(_positions(jc, n=4099), device="cuda")
    before = dict(nc.launches)
    enc = nc.hash_encode(net.grid, pos, tc, DTYPES[dtype])
    torch.cuda.synchronize()
    assert nc.launches["hash_encode"] == before["hash_encode"] + 1
    r = nc.compare_with_plain("encode", enc, nc.hash_encode_reference(
        net.grid, pos, tc, DTYPES[dtype]), DTYPES[dtype])
    assert r["ok"], r
    want, _, _ = _encode_model(_params(jc)["grid"], _positions(jc, n=4099),
                               jc, dtype == "bfloat16")
    assert np.array_equal(enc.float().cpu().numpy().view(np.uint32),
                          want.view(np.uint32))
    f32 = nc.mlp(enc, net.density_mlp, torch.float32)
    chain = _layers_model(enc.float().cpu().numpy(),
                          [w.cpu().numpy() for w in net.density_mlp], 16)
    assert np.array_equal(f32.cpu().numpy().view(np.int32),
                          chain.view(np.int32))
    for cd in DTYPES.values():
        r = nc.compare_with_plain("mlp", nc.mlp(enc, net.density_mlp, cd),
                                  nc.mlp_reference(enc, net.density_mlp, cd),
                                  cd)
        assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lf", list(TILED_LF))
def test_hash_encode_kernel_is_its_model_on_card(lf, dtype):
    """nmr_hash_encode on 1, 31, 33 and 4,099 samples (tiles of 64 or 32
    and their tails) at TILED_LF's widths: bit for bit the
    encode's model (which its tiled work map matches bit for bit,
    test_encode_tiling_is_the_encode_bit_for_bit), within the contract of
    the plain version; one launch a call."""
    _needs_card()
    jc, table = _lf_case(lf)
    tc = _tcfg(jc)
    tt = torch.as_tensor(table, device="cuda")
    for n in (1, 31, 33, 4099):
        pos = _positions(jc, n=max(n, 192), seed=n)[:n]
        tp = torch.as_tensor(pos, device="cuda")
        before = nc.launches["hash_encode"]
        got = nc.hash_encode(tt, tp, tc, DTYPES[dtype])
        torch.cuda.synchronize()
        assert nc.launches["hash_encode"] == before + 1
        want, _, _ = _encode_model(table, pos, jc, dtype == "bfloat16")
        assert np.array_equal(got.float().cpu().numpy().view(np.uint32),
                              want.view(np.uint32))
        r = nc.compare_with_plain("encode", got, nc.hash_encode_reference(
            tt, tp, tc, DTYPES[dtype]), DTYPES[dtype])
        assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlp", "mlp32", "mlp64"])
@pytest.mark.parametrize("rows", list(DTYPES))
@pytest.mark.parametrize("hid", [64, 128])
def test_f32_mlp_kernel_is_the_chain_on_card(hid, rows, kind):
    """nmr_mlp at the f32 compute dtype (the register-tiled body: rows
    staged; the last layer's 16 columns tiled, and 32 or 64 stored
    columns, tiled where its items fit the block) on 1, 63, 257 and 4,099
    rows of f32 and of bf16, a NaN row kept: bit for bit the f32 chain
    (_layers_model; its tiled model matches it bit for bit,
    test_tiled_body_is_the_f32_chain_bit_for_bit), within the f32
    contract of the plain version; one launch a call."""
    _needs_card()
    jc, weights = _tc_case(kind, hid)
    tw = [torch.as_tensor(w, device="cuda") for w in weights]
    for n in (1, 63, 257, 4099):
        x = _tc_inputs(jc, n, seed=n, scale=1.0)[0]
        if n > 1:
            x[1, 7] = np.nan
        if rows == "bfloat16":
            x = _bf16(x)
        tx = torch.as_tensor(x, device="cuda").to(DTYPES[rows])
        before = nc.launches["mlp"]
        got = nc.mlp(tx, tw, torch.float32)
        torch.cuda.synchronize()
        assert nc.launches["mlp"] == before + 1
        want = _layers_model(x, weights, weights[-1].shape[0])
        g = got.cpu().numpy()
        assert np.array_equal(np.isnan(g), np.isnan(want))
        live = ~np.isnan(want)
        assert np.array_equal(g[live].view(np.int32), want[live].view(np.int32))
        _hold_nan_rows("mlp", got, nc.mlp_reference(tx, tw, torch.float32),
                       torch.float32, [1] if n > 1 else [])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4099, 127])
@pytest.mark.parametrize("hid", [64, 128])
@pytest.mark.parametrize("extra", ["none", "codes", "rows"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rgb_head_kernel_matches_plain_on_card(dtype, extra, hid, n):
    """At both hidden widths, on a sample count that is no whole number of
    tiles (32 tiles and 3 samples) and on one short tile; at f32 also bit
    for bit the register-tiled body's model."""
    _needs_card()
    E = 0 if extra == "none" else 8
    jc = JCfg(n_extra_learnable_dims=E, log2_hashmap_size=15,
              rgb_neurons=hid)
    weights = _mlp_weights(jc.mlp_shapes()[1], seed=7 + E + hid)
    tc = _tcfg(jc)
    rng = np.random.default_rng(16)
    feat = torch.as_tensor(rng.standard_normal((n, 16)).astype(F32),
                           device="cuda")
    dirs = torch.as_tensor(_dirs(n), device="cuda")
    codes = {"none": None, "codes": rng.standard_normal(E),
             "rows": rng.standard_normal((n, E))}[extra]
    if codes is not None:
        codes = torch.as_tensor(codes.astype(F32), device="cuda")
    tw = [torch.as_tensor(w, device="cuda") for w in weights]
    cd = DTYPES[dtype]
    got = nc.rgb_head(feat, dirs, tw, tc, cd, codes)
    r = nc.compare_with_plain(
        "rgb", got, nc.rgb_head_reference(feat, dirs, tw, tc, cd, codes), cd)
    assert r["ok"], r
    if cd == torch.float32:
        model = _rgb_head_model(feat.cpu().numpy(), dirs.cpu().numpy(),
                                weights, jc, False,
                                None if codes is None else codes.cpu().numpy())
        assert np.array_equal(got.cpu().numpy().view(np.int32),
                              model.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [64, 128])
def test_tensor_core_kernels_at_large_activations_on_card(hid):
    """With hidden sums up to ~100 (inputs 50x), a bf16 step of a hidden
    activation is 0.25-0.5, and the tensor cores' sums round some of them
    the other way than aten's f32 GEMM: rows then differ by more than the
    contract's 2e-2 (with a frame's inputs scaled 64x, 0.02-0.06% of its
    rows on an H100, PERF.md section 6). Every output stays within one
    bf16 step of every hidden activation of the plain version's
    (`network_cuda.bf16_step_bound`)."""
    _needs_card()
    jc, r_w = _tc_case("rgb32", hid)
    _, d_w = _tc_case("mlp", hid)
    tc = _tcfg(jc)
    dw = [torch.as_tensor(w, device="cuda") for w in d_w]
    rw = [torch.as_tensor(w, device="cuda") for w in r_w]
    x, feat, dirs, _ = (torch.as_tensor(a, device="cuda")
                        for a in _tc_inputs(jc, 20_000, seed=hid))
    feat = feat * 25.0
    bf = torch.bfloat16
    got = nc.mlp(x, dw, bf)
    bound = nc.bf16_step_bound(x, dw)
    assert bool(((got - nc.mlp_reference(x, dw, bf)).abs() <= bound).all())
    got = nc.rgb_head(feat, dirs, rw, tc, bf)
    bound = nc.bf16_step_bound(nc.rgb_row(feat, dirs, tc), rw)[:, :3]
    assert bool(((got - nc.rgb_head_reference(feat, dirs, rw, tc, bf)).abs()
                 <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("extra", ["none", "codes", "rows"])
@pytest.mark.parametrize("hid", [64, 128])
def test_tensor_core_kernels_match_plain_on_card(hid, extra):
    """The bf16 MLP kernels (the tensor-core body) at both hidden widths,
    with no codes, codes given once and per row, on row counts that are
    not multiples of the 64-row tile; a NaN input row stays NaN. Inputs
    at the encode's scale (the 50x rows are the case above)."""
    _needs_card()
    kind = "rgb32" if extra == "none" else "rgb48"
    jc, r_w = _tc_case(kind, hid)
    _, d_w = _tc_case("mlp", hid)
    tc = _tcfg(jc)
    dw = [torch.as_tensor(w, device="cuda") for w in d_w]
    rw = [torch.as_tensor(w, device="cuda") for w in r_w]
    bf = torch.bfloat16
    for n in (1, 63, 65, 4099):
        x, feat, dirs, codes = _tc_inputs(jc, n, seed=n, scale=1.0)
        if n > 1:
            x[1, 7] = np.nan
            feat[1, 5] = np.nan
        x, feat, dirs = (torch.as_tensor(a, device="cuda")
                         for a in (x, feat, dirs))
        codes = {"none": None, "codes": torch.as_tensor(codes[0], device="cuda"),
                 "rows": torch.as_tensor(codes, device="cuda")}[extra]
        before = dict(nc.launches)
        for xin in (x, x.to(bf)):
            _hold_nan_rows("mlp", nc.mlp(xin, dw, bf),
                           nc.mlp_reference(xin, dw, bf), bf,
                           [1] if n > 1 else [])
        _hold_nan_rows("rgb", nc.rgb_head(feat, dirs, rw, tc, bf, codes),
                       nc.rgb_head_reference(feat, dirs, rw, tc, bf, codes),
                       bf, [1] if n > 1 else [])
        torch.cuda.synchronize()
        assert nc.launches["mlp"] == before["mlp"] + 2
        assert nc.launches["rgb_head"] == before["rgb_head"] + 1


@pytest.mark.cuda
def test_kernels_see_weights_changed_in_place_on_card():
    """Nothing is cached between launches: weights updated in place (as
    the trainer does while the viewer renders) reach the next launch."""
    _needs_card()
    jc, r_w = _tc_case("rgb32", 64)
    _, d_w = _tc_case("mlp", 64)
    tc = _tcfg(jc)
    x, feat, dirs, _ = (torch.as_tensor(a, device="cuda")
                        for a in _tc_inputs(jc, 300, seed=4))
    for cd in DTYPES.values():
        dw = [torch.as_tensor(w, device="cuda") for w in d_w]
        rw = [torch.as_tensor(w, device="cuda") for w in r_w]
        first = (nc.mlp(x, dw, cd), nc.rgb_head(feat, dirs, rw, tc, cd))
        dw[0].mul_(-0.5)
        rw[1].mul_(-0.5)
        second = (nc.mlp(x, dw, cd), nc.rgb_head(feat, dirs, rw, tc, cd))
        for a, b in zip(first, second):
            assert not torch.equal(a, b)
        assert nc.compare_with_plain("mlp", second[0],
                                     nc.mlp_reference(x, dw, cd), cd)["ok"]
        assert nc.compare_with_plain(
            "rgb", second[1], nc.rgb_head_reference(feat, dirs, rw, tc, cd),
            cd)["ok"]


@pytest.mark.cuda
def test_unsupported_shape_raises_on_card():
    """A shape the wrapper takes but no kernel body can hold (an 8192-wide
    input row: its tile and ring exceed a block's shared memory) raises;
    no plain version runs in its place."""
    _needs_card()
    x = torch.zeros((64, 8192), device="cuda")
    ws = [torch.zeros((64, 8192), device="cuda"),
          torch.zeros((16, 64), device="cuda")]
    for cd in DTYPES.values():
        before = dict(nc.launches)
        with pytest.raises(RuntimeError):
            nc.mlp(x, ws, cd)
        assert nc.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("encode", list(DTYPES))
@pytest.mark.parametrize("hid", [64, 128])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_mlp_kernel_on_card(name, hid, encode):
    """nmr_encode_mlp equals nmr_hash_encode followed by nmr_mlp at the
    bf16 compute dtype bit for bit, and is within the bf16 contract of its
    plain version, on N = 1, 63, 65, 4099; one launch a call."""
    _needs_card()
    jc = CONFIGS[name]
    tc = _tcfg(jc)
    table = torch.as_tensor(_table(jc), device="cuda")
    ws = [torch.as_tensor(w, device="cuda")
          for w in _density_weights(jc, hid)]
    bf, ed = torch.bfloat16, DTYPES[encode]
    for n in (1, 63, 65, 4099):
        pos = torch.as_tensor(_fused_positions(jc, n, seed=n), device="cuda")
        before = dict(nc.launches)
        got = nc.encode_mlp(table, pos, ws, tc, bf, ed)
        torch.cuda.synchronize()
        assert nc.launches["encode_mlp"] == before["encode_mlp"] + 1
        pair = nc.mlp(nc.hash_encode(table, pos, tc, ed), ws, bf)
        assert torch.equal(got.view(torch.int32), pair.view(torch.int32))
        r = nc.compare_with_plain(
            "mlp", got, nc.encode_mlp_reference(table, pos, ws, tc, bf, ed), bf)
        assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ODD_CONFIGS))
def test_encode_mlp_kernel_other_feature_counts_on_card(name):
    """F = 1 and F = 8 (their own instances), zero-padded input widths:
    bit for bit the pair, within the contract of the plain version."""
    _needs_card()
    jc = ODD_CONFIGS[name]
    tc = _tcfg(jc)
    table = torch.as_tensor(_table(jc), device="cuda")
    ws = [torch.as_tensor(w, device="cuda") for w in _density_weights(jc, 64)]
    pos = torch.as_tensor(_fused_positions(jc, 4099), device="cuda")
    for ed in DTYPES.values():
        got = nc.encode_mlp(table, pos, ws, tc, torch.bfloat16, ed)
        pair = nc.mlp(nc.hash_encode(table, pos, tc, ed), ws, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), pair.view(torch.int32))
        r = nc.compare_with_plain("mlp", got, nc.encode_mlp_reference(
            table, pos, ws, tc, torch.bfloat16, ed), torch.bfloat16)
        assert r["ok"], r


@pytest.mark.cuda
def test_encode_mlp_sees_weights_changed_in_place_on_card():
    _needs_card()
    jc = JCfg.native_fast()
    tc = _tcfg(jc)
    table = torch.as_tensor(_table(jc), device="cuda")
    pos = torch.as_tensor(_fused_positions(jc, 300), device="cuda")
    ws = [torch.as_tensor(w, device="cuda") for w in _density_weights(jc, 64)]
    first = nc.encode_mlp(table, pos, ws, tc)
    ws[0].mul_(-0.5)
    table.mul_(2.0)
    second = nc.encode_mlp(table, pos, ws, tc)
    assert not torch.equal(first, second)
    assert nc.compare_with_plain(
        "mlp", second, nc.encode_mlp_reference(table, pos, ws, tc),
        torch.bfloat16)["ok"]


@pytest.mark.cuda
def test_encode_mlp_unsupported_shape_raises_on_card():
    """Shapes the fused kernel does not take raise on the card and launch
    nothing: a feature count of 3, a 200-wide hidden layer, the f32
    compute dtype (which takes hash_encode and mlp)."""
    _needs_card()
    jc = JCfg.native_fast()
    tc = _tcfg(jc)
    table = torch.as_tensor(_table(jc), device="cuda")
    pos = torch.as_tensor(_fused_positions(jc, 64), device="cuda")
    ws = [torch.as_tensor(w, device="cuda") for w in _density_weights(jc, 64)]
    wide = [torch.zeros((200, 32), device="cuda"),
            torch.zeros((16, 200), device="cuda")]
    before = dict(nc.launches)
    for args in ((torch.zeros((2, 64, 3), device="cuda"), pos,
                  [torch.zeros((64, 6), device="cuda"), ws[1]],
                  TCfg(n_levels=2, n_features_per_level=3,
                       log2_hashmap_size=6)),
                 (table, pos, wide, tc),
                 (table, pos, ws, tc, torch.float32)):
        with pytest.raises(ValueError):
            nc.encode_mlp(*args)
    assert nc.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("name", COUNT_CALLS)
def test_kernels_take_a_row_count_on_card(name, count):
    """Each kernel launched over COUNT_ROWS rows with a row count in
    device memory, into an output holding NaN: one launch; the rows below
    the count bit for bit the kernel's own on all the rows without a count
    (each row's work does not depend on which block takes it), the rows
    at and above it still NaN; the count changed on the device after the
    call and the same call made again serves the new count."""
    _needs_card()
    call, width, dtype = _count_call(name, "cuda")
    live = min(count, COUNT_ROWS)
    want = call(COUNT_ROWS)
    out = torch.full((COUNT_ROWS, width), float("nan"), device="cuda").to(
        dtype)
    c = torch.tensor([count], dtype=torch.int32, device="cuda")
    kernel = {"encode_mlp": "encode_mlp", "mlp": "mlp"}.get(
        name.replace("_bf16", ""), "rgb_head" if "rgb" in name
        else "hash_encode")
    before = nc.launches[kernel]
    got = call(COUNT_ROWS, count=c, out=out)
    torch.cuda.synchronize()
    assert got is out and nc.launches[kernel] == before + 1
    g, w = got.float(), want.float()
    assert torch.equal(g[:live].view(torch.int32), w[:live].view(torch.int32))
    assert bool(torch.isnan(g[live:]).all())
    c.fill_(COUNT_ROWS - 3)
    call(COUNT_ROWS, count=c, out=out)
    torch.cuda.synchronize()
    g = out.float()
    assert torch.equal(g[:COUNT_ROWS - 3].view(torch.int32),
                       w[:COUNT_ROWS - 3].view(torch.int32))
    assert bool(torch.isnan(g[COUNT_ROWS - 3:]).all()) or live > COUNT_ROWS - 3
