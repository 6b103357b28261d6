"""The NeRF network's inference forward: the CUDA kernels, their wrappers
and their plain PyTorch versions.

- `hash_encode` (kernel nmr_hash_encode) is the multiresolution hash-grid
  encode, all levels in one launch (the JAX package's hash_encode,
  nerf_glasses_tpu/ops/hashgrid.py:143; plain version hashgrid.
  hash_encode).
- `mlp` (nmr_mlp) is the bias-free FullyFusedMLP forward of the density
  MLP (JAX ops/mlp.py:17 mlp_apply; plain mlp.mlp_apply).
- `rgb_head` (nmr_rgb_head) is the colour half of the network: the row
  [density output, SH(dir), latent codes, zeros] through the rgb MLP
  (JAX ops/network.py:89 _rgb_head + ops/sh.py:13; plain
  `rgb_head_reference`, on sh.sh_encode and mlp.mlp_apply).
- `encode_mlp` (nmr_encode_mlp) is `hash_encode` followed by `mlp` at
  the bf16 compute dtype in one launch, the encode producing the density
  MLP's first A tile in shared memory (JAX ops/network.py:62
  density_raw -> :44 density_raw_soa; plain `encode_mlp_reference`).
- `hash_encode_backward` (nmr_hash_encode_backward) is the encode's
  gradient: the table's (an atomic scatter-add of w_c * g into the 8
  corner rows of each (sample, level)) and the positions'; `HashEncode`
  is the encode as autograd sees it, its forward `hash_encode` and its
  backward `hash_encode_backward` (JAX: jax.vjp of hashgrid.hash_encode,
  the gathers' transpose; plain `hash_encode_backward_reference`, the
  autograd of hashgrid.hash_encode with index_add_).
None was a Pallas kernel: the JAX package leaves the network to XLA.
At the bf16 compute dtype the MLP kernels run every layer on the
tensor cores (wgmma, bf16 operands, f32 sums); at f32 on the CUDA cores
(f32 fmaf), as the f32 contract needs.

The routing rule (`takes_kernel`, applied by ops/network.NerfNetwork):
a CPU tensor takes the plain version; a CUDA tensor that needs no
gradient (`not torch.is_grad_enabled()`, or no input and no parameter
requires grad) takes the kernel; a CUDA call that needs gradients (the
trainer's forward) takes the plain version and counts in
`plain_on_card`. NerfNetwork.density_raw asks for `encode_mlp` at the
bf16 compute dtype and for `hash_encode` and `mlp` at f32; a CUDA call
of density_raw that needs gradients (`trains_on_card`) takes HashEncode
(the two encode kernels) and then the plain MLP, which counts in
plain_on_card["mlp"]. The wrappers
themselves launch on a CUDA tensor or raise, and run the plain version
on a CPU tensor; there is no fallback from one to the other. Each
counts its launches in `launches[name]`.
The kernels build with nvcc for sm_90a at first use (ops/cuda_build.py),
never at import.

The contract (`compare_with_plain`): the encode to rtol 1e-5 / atol 1e-6
at f32 and within one bf16 ulp at bf16; the MLP outputs (encode_mlp's
too) and rgb to 1e-4 x max(1, |ref|) at f32 compute, and at bf16 compute
within 2e-2 absolute on all but 1e-5 of the rows and within 8e-2 on
every row; no NaN. encode_mlp equals hash_encode followed by mlp bit for
bit (the same corner sums, the same bf16 A tile, the same wgmma chain). The
kernels keep the plain versions' rounding points and sum the 8 corners
and the MLP products in another order than aten (the tensor cores also
at their own internal precision): that is the one source of
difference. The backward (`compare_gradients`): the table's gradient
within 1e-5 of its largest magnitude, the positions' within 1e-5 of
theirs (the atomic adds sum each row in no fixed order, as the card's
index_add_ does).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.ops import cuda_build, hashgrid
from nerf_glasses_tpu_torch.ops.hashgrid import (corner_indices_and_weights,
                                                 level_constants)
from nerf_glasses_tpu_torch.ops.mlp import mlp_apply
from nerf_glasses_tpu_torch.ops.sh import sh_encode

_SOURCE = os.path.join(cuda_build.PKG, "csrc", "network.cu")
# -fmad=false: the encode rounds every product and sum on its own, as
# aten's elementwise ops do (the MLPs' fmaf are explicit).
NVCC_FLAGS = cuda_build.ARCH_FLAGS + ("-fmad=false",)

MAX_LEVELS = 32
MAX_LAYERS = 8
MAX_HIDDEN = 128
FEATURES = (1, 2, 4, 8)
DTYPES = (torch.float32, torch.bfloat16)

# The kernel-vs-plain contract (compare_with_plain).
ENCODE_RTOL, ENCODE_ATOL = 1e-5, 1e-6
MLP_F32_REL = 1e-4
MLP_BF16_ATOL = 2e-2
# At bf16 compute an f32 sum a few ulps from aten's (the tensor cores sum
# each k16 step in their own order and internal precision) can round a
# hidden activation to the neighbouring bf16 value. Up to 1e-5 of the
# rows (none under 100,000 rows; 3 of the frames' 347,652) may differ by
# more than MLP_BF16_ATOL, and none by more than MLP_BF16_CAP.
MLP_BF16_ROW_SHARE = 1e-5
MLP_BF16_CAP = 4 * MLP_BF16_ATOL

# the backward's contract (compare_gradients)
GRAD_REL = 1e-5

KERNELS = ("hash_encode", "mlp", "rgb_head", "encode_mlp",
           "hash_encode_backward")
# Kernel launches per wrapper (CUDA tensors only), and calls on a CUDA
# tensor that took the plain version because they need gradients.
launches = dict.fromkeys(KERNELS, 0)
plain_on_card = dict.fromkeys(KERNELS, 0)

_lib = None
build_log = ""
build_seconds = 0.0


class EncodeParams(ctypes.Structure):
    """csrc/network.cu's EncodeParams."""
    _fields_ = [("n_levels", ctypes.c_int), ("n_features", ctypes.c_int),
                ("rows", ctypes.c_longlong), ("encode_bf16", ctypes.c_int),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("res", ctypes.c_uint * MAX_LEVELS),
                ("size", ctypes.c_uint * MAX_LEVELS),
                ("dense", ctypes.c_int * MAX_LEVELS)]


class MlpParams(ctypes.Structure):
    """csrc/network.cu's MlpParams."""
    _fields_ = [("n_layers", ctypes.c_int),
                ("width", ctypes.c_int * (MAX_LAYERS + 1)),
                ("round_bf16", ctypes.c_int), ("x_bf16", ctypes.c_int),
                ("n_store", ctypes.c_int), ("n_feat", ctypes.c_int),
                ("sh_degree", ctypes.c_int), ("n_extra", ctypes.c_int),
                ("extra_rows", ctypes.c_int),
                ("w", ctypes.c_void_p * MAX_LAYERS)]


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    lib, build_log, build_seconds = cuda_build.build_library(_SOURCE,
                                                             NVCC_FLAGS)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    _lib = cuda_build.declare(lib, [
        ("nmr_hash_encode", [p, ll, p, p, p, p, p], i),
        ("nmr_mlp", [p, ll, p, p, p, p], i),
        ("nmr_rgb_head", [p, ll, p, p, p, p, p, p], i),
        ("nmr_encode_mlp", [p, p, ll, p, p, p, p, p], i),
        ("nmr_hash_encode_backward", [p, ll, p, p, p, p, p, p], i)])
    return _lib


# ---------------------------------------------------------------------------
# The routing rule
# ---------------------------------------------------------------------------

def takes_kernel(name: str, *tensors) -> bool:
    """True where kernel `name` serves a call on `tensors` (None entries
    skipped; the first one's device decides): a CUDA tensor with no
    gradient needed. A CUDA call that needs gradients is counted in
    plain_on_card[name] and takes the plain version, as CPU tensors do."""
    if tensors[0].device.type != "cuda":
        return False
    if trains_on_card(*tensors):
        plain_on_card[name] += 1
        return False
    return True


def trains_on_card(*tensors) -> bool:
    """True where a call on `tensors` (None entries skipped; the first
    one's device decides) needs gradients on a CUDA tensor: the trainer's
    forward, whose hash encode takes HashEncode."""
    return (tensors[0].device.type == "cuda" and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in tensors))


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def hash_encode_reference(table, pos, config: NGPConfig,
                          encode_dtype=torch.float32):
    """(N, L*F) features in encode_dtype (ops/hashgrid.hash_encode)."""
    return hashgrid.hash_encode(table, pos, config, compute_dtype=encode_dtype)


def backward_rows(table, pos, grad, config: NGPConfig,
                  encode_dtype=torch.float32):
    """What the table's gradient sums -> (row ids (L*N*8,) into
    table.view(-1, F), rows (L*N*8, F) f32): each (level, sample,
    corner)'s w_c * g, a product in encode_dtype as the plain encode's
    autograd makes it, in that order."""
    scales, res, sizes, dense = level_constants(config)
    F = config.n_features_per_level
    ids, rows = [], []
    for lvl in range(config.n_levels):
        idx, w = corner_indices_and_weights(
            pos, float(scales[lvl]), int(res[lvl]), int(sizes[lvl]),
            bool(dense[lvl]))
        g = grad[:, lvl * F:(lvl + 1) * F]                       # (N, F)
        ids.append(idx.reshape(-1) + lvl * table.shape[1])
        rows.append((g[:, None, :] * w.to(encode_dtype)[..., None])
                    .reshape(-1, F).float())
    return torch.cat(ids), torch.cat(rows)


def hash_encode_backward_reference(table, pos, grad, config: NGPConfig,
                                   encode_dtype=torch.float32,
                                   need_pos: bool = False):
    """The gradient of hash_encode_reference's output `grad` (N, L*F) in
    encode_dtype -> (grad_table (L, S, F) f32, grad_pos (N, 3) f32 or
    None). The table's as autograd gives it on the plain encode:
    backward_rows index_add_-ed into the table in their order. The
    positions': per level d(weights)/d(frac) times the weights' gradient
    (sum_f g_f v_cf in encode_dtype's rounding), summed over the corners
    c = 0..7 and then times the level's scale, summed over the levels in
    order (the kernel's order; autograd sums the same terms in
    another)."""
    F = config.n_features_per_level
    grad_table = torch.zeros_like(table)
    grad_table.view(-1, F).index_add_(
        0, *backward_rows(table, pos, grad, config, encode_dtype))
    if not need_pos:
        return grad_table, None
    scales, res, sizes, dense = level_constants(config)
    bits = hashgrid._corner_offsets(pos.device).bool()             # (8, 3)
    grad_pos = torch.zeros((pos.shape[0], 3), device=pos.device)
    for lvl in range(config.n_levels):
        idx, w = corner_indices_and_weights(
            pos, float(scales[lvl]), int(res[lvl]), int(sizes[lvl]),
            bool(dense[lvl]))
        g = grad[:, lvl * F:(lvl + 1) * F]
        vals = hashgrid.take_rows(table[lvl], idx).to(encode_dtype)
        prod = (g[:, None, :] * vals).float()
        gw = torch.zeros_like(w)
        for f in range(F):
            gw = gw + prod[..., f]
        gw = gw.to(encode_dtype).float()                           # (N, 8)
        frac = pos * float(scales[lvl]) + 0.5
        frac = frac - torch.floor(frac)
        wd = torch.where(bits[None], frac[:, None, :],
                         1.0 - frac[:, None, :])                   # (N, 8, 3)
        ga = gw * wd[..., 2]
        gd = torch.stack([ga * wd[..., 1], ga * wd[..., 0],
                          gw * (wd[..., 0] * wd[..., 1])], -1)
        gf = torch.zeros_like(pos)
        for c in range(8):
            gf = gf + torch.where(bits[c], gd[:, c], -gd[:, c])
        grad_pos = grad_pos + gf * float(scales[lvl])
    return grad_table, grad_pos


def mlp_reference(x, weights, compute_dtype=torch.bfloat16):
    """(N, n_out) f32 (ops/mlp.mlp_apply)."""
    return mlp_apply(x, weights, compute_dtype=compute_dtype)


def encode_mlp_reference(table, pos, weights, config: NGPConfig,
                         compute_dtype=torch.bfloat16,
                         encode_dtype=torch.float32):
    """(N, n_out) f32: mlp_reference(hash_encode_reference(...))."""
    return mlp_reference(hash_encode_reference(table, pos, config,
                                               encode_dtype),
                         weights, compute_dtype)


def rgb_row(feat, dir01, config: NGPConfig, extra=None):
    """The rgb MLP's input rows (N, rgb_in_width) f32: [feat (N,
    density_out), SH(dir01), extra ((E,) or (N, E)), zeros]."""
    n = feat.shape[0]
    sh = sh_encode(dir01, config.sh_degree, config.sh_out_padded)
    parts = [feat.float(), sh]
    if extra is not None:
        # omitted codes are zeros: the padding below supplies them
        parts.append(torch.atleast_2d(extra.float()).expand(
            n, config.n_extra_learnable_dims))
    width = sum(p.shape[-1] for p in parts)
    if width < config.rgb_in_width:
        parts.append(torch.zeros((n, config.rgb_in_width - width),
                                 device=feat.device))
    return torch.cat(parts, dim=-1)


def rgb_head_reference(feat, dir01, weights, config: NGPConfig,
                       compute_dtype=torch.bfloat16, extra=None):
    """rgb_row through the rgb MLP -> rgb_raw (N, 3) f32."""
    return mlp_apply(rgb_row(feat, dir01, config, extra), weights,
                     compute_dtype=compute_dtype)[..., :3]


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _check(name, x, dtypes, shape, device):
    """x as the kernel takes it or ValueError: on `device`, one of
    `dtypes`, `shape` (None entries free), contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes or x.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, x.shape)):
        raise ValueError(f"{name} must be a {' or '.join(map(str, dtypes))} "
                         f"tensor of shape {shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x


def _device(name, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA "
                         f"device, got {x.device}")
    return x.device


def _dtype(name, dtype):
    if dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {dtype} is not float32 or bfloat16")
    return dtype


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(name, fn, dev, params, *args):
    """One kernel launch on dev's current stream, under dev: the library
    launches on the CUDA runtime's current device."""
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(params), *args,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"network kernel {name} launch failed: "
                           f"cudaError_t {err}")
    launches[name] += 1


def _rows_out(name, count, out, n, width, dtype, dev):
    """The output of a call on n rows (a bound where `count` is given):
    `out` checked ((n, width) dtype on dev, contiguous on the card) or
    allocated; count checked: None, or one int32 on dev."""
    if count is not None and (count.dtype != torch.int32 or count.numel() != 1
                              or count.device != dev):
        raise ValueError(f"{name}: count must be one int32 on {dev}, got "
                         f"{count.dtype} {tuple(count.shape)} on {count.device}")
    if out is None:
        return torch.empty((n, width), dtype=dtype, device=dev)
    if dev.type == "cpu" and out.dtype == dtype and tuple(out.shape) == (
            n, width) and out.device == dev:
        return out                 # any layout: the plain versions write it
    return _check(f"{name}: out", out, (dtype,), (n, width), dev)


def rows_below(args, n: int, m: int) -> tuple:
    """args with each (n, ...) 2-d tensor (a row per sample) cut to its
    first m rows: a call's inputs below a row count."""
    return tuple(a[:m] if torch.is_tensor(a) and a.dim() == 2
                 and a.shape[0] == n else a for a in args)


def _plain_rows(fn, count, out, n, *args):
    """fn (a plain version) on the rows below the count (min(count, n),
    read on the host) into out's rows, the rest of out left as it was, or
    fn on all rows where no count is given (into out where given) -> out
    or fn's result."""
    if count is None and out is None:
        return fn(*args)
    m = n if count is None else max(0, min(int(count.reshape(())), n))
    out[:m] = fn(*rows_below(args, n, m))
    return out


# level_constants once per config: the wrappers run on every frame's
# epochs, whose host time bounds the frame.
_levels = functools.lru_cache(maxsize=64)(level_constants)


@functools.lru_cache(maxsize=64)
def _encode_params(config: NGPConfig, rows: int, bf16: bool) -> EncodeParams:
    scales, res, sizes, dense = _levels(config)
    L = config.n_levels
    p = EncodeParams(n_levels=L, n_features=config.n_features_per_level,
                     rows=rows, encode_bf16=int(bf16))
    p.scale[:L] = [float(s) for s in scales]
    p.res[:L] = [int(r) for r in res]
    p.size[:L] = [int(s) for s in sizes]
    p.dense[:L] = [int(d) for d in dense]
    return p


def _check_encode(name, table, pos, config, encode_dtype):
    """table and pos as the encode kernels take them or ValueError ->
    their device."""
    dev = _device(name, pos)
    L, F = config.n_levels, config.n_features_per_level
    _dtype(name, encode_dtype)
    _check("pos", pos, (torch.float32,), (None, 3), dev)
    _check("table", table, (torch.float32,), (L, None, F), dev)
    sizes = _levels(config)[2]
    if L > MAX_LEVELS or F not in FEATURES or table.shape[1] < int(sizes.max()):
        raise ValueError(f"{name}: {L} levels x {F} features over "
                         f"{table.shape[1]} rows (needs L <= {MAX_LEVELS}, F "
                         f"in {FEATURES}, rows >= {int(sizes.max())})")
    if dev.type == "cuda" and table.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be 16-byte aligned")
    return dev


def hash_encode(table, pos, config: NGPConfig, encode_dtype=torch.float32,
                count=None, out=None):
    """table (L, S, F) f32, pos (N, 3) f32 in [0, 1] -> (N, L*F) in
    encode_dtype, level-major. On a CUDA tensor one launch of
    nmr_hash_encode (none for N = 0): L <= 32, F in (1, 2, 4, 8), S at
    least every level's hashmap size, the table 16-byte aligned. count:
    None, or one int32 on the device: only the rows below it are read and
    written (N then bounds it, and sizes the launch); out: the (N, L*F)
    output to write, or None for a new one. The rows of out at and above
    the count are left as they were."""
    dev = _check_encode("hash_encode", table, pos, config, encode_dtype)
    L, F = config.n_levels, config.n_features_per_level
    n = pos.shape[0]
    out = _rows_out("hash_encode", count, out, n, L * F, encode_dtype, dev)
    if dev.type == "cpu":
        return _plain_rows(lambda x: hash_encode_reference(
            table, x, config, encode_dtype), count, out, n, pos)
    if n:
        params = _encode_params(config, table.shape[1],
                                encode_dtype == torch.bfloat16)
        _launch("hash_encode", load_library().nmr_hash_encode, dev, params,
                n, table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                _ptr(count))
    return out


def hash_encode_backward(table, pos, grad, config: NGPConfig,
                         encode_dtype=torch.float32, need_pos: bool = False):
    """The gradient of hash_encode's output `grad` (N, L*F) in
    encode_dtype -> (grad_table (L, S, F) f32, grad_pos (N, 3) f32 or
    None), as hash_encode_backward_reference; takes what hash_encode
    takes. On a CUDA tensor one launch of nmr_hash_encode_backward (none
    for N = 0) into a zeroed grad_table: its rows are added to with
    atomic adds, in no fixed order."""
    dev = _check_encode("hash_encode_backward", table, pos, config,
                        encode_dtype)
    L, F = config.n_levels, config.n_features_per_level
    _check("grad", grad, (encode_dtype,), (pos.shape[0], L * F), dev)
    if dev.type == "cpu":
        return hash_encode_backward_reference(table, pos, grad, config,
                                              encode_dtype, need_pos)
    n = pos.shape[0]
    grad_table = torch.zeros_like(table)
    grad_pos = (torch.empty((n, 3), dtype=torch.float32, device=dev)
                if need_pos else None)
    if n:
        params = _encode_params(config, table.shape[1],
                                encode_dtype == torch.bfloat16)
        _launch("hash_encode_backward",
                load_library().nmr_hash_encode_backward, dev, params, n,
                table.data_ptr(), pos.data_ptr(), grad.data_ptr(),
                grad_table.data_ptr(),
                None if grad_pos is None else grad_pos.data_ptr())
    return grad_table, grad_pos


class HashEncode(torch.autograd.Function):
    """The hash encode as autograd sees it: HashEncode.apply(table, pos,
    config, encode_dtype) -> hash_encode's (N, L*F) features; its
    backward is hash_encode_backward (on CUDA tensors the kernels
    nmr_hash_encode and nmr_hash_encode_backward, on CPU tensors their
    plain versions), the positions' gradient only where pos requires
    grad."""

    @staticmethod
    def forward(ctx, table, pos, config, encode_dtype):
        ctx.save_for_backward(table, pos)
        ctx.config, ctx.encode_dtype = config, encode_dtype
        return hash_encode(table, pos, config, encode_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        table, pos = ctx.saved_tensors
        grad_table, grad_pos = hash_encode_backward(
            table, pos, grad.contiguous(), ctx.config, ctx.encode_dtype,
            ctx.needs_input_grad[1])
        return (grad_table if ctx.needs_input_grad[0] else None, grad_pos,
                None, None)


def _mlp_params(name, weights, n_in, dev, compute_dtype, **kw) -> MlpParams:
    """The layer widths and weight pointers of `weights` ((n_out, n_in)
    f32 contiguous each on dev, chained from n_in, hidden widths <=
    MAX_HIDDEN) or ValueError."""
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"{name}: {len(weights)} layers (1-{MAX_LAYERS})")
    widths = [n_in]
    for k, w in enumerate(weights):
        _check(f"{name} weight {k}", w, (torch.float32,), (None, widths[-1]),
               dev)
        widths.append(w.shape[0])
    if max(widths[1:]) > MAX_HIDDEN:
        raise ValueError(f"{name}: widths {widths} (at most {MAX_HIDDEN} "
                         f"past the input)")
    p = MlpParams(n_layers=len(weights),
                  round_bf16=int(compute_dtype == torch.bfloat16), **kw)
    p.width[:len(widths)] = widths
    p.w[:len(weights)] = [w.data_ptr() for w in weights]
    return p


def mlp(x, weights, compute_dtype=torch.bfloat16, count=None, out=None):
    """x (N, n_in) f32 or bf16 -> (N, n_out) f32, as mlp_apply: weights
    (n_out, n_in) f32, ReLU between layers, hidden widths <= 128. On a
    CUDA tensor one launch of nmr_mlp (none for N = 0); a shape whose
    tiles overflow a block's shared memory raises RuntimeError. count and
    out as in hash_encode."""
    dev = _device("mlp", x)
    _dtype("mlp", compute_dtype)
    _check("x", x, DTYPES, (None, None), dev)
    params = _mlp_params("mlp", weights, x.shape[1], dev, compute_dtype,
                         x_bf16=int(x.dtype == torch.bfloat16),
                         n_store=weights[-1].shape[0])
    n = x.shape[0]
    out = _rows_out("mlp", count, out, n, params.n_store, torch.float32,
                    dev)
    if dev.type == "cpu":
        return _plain_rows(lambda r: mlp_reference(r, weights, compute_dtype),
                           count, out, n, x)
    if n:
        _launch("mlp", load_library().nmr_mlp, dev, params, n, x.data_ptr(),
                out.data_ptr(), _ptr(count))
    return out


def encode_mlp(table, pos, weights, config: NGPConfig,
               compute_dtype=torch.bfloat16, encode_dtype=torch.float32,
               count=None, out=None):
    """table (L, S, F) f32, pos (N, 3) f32 in [0, 1], the density MLP's
    weights (first input width L*F) -> (N, n_out) f32, as
    encode_mlp_reference: hash_encode in encode_dtype then mlp at the
    bf16 compute dtype (the f32 compute dtype takes the two wrappers).
    Takes what hash_encode and mlp take, count and out too; on a CUDA
    tensor one launch of nmr_encode_mlp (none for N = 0)."""
    dev = _check_encode("encode_mlp", table, pos, config, encode_dtype)
    if _dtype("encode_mlp", compute_dtype) != torch.bfloat16:
        raise ValueError("encode_mlp: the fused kernel runs the bf16 "
                         "compute dtype (f32 takes hash_encode and mlp)")
    params = _mlp_params("encode_mlp", weights, config.n_pos_features, dev,
                         compute_dtype, n_store=weights[-1].shape[0])
    n = pos.shape[0]
    out = _rows_out("encode_mlp", count, out, n, params.n_store,
                    torch.float32, dev)
    if dev.type == "cpu":
        return _plain_rows(lambda x: encode_mlp_reference(
            table, x, weights, config, compute_dtype, encode_dtype),
            count, out, n, pos)
    if n:
        enc = _encode_params(config, table.shape[1],
                             encode_dtype == torch.bfloat16)
        _launch("encode_mlp", load_library().nmr_encode_mlp, dev, enc,
                ctypes.byref(params), n, table.data_ptr(), pos.data_ptr(),
                out.data_ptr(), _ptr(count))
    return out


def rgb_head(feat, dir01, weights, config: NGPConfig,
             compute_dtype=torch.bfloat16, extra=None, count=None, out=None):
    """feat (N, density_out) f32, dir01 (N, 3) f32 warped to [0, 1],
    extra None or the codes (E,), (1, E) or (N, E) f32 with E =
    n_extra_learnable_dims -> rgb_raw (N, 3) f32, as rgb_head_reference.
    On a CUDA tensor one launch of nmr_rgb_head (none for N = 0). count
    and out as in hash_encode."""
    dev = _device("rgb_head", feat)
    _dtype("rgb_head", compute_dtype)
    n = feat.shape[0]
    _check("feat", feat, (torch.float32,), (None, None), dev)
    _check("dir01", dir01, (torch.float32,), (n, 3), dev)
    E = config.n_extra_learnable_dims
    rows = 0
    if extra is not None:
        if extra.dim() == 1:
            _check("extra", extra, (torch.float32,), (E,), dev)
        else:
            _check("extra", extra, (torch.float32,), (None, E), dev)
            if extra.shape[0] not in (1, n):
                raise ValueError(f"extra has {extra.shape[0]} rows for {n} "
                                 f"samples")
            rows = int(extra.shape[0] == n and n > 1)
    if not 1 <= config.sh_degree <= 4:
        raise ValueError(f"rgb_head: SH degree {config.sh_degree} (1-4)")
    if feat.shape[1] + config.sh_out_padded + E > config.rgb_in_width:
        raise ValueError(f"rgb_head: {feat.shape[1]} features + SH + {E} "
                         f"codes exceed rgb_in_width {config.rgb_in_width}")
    params = _mlp_params("rgb_head", weights, config.rgb_in_width, dev,
                         compute_dtype, n_store=3, n_feat=feat.shape[1],
                         sh_degree=config.sh_degree,
                         n_extra=0 if extra is None else E, extra_rows=rows)
    out = _rows_out("rgb_head", count, out, n, 3, torch.float32, dev)
    if dev.type == "cpu":
        return _plain_rows(lambda f, d, e: rgb_head_reference(
            f, d, weights, config, compute_dtype, e),
            count, out, n, feat, dir01, extra)
    if n:
        _launch("rgb_head", load_library().nmr_rgb_head, dev, params, n,
                feat.data_ptr(), dir01.data_ptr(),
                None if extra is None else extra.data_ptr(), out.data_ptr(),
                _ptr(count))
    return out


# ---------------------------------------------------------------------------
# The contract
# ---------------------------------------------------------------------------

def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (f32): 2^(e - 7) for |x| in
    [2^e, 2^(e+1)); the subnormal spacing 2^-133 at 0."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.clamp(e - 8, min=-133))


def compare_with_plain(kind: str, out_k, out_p, dtype) -> dict:
    """A kernel's output against its plain version's on the same inputs
    -> counts, the worst difference and `ok` under the contract.

    kind "encode" (dtype the encode dtype): every value to rtol 1e-5 /
    atol 1e-6 at f32, within one bf16 ulp of the larger magnitude at
    bf16. kind "mlp" or "rgb" (dtype the compute dtype): every value to
    1e-4 x max(1, |ref|) at f32; at bf16, at most 1e-5 of the rows
    (rounded down) hold a value more than 2e-2 from the plain one, and no
    value is more than 8e-2 from it. Any NaN fails."""
    if kind not in ("encode", "mlp", "rgb"):
        raise ValueError(f"compare_with_plain: unknown kind {kind!r}")
    k, p = out_k.float(), out_p.float()
    if k.shape != p.shape:
        raise ValueError(f"shapes differ: {tuple(k.shape)} vs {tuple(p.shape)}")
    rows = k.shape[0]
    nan = int(torch.isnan(k).sum()) + int(torch.isnan(p).sum())
    diff = (k - p).abs()
    if kind == "encode":
        if dtype == torch.bfloat16:
            tol = bf16_ulp(torch.maximum(k.abs(), p.abs()))
        else:
            tol = ENCODE_ATOL + ENCODE_RTOL * p.abs()
        allowed = 0
    elif dtype == torch.bfloat16:
        tol = torch.full_like(p, MLP_BF16_ATOL)
        allowed = math.floor(MLP_BF16_ROW_SHARE * rows)
    else:
        tol = MLP_F32_REL * torch.clamp(p.abs(), min=1.0)
        allowed = 0
    bad_rows = int((diff > tol).reshape(rows, -1).any(dim=1).sum()) if rows else 0
    err = float(diff.max()) if diff.numel() else 0.0
    capped = kind == "encode" or dtype != torch.bfloat16 or err <= MLP_BF16_CAP
    return {"rows": rows, "mismatched_rows": bad_rows, "allowed": allowed,
            "max_abs_err": err, "nan": nan,
            "ok": nan == 0 and bad_rows <= allowed and capped}


def compare_gradients(out_k, out_p) -> dict:
    """hash_encode_backward's outputs (grad_table, grad_pos or None)
    against its plain version's on the same inputs -> the worst
    differences, each over the plain gradient's largest magnitude, and
    `ok`: both within GRAD_REL, no NaN."""
    res = {"ok": True}
    for name, k, p in zip(("table", "pos"), out_k, out_p):
        if p is None:
            continue
        scale = float(p.abs().max()) if p.numel() else 0.0
        err = float((k - p).abs().max()) if p.numel() else 0.0
        nan = int(torch.isnan(k).sum()) + int(torch.isnan(p).sum())
        rel = err / scale if scale > 0.0 else err
        res[name] = {"max_abs_err": err, "max_abs": scale, "rel": rel,
                     "nan": nan}
        res["ok"] &= nan == 0 and rel <= GRAD_REL
    return res


def bf16_step_bound(rows, weights) -> torch.Tensor:
    """The most each output of mlp_apply at bf16 compute may move when
    every hidden activation rounds to the neighbouring bf16 value (what
    another order or precision of the f32 sums does at a rounding
    midpoint), from the plain version's own activations: each layer's
    step carried through |W| (ReLU moves nothing further), plus 1e-5 x
    max(1, |out|) for the last f32 sum. rows (N, K) as the MLP's input
    (rgb_row for the rgb head) -> (N, n_out) f32. A bf16 step of an
    activation of 4 or more is 2^-5 or more, past the contract's fixed
    2e-2 where a weight near 1 carries it to an output; this bound grows
    with the activations."""
    h = rows.float().to(torch.bfloat16).float()
    err = torch.zeros_like(h)
    for w in weights[:-1]:
        wb = w.to(torch.bfloat16).float()
        pre = torch.relu(h @ wb.T)
        err = err @ wb.abs().T + bf16_ulp(pre)
        h = pre.to(torch.bfloat16).float()
    wb = weights[-1].to(torch.bfloat16).float()
    return err @ wb.abs().T + 1e-5 * torch.clamp((h @ wb.T).abs(), min=1.0)


# ---------------------------------------------------------------------------
# Work counts for the bounds
# ---------------------------------------------------------------------------

def encode_work(table, pos, config: NGPConfig, encode_dtype=torch.float32):
    """The encode's least work on these inputs -> (flops, bytes): per
    (sample, level) ~30 flops of coordinates and weights plus 16F of the
    weighted sum; bytes: pos read once, the output written once, and each
    table row these positions touch read once (counted per level)."""
    L, F = config.n_levels, config.n_features_per_level
    scales, res, sizes, dense = level_constants(config)
    n = pos.shape[0]
    rows = 0
    for lvl in range(L):
        idx, _ = corner_indices_and_weights(pos, float(scales[lvl]),
                                            int(res[lvl]), int(sizes[lvl]),
                                            bool(dense[lvl]))
        rows += int(torch.unique(idx).numel())
    out_b = n * L * F * (2 if encode_dtype == torch.bfloat16 else 4)
    return n * L * (30 + 16 * F), n * 12 + out_b + rows * F * 4


def encode_backward_work(table, pos, config: NGPConfig,
                         encode_dtype=torch.float32, need_pos=False):
    """The encode backward's least work on these inputs -> (flops, bytes):
    per (sample, level) encode_work's ~30 flops of coordinates and
    weights and 8F products and adds of w_c * g, with the positions'
    gradient also 16F for the weights' gradient and ~60 for their
    derivative; bytes: pos and the output's gradient read once, each
    table row these positions touch written once (counted once however
    many samples add to it), with the positions' gradient those rows read
    once and (N, 3) f32 written."""
    L, F = config.n_levels, config.n_features_per_level
    _, fwd_bytes = encode_work(table, pos, config, encode_dtype)
    n = pos.shape[0]
    out_b = n * L * F * (2 if encode_dtype == torch.bfloat16 else 4)
    touched = fwd_bytes - n * 12 - out_b
    flops = n * L * (30 + 16 * F + ((16 * F + 60) if need_pos else 0))
    return (flops, n * 12 + out_b + touched * (2 if need_pos else 1)
            + (n * 12 if need_pos else 0))


def encode_mlp_work(table, pos, weights, config: NGPConfig,
                    compute_dtype=torch.bfloat16, encode_dtype=torch.float32):
    """The fused encode + density MLP's least work on these inputs
    (encode_mlp's arguments) -> (flops, bytes): encode_work's operations
    and the MLP's (2 per
    multiply-add); bytes: pos and the table rows these positions touch
    read once (encode_work's count without its output), the weights read
    once, the (N, n_out) f32 output written once. The (N, L*F)
    intermediate is not moved."""
    e_flops, e_bytes = encode_work(table, pos, config, encode_dtype)
    n = pos.shape[0]
    enc_out = n * config.n_levels * config.n_features_per_level * (
        2 if encode_dtype == torch.bfloat16 else 4)
    macs = sum(w.shape[0] * w.shape[1] for w in weights)
    return (e_flops + 2 * n * macs,
            e_bytes - enc_out + 4 * macs + 4 * n * weights[-1].shape[0])


SECTOR = 32     # bytes: the unit of an L2 request


def encode_gather_sectors(table, pos, config: NGPConfig):
    """The 32-byte L2 sectors the two encode kernels' gathers request a
    (sample, level) on these inputs, counted from the corner indices as
    encode_work counts rows -> (nmr_hash_encode's, nmr_encode_mlp's).
    Each corner is one load a thread; a warp's load requests each
    distinct sector its 32 lanes touch once. nmr_hash_encode: a warp is
    32 consecutive items s * L + l (32 / L samples on every level).
    nmr_encode_mlp: a warp is 32 consecutive samples on one level. The
    table is taken as 32-byte aligned, as PyTorch allocates it."""
    L, F = config.n_levels, config.n_features_per_level
    scales, res, sizes, dense = _levels(config)
    n, rows = pos.shape[0], table.shape[1]
    if n == 0:
        return 0.0, 0.0
    span = (L * rows * F * 4) // SECTOR + 1
    s = torch.arange(n, device=pos.device)
    per_corner = [[] for _ in range(8)]
    fused = 0
    for lvl in range(L):
        idx, _ = corner_indices_and_weights(pos, float(scales[lvl]),
                                            int(res[lvl]), int(sizes[lvl]),
                                            bool(dense[lvl]))
        sec = ((lvl * rows + idx) * (F * 4)) // SECTOR
        item_warp = ((s * L + lvl) // 32) * span
        level_warp = (s // 32) * span
        for c in range(8):
            per_corner[c].append(item_warp + sec[:, c])
            fused += int(torch.unique(level_warp + sec[:, c]).numel())
    standalone = sum(int(torch.unique(torch.cat(k)).numel())
                     for k in per_corner)
    return standalone / (n * L), fused / (n * L)


def mlp_work(x, weights):
    """-> (flops, bytes): 2 per multiply-add; the input rows, the weights
    and the f32 output each moved once."""
    macs = sum(w.shape[0] * w.shape[1] for w in weights)
    n = x.shape[0]
    return (2 * n * macs,
            n * x.shape[1] * x.element_size() + 4 * macs
            + 4 * n * weights[-1].shape[0])


def rgb_head_work(feat, dir01, weights, extra=None):
    """-> (flops, bytes): the rgb MLP's multiply-adds (2 each) that reach
    the output, the last layer's 3 stored columns of its 16, and ~60 SH
    flops a sample; feat, dir01, the codes, those weights read once and
    the (N, 3) f32 output written once."""
    macs = (sum(w.shape[0] * w.shape[1] for w in weights[:-1])
            + 3 * weights[-1].shape[1])
    n = feat.shape[0]
    codes = 0 if extra is None else extra.numel() * 4
    return (n * (2 * macs + 60),
            n * (feat.shape[1] * 4 + 12 + 12) + 4 * macs + codes)
