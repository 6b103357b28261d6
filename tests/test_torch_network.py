"""Network parity: hash encode, SH, MLP and the composite network of the
PyTorch port against the JAX package, on the same numpy inputs.

Tolerances: corner indices are integer arithmetic and must be equal;
float32 results differ only in summation order (the 8-corner sum, the
matmul), so they are held to rtol 1e-5 / atol 1e-6 per value, 1e-4 after
an MLP. bf16 paths round hidden activations to bf16: an f32 sum that
lands one ulp apart can round to the neighbouring bf16 value, so they
are held to 2e-2 absolute.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.io import snapshot as jsnap
from nerf_glasses_tpu.ops import hashgrid as jhash
from nerf_glasses_tpu.ops import network as jnet
from nerf_glasses_tpu.ops.mlp import mlp_apply as jmlp
from nerf_glasses_tpu.ops.sh import sh_encode as jsh
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.ops import hashgrid as thash
from nerf_glasses_tpu_torch.ops import network as tnet
from nerf_glasses_tpu_torch.ops.mlp import mlp_apply as tmlp
from nerf_glasses_tpu_torch.ops.sh import sh_encode as tsh
from tests.helpers import TEST_CFG

torch.set_num_threads(1)

TRAINED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "trained", "trained_head_v6.msgpack")
CONFIGS = {"native_fast": JCfg.native_fast(), "test_cfg": TEST_CFG}


def _tcfg(jc):
    return TCfg(**{f: getattr(jc, f) for f in TCfg.__dataclass_fields__})


def _positions(n=512, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    pos[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0.25],
               [0.999, 0.001, 0.5], [0.25, 0.75, 1.0], [0.0, 1.0, 0.0],
               [0.123, 0.456, 0.789]]
    return pos


@pytest.mark.parametrize("name", list(CONFIGS))
def test_corner_indices_exact(name):
    jc = CONFIGS[name]
    tc = _tcfg(jc)
    pos = _positions()
    scales, res, sizes, dense = jhash.level_constants(jc)
    ts, tr, tz, td = thash.level_constants(tc)
    np.testing.assert_array_equal(scales, ts)
    np.testing.assert_array_equal(dense, td)
    for lvl in range(jc.n_levels):
        args = (float(scales[lvl]), int(res[lvl]), int(sizes[lvl]),
                bool(dense[lvl]))
        ji, jw = jhash.corner_indices_and_weights(jnp.asarray(pos), *args)
        ti, tw = thash.corner_indices_and_weights(torch.as_tensor(pos), *args)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hash_encode(name):
    jc = CONFIGS[name]
    rng = np.random.default_rng(1)
    table = rng.standard_normal(
        (jc.n_levels, jhash.padded_table_rows(jc), jc.n_features_per_level)
    ).astype(np.float32)
    pos = _positions(seed=2)
    out_j = np.asarray(jhash.hash_encode(jnp.asarray(table), jnp.asarray(pos), jc))
    out_t = thash.hash_encode(torch.as_tensor(table), torch.as_tensor(pos),
                              _tcfg(jc)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)


def test_sh_encode():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((256, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    d01 = ((v + 1) / 2).astype(np.float32)
    np.testing.assert_allclose(tsh(torch.as_tensor(d01), 4, 16).numpy(),
                               np.asarray(jsh(jnp.asarray(d01), 4, 16)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 32)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((64, 32), (64, 64), (16, 64))]
    out_j = np.asarray(jmlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                            compute_dtype=getattr(jnp, dtype)))
    out_t = tmlp(torch.as_tensor(x), [torch.as_tensor(w) for w in ws],
                 compute_dtype=getattr(torch, dtype)).numpy()
    assert out_t.dtype == np.float32
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out_t, out_j, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_network_trained(dtype):
    s = jsnap.load_snapshot(TRAINED)
    jp = jnet.unpack_params(s.params_blob, s.config)
    net = tnet.params_from_jax(
        {k: (tuple(np.asarray(w) for w in v) if isinstance(v, tuple)
             else np.asarray(v)) for k, v in jp.items()}, _tcfg(s.config))
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.25, 0.75, (1024, 3)).astype(np.float32)
    d = rng.standard_normal((1024, 3))
    dir01 = ((d / np.linalg.norm(d, axis=1, keepdims=True) + 1) / 2
             ).astype(np.float32)
    rgb_j, sig_j = jnet.apply_network(jp, jnp.asarray(pos), jnp.asarray(dir01),
                                      s.config, compute_dtype=getattr(jnp, dtype))
    rgb_t, sig_t = net(torch.as_tensor(pos), torch.as_tensor(dir01),
                       compute_dtype=getattr(torch, dtype))
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=tol,
                               rtol=tol)
    d_j = np.asarray(jnet.density_raw(jp, jnp.asarray(pos), s.config,
                                      compute_dtype=jnp.float32))
    d_t = net.density_raw(torch.as_tensor(pos), compute_dtype=torch.float32)
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["exponential", "logistic", "relu", "none"])
def test_activations(kind):
    x = np.linspace(-12, 12, 97).astype(np.float32)
    np.testing.assert_allclose(
        tnet.apply_density_activation(torch.as_tensor(x), kind).numpy(),
        np.asarray(jnet.apply_density_activation(jnp.asarray(x), kind)),
        rtol=1e-6)
    np.testing.assert_allclose(
        tnet.apply_rgb_activation(torch.as_tensor(x), kind).numpy(),
        np.asarray(jnet.apply_rgb_activation(jnp.asarray(x), kind)),
        rtol=1e-6)
