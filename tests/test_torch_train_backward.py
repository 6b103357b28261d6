"""The training step's MLP backwards, its Adam update and its replayed
CUDA graph: ops/network_cuda.py (mlp_backward, rgb_head_backward, Mlp,
RgbHead: nmr_mlp_backward and nmr_rgb_head_backward in csrc/network.cu),
ops/adam_cuda.py (adam: nmr_adam in csrc/adam.cu) and train/trainer.py
(adam_update, draw_step_into, the in-place step, Trainer's step graph).

- The plain backwards equal autograd of mlp_apply / rgb_head_reference
  bit for bit (native_fast's and NGPConfig()'s widths, with and without
  8 latent dims, f32 and bf16 compute, f32 and bf16 input rows), and
  match JAX's jax.vjp of mlp_apply and network._rgb_head: to 1e-5 of each
  array's largest magnitude at f32, and at bf16 also one bf16 step of
  the value (network_cuda.compare_backward: the same rounding points,
  the f32 sums in another order).
- Mlp and RgbHead on CPU tensors give autograd's gradients bit for bit
  and launch nothing.
- adam_reference is the trainer's former aten update bit for bit and
  matches JAX's adam_update to 1e-6 of each array's largest magnitude
  (JAX takes lr * corr * m in another order); adam_update on the CPU is
  adam_reference. On the card nmr_adam is the card's plain version bit
  for bit; against the CPU's, whose sqrt (MKL's) is off by an ulp on
  some values, the moments are equal and the parameters within 1e-6.
- draw_step_into gives draw_step's draws bit for bit.
- The in-place step still matches the JAX step
  (test_torch_train.assert_step_matches), and the CPU trainer's losses
  and parameters are the per-step loop's bit for bit.
- Marked `cuda` (skipped without a card; on the card `JAX_PLATFORMS=cpu
  python -m pytest tests/test_torch_train_backward.py -m cuda -q`): each
  kernel against its plain version (compare_backward on the rows no
  ReLU rounding decides; nmr_adam bit for bit), the trainer's forward
  through the kernels with plain_on_card 0, and a replayed step against
  eager steps on the same draws.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_glasses_tpu.config import NGPConfig as JCfg
from nerf_glasses_tpu.ops import mlp as jmlp
from nerf_glasses_tpu.ops import network as jnet
from nerf_glasses_tpu.train import trainer as jtr
from nerf_glasses_tpu_torch.config import NGPConfig as TCfg
from nerf_glasses_tpu_torch.io.dataset import ImageMetadata, NerfDataset
from nerf_glasses_tpu_torch.ops import adam_cuda as ac
from nerf_glasses_tpu_torch.ops import network_cuda as nc
from nerf_glasses_tpu_torch.ops.mlp import mlp_apply
from nerf_glasses_tpu_torch.ops.network import init_params
from nerf_glasses_tpu_torch.parallel.sharding import state_tensors
from nerf_glasses_tpu_torch.train import trainer as ttr

torch.set_num_threads(1)

F32 = np.float32
CFGS = {"native_fast": TCfg.native_fast(), "default": TCfg()}
CDS = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(t):
    return t.detach().float().contiguous().view(torch.int32)


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")


def _mlp_inputs(cfg, n, seed, x_dtype=torch.float32, scale=1e-3):
    """A trained-looking density MLP (the config's init drawn from a seed),
    rows of encode features in [-1, 1] and an output gradient."""
    net = init_params(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, cfg.n_pos_features))
                         .astype(F32)).to(x_dtype)
    g = torch.from_numpy((rng.standard_normal(
        (n, net.density_mlp[-1].shape[0])) * scale).astype(F32))
    return [w.detach() for w in net.density_mlp], x, g


def _rgb_inputs(cfg, n, seed, extra="none"):
    """The rgb MLP of the config's init, density features, directions in
    [0, 1], codes (none, one row (E,), or a row a sample) and the (N, 3)
    output gradient."""
    net = init_params(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)

    def t(a):
        return torch.from_numpy(np.asarray(a, F32))

    feat = t(rng.standard_normal((n, net.density_mlp[-1].shape[0])))
    d = t(rng.uniform(0, 1, (n, 3)))
    E = cfg.n_extra_learnable_dims
    codes = {"none": None, "vec": t(rng.uniform(-0.5, 0.5, (E,))),
             "rows": t(rng.uniform(-0.5, 0.5, (n, E)))}[extra]
    g = t(rng.standard_normal((n, 3)) * 1e-3)
    return [w.detach() for w in net.rgb_mlp], feat, d, codes, g


def _cfg(name, extra_dims=0):
    return dataclasses.replace(CFGS[name], n_extra_learnable_dims=extra_dims)


RGB_CASES = {"native_fast": ("native_fast", 0, "none"),
             "native_fast_codes": ("native_fast", 8, "rows"),
             "native_fast_one_code": ("native_fast", 8, "vec"),
             "default": ("default", 0, "none"),
             "default_codes": ("default", 8, "rows")}


# ---------------------------------------------------------------------------
# The plain backwards against autograd and JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cd", list(CDS))
@pytest.mark.parametrize("cfg", list(CFGS))
def test_mlp_backward_reference_is_autograd(cfg, cd, x_dtype):
    td = CDS[cd][0]
    ws, x, g = _mlp_inputs(CFGS[cfg], 257, 1, CDS[x_dtype][0])
    xs = x.clone().requires_grad_(True)
    wr = [w.clone().requires_grad_(True) for w in ws]
    want = torch.autograd.grad(mlp_apply(xs, wr, compute_dtype=td),
                               [xs] + wr, g)
    dx, dws = nc.mlp_backward_reference(x, ws, g, td)
    assert all(_same(a, b) for a, b in zip([dx] + dws, want))
    dx0, dws0 = nc.mlp_backward_reference(x, ws, g, td, need_x=False)
    assert dx0 is None and all(_same(a, b) for a, b in zip(dws0, dws))


@pytest.mark.parametrize("cd", list(CDS))
@pytest.mark.parametrize("case", list(RGB_CASES))
def test_rgb_head_backward_reference_is_autograd(case, cd):
    name, E, extra = RGB_CASES[case]
    cfg, td = _cfg(name, E), CDS[cd][0]
    ws, feat, d, codes, g = _rgb_inputs(cfg, 129, 2, extra)
    fs = feat.clone().requires_grad_(True)
    ds = d.clone().requires_grad_(True)
    wr = [w.clone().requires_grad_(True) for w in ws]
    es = None if codes is None else codes.clone().requires_grad_(True)
    inputs = [fs, ds] + wr + ([] if es is None else [es])
    out = nc.rgb_head_reference(fs, ds, wr, cfg, td, es)
    want = torch.autograd.grad(out, inputs, g)
    d_feat, d_dir, d_extra, dws = nc.rgb_head_backward_reference(
        feat, d, ws, cfg, g, td, codes, True, codes is not None, True)
    got = [d_feat, d_dir] + dws + ([] if codes is None else [d_extra])
    assert all(_same(a, b) for a, b in zip(got, want))
    # without the directions' gradient: the rest unchanged
    d_feat0, d_dir0, _, dws0 = nc.rgb_head_backward_reference(
        feat, d, ws, cfg, g, td, codes, True, codes is not None)
    assert d_dir0 is None and _same(d_feat0, d_feat)
    assert all(_same(a, b) for a, b in zip(dws0, dws))


def _np(t):
    return np.asarray(t.detach().float().numpy())


def _close_to_jax(got, want, cd):
    r = nc.compare_backward([got], [[torch.from_numpy(np.array(
        w, F32)) for w in want]], CDS[cd][0])
    assert r["ok"], r


@pytest.mark.parametrize("cd", list(CDS))
@pytest.mark.parametrize("cfg", list(CFGS))
def test_mlp_backward_reference_matches_jax_vjp(cfg, cd):
    td, jd = CDS[cd]
    ws, x, g = _mlp_inputs(CFGS[cfg], 300, 3)
    out, vjp = jax.vjp(lambda xx, *w: jmlp.mlp_apply(xx, w, compute_dtype=jd),
                       jnp.asarray(_np(x)), *[jnp.asarray(_np(w)) for w in ws])
    want = vjp(jnp.asarray(_np(g)))
    dx, dws = nc.mlp_backward_reference(x, ws, g, td)
    _close_to_jax([dx] + dws, want, cd)


@pytest.mark.parametrize("cd", list(CDS))
@pytest.mark.parametrize("case", ["native_fast", "native_fast_codes",
                                  "default"])
def test_rgb_head_backward_reference_matches_jax_vjp(case, cd):
    name, E, extra = RGB_CASES[case]
    cfg, (td, jd) = _cfg(name, E), CDS[cd]
    jc = JCfg(**{f: getattr(cfg, f) for f in JCfg.__dataclass_fields__
                 if hasattr(cfg, f)})
    ws, feat, d, codes, g = _rgb_inputs(cfg, 300, 4, extra)

    def head(f, dd, e, *w):
        return jnet._rgb_head({"rgb_mlp": w}, f, dd[:, 0], dd[:, 1], dd[:, 2],
                              jc, jd, e)[..., :3].astype(jnp.float32)

    e0 = None if codes is None else jnp.asarray(_np(codes))
    out, vjp = jax.vjp(head, jnp.asarray(_np(feat)), jnp.asarray(_np(d)), e0,
                       *[jnp.asarray(_np(w)) for w in ws])
    jf, jdir, je, *jw = vjp(jnp.asarray(_np(g)))
    d_feat, d_dir, d_extra, dws = nc.rgb_head_backward_reference(
        feat, d, ws, cfg, g, td, codes, True, codes is not None, True)
    _close_to_jax([d_feat, d_dir] + dws, [jf, jdir] + jw, cd)
    if codes is not None:
        _close_to_jax([d_extra], [je], cd)


# ---------------------------------------------------------------------------
# The autograd Functions on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cd", list(CDS))
def test_mlp_function_on_cpu_is_autograd(cd):
    td = CDS[cd][0]
    ws, x, g = _mlp_inputs(CFGS["native_fast"], 200, 5, torch.bfloat16)
    before = dict(nc.launches)
    xs = x.clone().requires_grad_(True)
    wr = [w.clone().requires_grad_(True) for w in ws]
    out = nc.Mlp.apply(xs, td, *wr)
    assert _same(out, mlp_apply(x, ws, compute_dtype=td))
    got = torch.autograd.grad(out, [xs] + wr, g)
    xs2 = x.clone().requires_grad_(True)
    wr2 = [w.clone().requires_grad_(True) for w in ws]
    want = torch.autograd.grad(mlp_apply(xs2, wr2, compute_dtype=td),
                               [xs2] + wr2, g)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert nc.launches == before


@pytest.mark.parametrize("case", ["native_fast", "native_fast_codes",
                                  "native_fast_one_code"])
def test_rgb_head_function_on_cpu_is_autograd(case):
    name, E, extra = RGB_CASES[case]
    cfg = _cfg(name, E)
    ws, feat, d, codes, g = _rgb_inputs(cfg, 90, 6, extra)
    before = dict(nc.launches)

    def grads(fn):
        fs = feat.clone().requires_grad_(True)
        ds = d.clone().requires_grad_(True)
        wr = [w.clone().requires_grad_(True) for w in ws]
        es = None if codes is None else codes.clone().requires_grad_(True)
        out = fn(fs, ds, wr, es)
        inputs = [fs, ds] + wr + ([] if es is None else [es])
        return out, torch.autograd.grad(out, inputs, g)

    out, got = grads(lambda f, dd, w, e: nc.RgbHead.apply(
        f, dd, e, cfg, torch.bfloat16, *w))
    ref, want = grads(lambda f, dd, w, e: nc.rgb_head_reference(
        f, dd, w, cfg, torch.bfloat16, e))
    assert _same(out, ref)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert nc.launches == before


def test_backward_wrappers_validation_and_contract():
    ws, x, g = _mlp_inputs(CFGS["native_fast"], 20, 7)
    with pytest.raises(ValueError, match="grad must"):
        nc.mlp_backward(x, ws, g[:, :3])
    with pytest.raises(ValueError, match="grad must"):
        nc.mlp_backward(x, ws, g.double())
    cfg = _cfg("native_fast")
    rws, feat, d, _, rg = _rgb_inputs(cfg, 20, 7)
    with pytest.raises(ValueError, match="grad must"):
        nc.rgb_head_backward(feat, d, rws, cfg, rg[:5])
    with pytest.raises(ValueError, match="need_extra"):
        nc.rgb_head_backward(feat, d, rws, cfg, rg, need_extra=True)
    with pytest.raises(ValueError, match="groups of 16"):
        nc.rgb_head_backward(feat[:, :8].contiguous(), d, rws, cfg, rg,
                             need_dir=True)
    out = nc.mlp_backward(x, ws, g)
    r = nc.compare_backward(out, out, torch.bfloat16)
    assert r["ok"] and r["max_abs_err"] == 0.0 and len(r["arrays"]) == 3
    bad = (out[0], [out[1][0], out[1][1] + 2e-5 * out[1][1].abs().max()])
    assert not nc.compare_backward(bad, out, torch.float32)["ok"]
    # one bf16 step of the value passes at bf16, not at f32
    step = (out[0], [out[1][0], out[1][1] + nc.bf16_ulp(out[1][1])])
    assert nc.compare_backward(step, out, torch.bfloat16)["ok"]
    assert not nc.compare_backward(step, out, torch.float32)["ok"]
    flops, nbytes, peak = nc.mlp_backward_work(x, ws)
    assert flops > 0 and nbytes > 20 * 64 and peak == 989e12
    flops, nbytes, peak = nc.rgb_head_backward_work(feat, d, rws,
                                                    torch.float32)
    assert flops > 0 and nbytes > 0 and peak == 67e12


def test_marginal_rows_find_pre_activations_at_zero():
    ws, x, _ = _mlp_inputs(CFGS["native_fast"], 40, 8)
    assert not nc.marginal_rows(x, ws, torch.float32).any()
    # row 5's first hidden pre-activation is made exactly zero
    w0 = ws[0].clone()
    x2 = x.clone()
    x2[5, 1] = 0.0
    w0[0, 1] = 0.0
    w0[0, 0] = -float(x2[5, 2:] @ w0[0, 2:]) / float(x2[5, 0])
    m = nc.marginal_rows(x2, [w0, ws[1]], torch.float32)
    assert bool(m[5])


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def _former_adam_update(net, grads, opt, step, opts):
    """The trainer's aten update before the kernel (train/trainer.py)."""
    b1, b2 = opts.beta1, opts.beta2
    lr_corr = float(np.float32(ttr._learning_rate(step, opts)
                               * ttr._adam_corr(step, opts)))
    with torch.no_grad():
        for name, p in net.named_parameters():
            g = grads[name]
            if name != "grid" and opts.l2_reg:
                g = g + opts.l2_reg * p
            m = opt["m"][name]
            v = opt["v"][name]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p.sub_(lr_corr * m / (torch.sqrt(v) + opts.eps))


def _adam_state(seed, cfg=None, device="cpu"):
    cfg = cfg or TCfg(n_levels=4, log2_hashmap_size=10, base_resolution=8)
    net = init_params(cfg, torch.Generator().manual_seed(seed)).to(device)
    rng = np.random.default_rng(seed)

    def like(p, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, tuple(p.shape))
                                .astype(F32)).to(device)

    grads = {n: like(p, -1e-3, 1e-3) for n, p in net.named_parameters()}
    opt = {"m": {n: like(p, -1e-4, 1e-4) for n, p in net.named_parameters()},
           "v": {n: like(p, 1e-9, 1e-7) for n, p in net.named_parameters()}}
    return net, grads, opt


@pytest.mark.parametrize("step", [0, 7, 1500])
def test_adam_update_is_the_former_aten_update(step):
    opts = ttr.TrainOptions(config=TCfg(), lr_decay=0.33,
                            lr_decay_interval=1000)
    a = _adam_state(9)
    b = _adam_state(9)
    before = dict(ac.launches)
    ttr.adam_update(a[0], a[1], a[2], step, opts)
    _former_adam_update(b[0], b[1], b[2], step, opts)
    for (name, p), q in zip(a[0].named_parameters(), b[0].parameters()):
        assert _same(p, q), name
    for k in ("m", "v"):
        for name in a[2][k]:
            assert _same(a[2][k][name], b[2][k][name])
    # the same through an lr_corr tensor
    c = _adam_state(9)
    ttr.adam_update(c[0], c[1], c[2], step, opts,
                    ttr.lr_tensor([step], opts, "cpu"))
    assert all(_same(p, q) for p, q in zip(c[0].parameters(),
                                            b[0].parameters()))
    assert ac.launches == before


def test_adam_matches_jax_adam_update():
    opts = ttr.TrainOptions(config=TCfg())
    jopts = jtr.TrainOptions(config=JCfg())
    net, grads, opt = _adam_state(10)
    jp = {"grid": _np(net.grid),
          "density_mlp": tuple(_np(w) for w in net.density_mlp),
          "rgb_mlp": tuple(_np(w) for w in net.rgb_mlp)}

    def tree(d):
        return {"grid": _np(d["grid"]),
                "density_mlp": tuple(_np(d[f"density_{i}"])
                                     for i in range(net.n_density)),
                "rgb_mlp": tuple(_np(d[f"rgb_{i}"])
                                 for i in range(net.n_rgb))}

    jm, jv, jg = tree(opt["m"]), tree(opt["v"]), tree(grads)
    out = jtr.adam_update(jax.tree.map(jnp.asarray, jp),
                          jax.tree.map(jnp.asarray, jg),
                          {"m": jax.tree.map(jnp.asarray, jm),
                           "v": jax.tree.map(jnp.asarray, jv)},
                          jnp.asarray(41), jopts)
    ttr.adam_update(net, grads, opt, 41, opts)
    new_p = out[0]
    pairs = [(net.grid, new_p["grid"])]
    pairs += list(zip(net.density_mlp, new_p["density_mlp"]))
    pairs += list(zip(net.rgb_mlp, new_p["rgb_mlp"]))
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_adam_wrapper_validation():
    net, grads, opt = _adam_state(11)
    ps = [p.detach() for p in net.parameters()]
    names = [n for n, _ in net.named_parameters()]
    gs = [grads[n] for n in names]
    ms = [opt["m"][n] for n in names]
    vs = [opt["v"][n] for n in names]
    lr = torch.tensor([1e-3])
    with pytest.raises(ValueError, match="lr_corr"):
        ac.adam(ps, gs, ms, vs, [0.0] * len(ps), lr.double(), 0.9, 0.99,
                1e-15)
    with pytest.raises(ValueError, match="grads must"):
        ac.adam(ps, [g[:1] for g in gs], ms, vs, [0.0] * len(ps), lr, 0.9,
                0.99, 1e-15)
    with pytest.raises(ValueError, match="parameters"):
        ac.adam(ps * 3, gs * 3, ms * 3, vs * 3, [0.0] * 3 * len(ps), lr,
                0.9, 0.99, 1e-15)
    assert ac.adam_work(ps) == (12 * sum(p.numel() for p in ps),
                                28 * sum(p.numel() for p in ps))
    assert ac.constants(0.9, 0.99, 1e-15)[1] == float(np.float32(1 - 0.9))


# ---------------------------------------------------------------------------
# The draws and the in-place step
# ---------------------------------------------------------------------------

def _dataset(n_img=2, w=24, seed=0):
    """Two noisy 24 x 24 images from cameras looking at the unit cube."""
    rng = np.random.default_rng(seed)
    ds = NerfDataset()
    ds.n_images = n_img
    ds.metadata = [ImageMetadata(resolution=(w, w), focal_length=(w, w),
                                 principal_point=(0.5, 0.5))
                   for _ in range(n_img)]
    xf = []
    for i in range(n_img):
        a = 0.4 * i
        rot = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                        [-math.sin(a), 0, math.cos(a)]])
        eye = 0.5 - 1.8 * rot[:, 2]
        xf.append(np.concatenate([rot, eye[:, None]], 1))
    ds.xforms = np.asarray(xf, F32)
    ds.xforms_end = ds.xforms.copy()
    ds.paths = [f"img_{i}" for i in range(n_img)]
    ds.images = [rng.uniform(0, 1, (w, w, 4)).astype(F32)
                 for _ in range(n_img)]
    return ds


def _opts(**kw):
    return ttr.TrainOptions(config=TCfg(n_levels=4, log2_hashmap_size=10,
                                        base_resolution=8), rays_per_batch=64,
                            samples_per_ray=16, **kw)


@pytest.mark.parametrize("error_map", [False, True])
@pytest.mark.parametrize("random_bg", [False, True])
def test_draws_in_place_are_draw_steps(error_map, random_bg):
    opts = _opts(random_bg=random_bg)
    data = ttr.prepare_dataset_arrays(_dataset(), "cpu")
    state = {"error_map": None} if error_map else {}
    a = ttr.draw_step(torch.Generator().manual_seed(12), state, data, opts)
    gen = torch.Generator().manual_seed(12)
    buf = ttr.step_draw_buffers(data, opts, error_map)
    for _ in range(2):              # the same buffers, drawn again
        b = ttr.draw_step_into(gen, buf, data)
    gen2 = torch.Generator().manual_seed(12)
    ttr.draw_step(gen2, state, data, opts)
    a2 = ttr.draw_step(gen2, state, data, opts)
    assert sorted(a) == sorted(b)
    assert all(_same(a2[k], b[k]) for k in a2)
    first = ttr.draw_step_into(torch.Generator().manual_seed(12),
                               ttr.step_draw_buffers(data, opts, error_map),
                               data)
    assert all(_same(a[k], first[k]) for k in a)


@pytest.fixture(scope="module")
def jax_setup():
    """test_torch_train's JAX trainer after 40 steps and its port state
    (its `setup` fixture's body; that module is imported here and not at
    the top, so that the `cuda` cases collect where its imports of the
    JAX package's tests do not resolve)."""
    import test_torch_train as ttt
    tr = jtr.Trainer(ttt.make_synth_dataset(n_images=2), ttt.JOPTS, seed=7)
    tr.train(40)
    state = tr.state
    net = ttt.tnet.params_from_jax(ttt._params_np(state["params"]),
                                   ttt._tcfg(ttt.TINY_CFG)).requires_grad_(True)
    tstate = {"net": net, "aux": {}, "aabb_min": ttt._t(state["aabb_min"]),
              "aabb_max": ttt._t(state["aabb_max"])}
    return ttt, (tr, tstate, {k: ttt._t(v) for k, v in tr.data.items()})


@pytest.mark.parametrize("fields", [[], ["latent_codes"]])
def test_in_place_step_matches_the_jax_step(jax_setup, fields):
    """One _train_step_body from the JAX package's state and draws (the
    plain step, and the step with latent codes through the rgb head's
    codes gradient) within test_torch_train's bars
    (assert_step_matches), the loss EMA written in place."""
    ttt, setup = jax_setup
    out = ttt.aux_step_pair(setup, fields)
    ttt.assert_step_matches(*out)
    assert float(out[2]["loss_ema"]) == pytest.approx(
        0.99 * float(setup[0].state["loss_ema"]) + 0.01 * float(out[3]))


def test_cpu_trainer_losses_are_the_per_step_loops():
    """The CPU trainer's chunk (one learning-rate tensor a chunk, the
    losses copied into one tensor) against the per-step module loop
    (train_chunk), from the same seed: losses, parameters, moments,
    the grid and the error map bit for bit; every state tensor kept in
    its storage."""
    a = ttr.Trainer(_dataset(), _opts(), seed=5, device="cpu")
    b = ttr.Trainer(_dataset(), _opts(), seed=5, device="cpu")
    for t in (a, b):
        t.occ_warmup_steps = 0
    ptrs = {n: t.data_ptr() for n, t in state_tensors(a.state)}
    a.train(18)
    losses = []
    step = 0
    while step < 18:
        n = min(16 - step % 16, 18 - step)
        o = b._chunk_opts(step)
        losses.append(ttr.train_chunk(b.state, b.data, o, n, step % 16 == 0,
                                      True, b._draws)[1])
        step += n
    want = torch.cat(losses)
    assert a.loss_history == [float(v) for v in want]
    for (n, x), (_, y) in zip(state_tensors(a.state), state_tensors(b.state)):
        assert _same(x, y) if x.dtype.is_floating_point else torch.equal(x, y)
    assert {n: t.data_ptr() for n, t in state_tensors(a.state)} == ptrs
    assert a.eager_steps == 18 and a.replayed_steps == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _on_card_mlp(cfg, n, cd, x_dtype, need_x):
    ws, x, g = _mlp_inputs(CFGS[cfg], n, 13, x_dtype)
    args = [x.cuda(), [w.cuda() for w in ws], g.cuda()]
    n0 = nc.launches["mlp_backward"]
    got = nc.mlp_backward(*args, cd, need_x)
    torch.cuda.synchronize()
    assert nc.launches["mlp_backward"] == n0 + 1
    keep = ~nc.marginal_rows(args[0], args[1], cd)
    if not bool(keep.all()):
        args = [args[0][keep], args[1], args[2][keep]]
        got = nc.mlp_backward(*args, cd, need_x)
    want = nc.mlp_backward_reference(*args, cd, need_x)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("need_x", [False, True])
@pytest.mark.parametrize("n", [1, 65, 4099, 32768])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cd", list(CDS))
def test_mlp_backward_on_card(cd, x_dtype, n, need_x):
    _card()
    td = CDS[cd][0]
    got, want = _on_card_mlp("native_fast", n, td, CDS[x_dtype][0], need_x)
    assert (got[0] is None) == (not need_x)
    if need_x:
        assert got[0].dtype == want[0].dtype
    r = nc.compare_backward(got, want, td)
    assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 65, 4099, 32768])
@pytest.mark.parametrize("cd", list(CDS))
@pytest.mark.parametrize("case", list(RGB_CASES))
def test_rgb_head_backward_on_card(case, cd, n):
    _card()
    name, E, extra = RGB_CASES[case]
    cfg, td = _cfg(name, E), CDS[cd][0]
    ws, feat, d, codes, g = _rgb_inputs(cfg, n, 14, extra)
    args = [feat.cuda(), d.cuda(), [w.cuda() for w in ws], cfg, g.cuda(), td,
            None if codes is None else codes.cuda(), True, codes is not None,
            True]
    rows = nc.rgb_row(args[0], args[1], cfg, args[6])
    keep = ~nc.marginal_rows(rows, args[2], td)
    if not bool(keep.all()):
        args[0], args[1], args[4] = args[0][keep], args[1][keep], args[4][keep]
        if codes is not None and codes.dim() == 2:
            args[6] = args[6][keep]
    n0 = nc.launches["rgb_head_backward"]
    got = nc.rgb_head_backward(*args)
    torch.cuda.synchronize()
    assert nc.launches["rgb_head_backward"] == n0 + 1
    want = nc.rgb_head_backward_reference(*args)
    r = nc.compare_backward(got, want, td)
    assert r["ok"], r
    assert len(r["arrays"]) == 5 + (codes is not None)
    assert float(got[3][-1][3:].abs().max()) == 0.0


@pytest.mark.cuda
def test_backward_on_card_is_the_same_every_run():
    _card()
    ws, x, g = _mlp_inputs(CFGS["native_fast"], 32768, 15, torch.bfloat16)
    args = [x.cuda(), [w.cuda() for w in ws], g.cuda()]
    a = nc.mlp_backward(*args)
    b = nc.mlp_backward(*args)
    assert all(_same(p, q) for p, q in zip([a[0]] + a[1], [b[0]] + b[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["small", "native_fast"])
def test_adam_on_card_is_the_plain_version_bit_for_bit(cfg):
    _card()
    c = None if cfg == "small" else TCfg.native_fast()
    opts = ttr.TrainOptions(config=c or TCfg())
    card = _adam_state(16, c, "cuda")
    plain = _adam_state(16, c, "cuda")
    cpu = _adam_state(16, c, "cpu")
    n0 = ac.launches["adam"]
    ttr.adam_update(card[0], card[1], card[2], 300, opts,
                    ttr.lr_tensor([300], opts, "cuda"))
    torch.cuda.synchronize()
    assert ac.launches["adam"] == n0 + 1
    names = [n for n, _ in plain[0].named_parameters()]
    ac.adam_reference([p.detach() for p in plain[0].parameters()],
                      [plain[1][n] for n in names],
                      [plain[2]["m"][n] for n in names],
                      [plain[2]["v"][n] for n in names],
                      [0.0 if n == "grid" else opts.l2_reg for n in names],
                      ttr.adam_lr(300, opts), opts.beta1, opts.beta2,
                      opts.eps)
    ttr.adam_update(cpu[0], cpu[1], cpu[2], 300, opts)
    for (name, p), q in zip(card[0].named_parameters(),
                            plain[0].parameters()):
        assert _same(p, q), name
    for k, st in (("plain", plain[2]), ("cpu", cpu[2])):
        for m in ("m", "v"):
            for name in st[m]:
                assert _same(card[2][m][name].cpu(), st[m][name].cpu()), k
    # the CPU's sqrt (MKL's) is off by an ulp on some values: its
    # parameters differ from the card's there, and by no more
    for (name, p), q in zip(card[0].named_parameters(),
                            cpu[0].parameters()):
        want = q.detach()
        assert float((p.detach().cpu() - want).abs().max()) <= (
            1e-6 * float(want.abs().max())), name


@pytest.mark.cuda
def test_training_forward_takes_the_mlp_kernels_on_card():
    """density_raw and rgb_from_features on a network that trains: the
    encode, MLP and head kernels forward and backward, no plain version
    on the card."""
    _card()
    cfg = TCfg.native_fast()
    net = init_params(cfg, torch.Generator().manual_seed(0)).cuda()
    net.requires_grad_(True)
    pos = torch.rand((5000, 3), generator=torch.Generator().manual_seed(1))
    d = torch.rand((5000, 3), generator=torch.Generator().manual_seed(2))
    nc.launches.update(dict.fromkeys(nc.launches, 0))
    nc.plain_on_card.update(dict.fromkeys(nc.plain_on_card, 0))
    rgb, sigma = net(pos.cuda(), d.cuda(), torch.bfloat16, torch.bfloat16)
    loss = rgb.square().sum() + sigma.sum()
    torch.autograd.grad(loss, list(net.parameters()))
    torch.cuda.synchronize()
    for k in ("hash_encode", "mlp", "rgb_head", "hash_encode_backward",
              "mlp_backward", "rgb_head_backward"):
        assert nc.launches[k] == 1, (k, nc.launches)
    assert not any(nc.plain_on_card.values()), nc.plain_on_card


def _snapshot(tr):
    return ({n: t.detach().clone() for n, t in state_tensors(tr.state)},
            tr.gen.get_state(), tr.state["step"], tr._host_step)


def _restore(tr, snap):
    tensors, gen, step, host = snap
    with torch.no_grad():
        for n, t in state_tensors(tr.state):
            t.copy_(tensors[n])
    tr.gen.set_state(gen)
    tr.state["step"], tr._host_step = step, host


@pytest.mark.cuda
def test_replayed_step_matches_eager_steps_on_card():
    """A settled step replayed from its graph against the same step run
    eagerly twice from the same state and draws: loss, parameters and
    moments within the eager steps' own spread (the encode backward's
    atomics) or 1e-6 of each array's largest magnitude; the replay
    counts the kernels' launches."""
    _card()
    tr = ttr.Trainer(_dataset(), _opts(), seed=5, device="cuda")
    tr.occ_warmup_steps = 0
    tr.train(5)                 # step 0 eager, a warm-up, a capture, replays
    assert tr.replayed_steps >= 2 and tr.takes_graph()
    if tr.step % 16 == 0:
        tr.train(1)
    snap = _snapshot(tr)
    runs = []
    for graphs in (False, False, True):
        _restore(tr, snap)
        tr.graphs = graphs
        r0 = tr.replayed_steps
        counts = dict(nc.launches), dict(ac.launches)
        tr.train(1)
        torch.cuda.synchronize()
        assert (tr.replayed_steps - r0) == int(graphs)
        assert ac.launches["adam"] == counts[1]["adam"] + 1
        assert nc.launches["mlp_backward"] > counts[0]["mlp_backward"]
        runs.append(({n: t.detach().clone() for n, t in
                      state_tensors(tr.state)}, tr.loss))
    (e1, l1), (e2, l2), (rp, lr) = runs
    for n in e1:
        if not e1[n].dtype.is_floating_point:
            continue
        spread = float((e1[n] - e2[n]).abs().max()) if e1[n].numel() else 0.0
        scale = float(e1[n].abs().max()) if e1[n].numel() else 0.0
        diff = float((rp[n] - e1[n]).abs().max()) if e1[n].numel() else 0.0
        assert diff <= max(2 * spread, 1e-6 * scale), (n, diff, spread)
    assert abs(lr - l1) <= max(2 * abs(l1 - l2), 1e-6 * abs(l1))
