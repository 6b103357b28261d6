"""The exact epoch on the frame's arrays through its live-ray list
(ops/raymarch.py::_march_lists, ops/march_cuda.py::walk_list and
composite_list) against the epoch it replaced (raymarch._march_gathered:
the alive rays gathered into a compacted copy, advance_samples,
_march_round, the copy scattered back), on the CPU, and the list forms'
kernels on the card.

Scenes at small size: 37x29 camera rays (a few along the axes) into the
128^3 sphere occupancy of one cascade and the three-cascade grid of
tests/test_multicascade.py (built here, with the port alone), K = 8
slots a round, on the jump grid, the clearance grid and the clearance
pyramid, with constant dt and with cone steps of 1/256, a surface
payload on a third of the rays (alpha 1 or 0.5), one and two rounds an
epoch. The network is a seeded one (ops/network.py::init_params) whose
table and density output are scaled so that some rays saturate.

Tolerances: none. On the CPU the list forms' plain versions compute each
ray's arithmetic as the gathered epoch does, op for op, so every frame
array (t, alive, colour, depth, weights, surface alpha) is equal bit for
bit, whatever the list's order and the rows' order before the network
(the network gives a row the same bits wherever it lies:
tests/test_torch_march_kernels.py::test_network_rows_in_either_order).
On the card (tests marked `cuda`, skipped here) the list kernels are
held to march_cuda.compare_with_plain's contract against their plain
versions, and bit for bit against the kernels of the gathered epoch on
the gathered copy; the list march equals the gathered march bit for bit.
This file imports no JAX, so `pytest tests/test_torch_march_epoch.py -m
cuda` runs on the card as it is.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nerf_glasses_tpu_torch import constants as C
from nerf_glasses_tpu_torch.config import NGPConfig
from nerf_glasses_tpu_torch.ops import march_cuda as mc
from nerf_glasses_tpu_torch.ops import occupancy as tocc
from nerf_glasses_tpu_torch.ops import raymarch as trm
from nerf_glasses_tpu_torch.ops.network import init_params

torch.set_num_threads(1)

W, H = 37, 29
K = 8
CONE = 1.0 / 256.0
CFG1 = NGPConfig(n_levels=4, log2_hashmap_size=11, base_resolution=16,
                 per_level_scale=1.5)
CFG4 = dataclasses.replace(CFG1, aabb_scale=4)

# case -> (multi-cascade scene, march options): the jump grid, the
# clearance grid, the clearance pyramid; constant dt and cone steps
CASES = {
    "jump": (False, {}),
    "jump_cone": (False, {"cone_angle": CONE}),
    "dist": (False, {"dist_advance": True}),
    "mips": (True, {"dist_advance": True}),
    "mips_cone": (True, {"dist_advance": True, "cone_angle": CONE}),
}
STATE = ("t", "alive", "rgba", "depth", "max_weight", "surf_a", "wn")


def _density(multi):
    """(cascades, 128, 128, 128): a sphere at the centre; on three
    cascades also a blob that only cascade 2 reaches."""
    g = np.linspace(0, 1, 128, endpoint=False) + 0.5 / 128
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    grid = np.zeros((3 if multi else 1, 128, 128, 128), np.float32)
    grid[0][np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
            < 0.2] = 0.05
    if multi:
        px, py, pz = x * 4 - 1.5, y * 4 - 1.5, z * 4 - 1.5
        grid[2][np.sqrt((px - 0.5) ** 2 + (py - 0.5) ** 2 + (pz - 2.0) ** 2)
                < 0.3] = 0.05
    return torch.from_numpy(grid)


_SCENES = {}


def _scene(multi):
    if multi not in _SCENES:
        occ = tocc.build_occupancy(_density(multi), 2 if multi else 0)
        lo, hi = (-1.5, 2.5) if multi else (0.0, 1.0)
        scene = trm.make_scene(occ, np.full(3, lo), np.full(3, hi),
                               np.eye(3), np.full(3, lo), np.full(3, hi))
        if multi:
            scene["dist_mips"] = tocc.build_dist_grid_cascades(scene["occ"], 2)
        else:
            scene["dist"] = tocc.build_dist_grid(scene["occ"])
        _SCENES[multi] = scene
    return _SCENES[multi]


def _net(multi, seed=0):
    """A seeded network whose densities span transparent to opaque."""
    net = init_params(CFG4 if multi else CFG1,
                      torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    net.grid.copy_(torch.rand(net.grid.shape, generator=g) - 0.5)
    net.density_mlp[-1].mul_(100.0)
    return net


def _options(case, **kw):
    multi, extra = CASES[case]
    kw = {"jitter": False, "compute_dtype": "float32", "steps_per_round": K,
          **extra, **kw}
    opts = trm.MarchOptions(config=CFG4 if multi else CFG1, **kw)
    if opts.cone_angle == 0.0 and opts.config.max_cascade == 0:
        # as march_frame_impl: the advance does the init walk's stepping
        opts = dataclasses.replace(opts, init_skip_iters=0)
    return opts


def _rays(multi, surface, seed=0):
    """37x29 camera rays (three along +z, one oblique) and a surface
    payload on a third of them -> tensors (o, d, surf (n, 4), t_surf)."""
    rng = np.random.default_rng(seed)
    if multi:
        cam = np.array([[0.45, 0, 0, 0.1], [0, 0.4, 0, -0.05],
                        [0, 0, 1, -3.0]], np.float32)
    else:
        cam = np.array([[0.5, 0, 0, 0.02], [0, 0.4, 0, 0.01],
                        [0, 0, 1, -1.2]], np.float32)
    o, d = trm.camera_rays(cam, W, H)
    o, d = o.copy(), d.copy()
    d[:3] = np.array([0.0, 0.0, 1.0], np.float32)
    d[3] = np.array([0.0, 0.6, 0.8], np.float32)
    n = o.shape[0]
    surf = np.zeros((n, 4), np.float32)
    t_surf = np.zeros(n, np.float32)
    if surface:
        has = rng.uniform(size=n) < 1.0 / 3.0
        t_surf[has] = rng.uniform(*((2.5, 5.0) if multi else (0.8, 1.8)),
                                  has.sum())
        surf[has, :3] = rng.uniform(0, 1, (has.sum(), 3))
        surf[has, 3] = np.where(rng.uniform(size=has.sum()) < 0.5, 1.0, 0.5)
        surf[has, :3] *= surf[has, 3:]
    return tuple(torch.from_numpy(x) for x in (o, d, surf, t_surf))


def _start(case, surface, device="cpu", **kw):
    """-> (network, scene, options, the march state after init_rays)."""
    multi = CASES[case][0]
    opts = _options(case, **kw)
    scene = {k: v.to(device) for k, v in _scene(multi).items()}
    o, d, surf, t_surf = (x.to(device) for x in _rays(multi, surface))
    st = trm._make_state(scene, o, d, surf, t_surf, opts, 0)
    return _net(multi).to(device), scene, opts, st


def _copy(st):
    return {k: v.clone() for k, v in st.items()}


def _bits_equal(got, want, name):
    got, want = got.detach().cpu(), want.detach().cpu()
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    bad = got != want
    assert not bool(bad.any()), f"{name}: {int(bad.sum())} elements differ"


def _states_equal(a, b):
    for k in STATE:
        _bits_equal(a[k], b[k], k)


# ---------------------------------------------------------------------------
# (a) The list march against the gathered march (plain versions, CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("surface", [False, True], ids=["plain", "surface"])
@pytest.mark.parametrize("case", list(CASES))
def test_list_march_equals_gathered_march(case, surface, rounds):
    """Every epoch of the list march (walk_list, the network, composite_
    list) leaves every frame array as the gathered march leaves it, bit
    for bit, over the whole march."""
    net, scene, opts, st = _start(case, surface, rounds_per_epoch=rounds)
    a, b = _copy(st), _copy(st)
    epochs_a = trm._march_gathered(net, scene, a, opts)
    epochs_b = trm._march_lists(net, scene, b, opts)
    assert epochs_a == epochs_b and epochs_a > 1
    _states_equal(b, a)
    # the march did its work: rays saturated, surfaces blended, all ended
    assert not bool(b["alive"].any())
    assert bool((b["rgba"][:, 3] > 0.99).any())
    if surface:
        assert bool((b["surf_a"] != st["surf_a"]).any())


def test_list_march_equals_gathered_march_at_bf16():
    """The same at the bf16 compute dtype, and march_frame_impl's frame."""
    net, scene, opts, st = _start("jump", True, compute_dtype="bfloat16")
    a, b = _copy(st), _copy(st)
    assert (trm._march_gathered(net, scene, a, opts)
            == trm._march_lists(net, scene, b, opts))
    _states_equal(b, a)
    o, d, surf, t_surf = _rays(False, True)
    out, epochs = trm.march_frame_impl(net, scene, o, d, surf, t_surf, opts)
    want = trm._finalize(a)
    _bits_equal(out["rgba"], want["rgba"], "rgba")
    _bits_equal(out["depth"], want["depth"], "depth")


@pytest.mark.parametrize("steps", [12, 64])
def test_list_march_takes_more_slots_than_a_byte(steps):
    """With 12 and 64 slots a round (two and eight bytes of slot bits an
    entry) the list march equals the gathered march bit for bit, and a
    list entry's rows are its valid slots', in slot order from its first
    row."""
    net, scene, opts, st = _start("dist", True, steps_per_round=steps)
    a, b = _copy(st), _copy(st)
    assert (trm._march_gathered(net, scene, a, opts)
            == trm._march_lists(net, scene, b, opts))
    _states_equal(b, a)
    ids = _first_list(st)
    n = ids.numel()
    rows = mc.list_buffers(n, steps, "cpu")
    count = torch.zeros(1, dtype=torch.int32)
    mc.walk_list(_copy(st), ids, n, scene, opts, opts.advance_iters, rows,
                 count)
    slot_rows = mc.list_slot_rows(rows, n, steps)
    valid = slot_rows >= 0
    assert int(valid[8:].sum()) > 0
    taken = slot_rows.T[valid.T]                # entry by entry, slot order
    assert torch.equal(taken, torch.arange(int(count[0])))


def test_list_march_stops_at_the_epoch_budget():
    """With a budget of 3 epochs both marches stop there, rays still
    alive, with equal state."""
    net, scene, opts, st = _start("mips_cone", True, max_rounds=3)
    a, b = _copy(st), _copy(st)
    assert trm._march_gathered(net, scene, a, opts) == 3
    assert trm._march_lists(net, scene, b, opts) == 3
    assert bool(b["alive"].any())
    _states_equal(b, a)


# ---------------------------------------------------------------------------
# (b) One epoch in any list order and any row order
# ---------------------------------------------------------------------------

def _epoch(net, scene, st, opts, ids, row_perm=None):
    """One epoch of the list march on `ids` (rows_per_epoch rounds), the
    rows of each round permuted by row_perm(m) before the network and its
    outputs put back in the rows' order, in the network's layout ->
    the next list."""
    n = ids.numel()
    rows = mc.list_buffers(n, K, ids.device)
    counts = torch.zeros(2 * opts.rounds_per_epoch + 1, dtype=torch.int32,
                         device=ids.device)
    nxt = torch.empty_like(ids)
    for r in range(opts.rounds_per_epoch):
        c = counts[2 * r:2 * r + 2]
        mc.walk_list(st, ids, n, scene, opts,
                     opts.advance_iters if r == 0 else None, rows, c[1:])
        m = int(c[1])
        if row_perm is None:
            rgb, sigma = net(rows["pos01"][:m], rows["dir01"][:m],
                             compute_dtype=opts.cdtype)
        else:
            p = row_perm(m)
            rgb, sigma = net(rows["pos01"][:m][p], rows["dir01"][:m][p],
                             compute_dtype=opts.cdtype)
            inv = torch.empty_like(p)
            inv[p] = torch.arange(m, device=p.device)
            rgb, sigma = mc._rows_like(rgb, inv), mc._rows_like(sigma, inv)
        last = r == opts.rounds_per_epoch - 1
        mc.composite_list(st, ids, n, rows, m, rgb, sigma, opts,
                          nxt if last else None,
                          counts[2 * r + 2:2 * r + 3] if last else None)
    return nxt[:int(counts[-1])]


def _first_list(st):
    return torch.nonzero(st["alive"]).squeeze(1).to(torch.int32)


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("case", ["jump", "mips_cone"])
def test_epoch_is_the_same_in_any_list_order(case, rounds):
    """An epoch on the list reversed, shuffled (a seeded numpy
    permutation), or with each round's rows permuted before the network,
    leaves the frame's arrays as the ascending list does, bit for bit,
    and lists the same rays for the next epoch; the ascending list's
    next list is ascending."""
    net, scene, opts, st = _start(case, True, rounds_per_epoch=rounds)
    ids = _first_list(st)
    ref = _copy(st)
    nxt_ref = _epoch(net, scene, ref, opts, ids)
    assert torch.equal(nxt_ref, torch.sort(nxt_ref).values)
    rng = np.random.default_rng(11)
    orders = {"reversed": ids.flip(0),
              "shuffled": ids[torch.from_numpy(rng.permutation(ids.numel()))]}
    for name, order in orders.items():
        got = _copy(st)
        nxt = _epoch(net, scene, got, opts, order.contiguous())
        _states_equal(got, ref)
        assert torch.equal(torch.sort(nxt).values, nxt_ref), name
    got = _copy(st)
    nxt = _epoch(net, scene, got, opts, ids, row_perm=lambda m: torch.from_numpy(
        rng.permutation(m)))
    _states_equal(got, ref)
    assert torch.equal(nxt, nxt_ref)
    assert bool((ref["t"] != st["t"]).any()) and bool((~ref["alive"]
                                                      & st["alive"]).any())


# ---------------------------------------------------------------------------
# (c) The list forms' pieces and wrappers
# ---------------------------------------------------------------------------

def _gathered(st, ids):
    idl = ids.long()
    sub = {k: st[k][idl] for k in trm._GATHER}
    sub["alive"] = torch.ones(ids.numel(), dtype=torch.bool)
    return sub


@pytest.mark.parametrize("case", list(CASES))
def test_list_walk_is_advance_samples_on_the_gathered_rays(case):
    """walk_list's rows spread over their slots (list_walk_outputs) are
    advance_samples' on the gathered copy, the rows' positions aten's
    (pos - train_min) / (train_max - train_min) and directions (d + 1) /
    2, bit for bit; t and alive are written into the frame; a list in
    another order gives each ray the same rows."""
    net, scene, opts, st = _start(case, True)
    ids = _first_list(st)
    n = ids.numel()
    (t, alive), ((pos, dt, valid, ts), t_end, exited, stopped) = \
        mc.advance_samples(_gathered(st, ids), scene, opts, opts.advance_iters)
    frame = _copy(st)
    rows = mc.list_buffers(n, K, "cpu")
    count = torch.zeros(1, dtype=torch.int32)
    before = dict(mc.launches)
    mc.walk_list(frame, ids, n, scene, opts, opts.advance_iters, rows, count)
    assert mc.launches == before
    (lt, la), ((p01, ldt, lvalid, lts), lte, lex, lst) = mc.list_walk_outputs(
        frame, ids, n, rows, K)
    assert int(count[0]) == int(valid.sum()) > 0
    want01 = torch.where(valid[..., None], (pos - scene["train_min"]) / (
        scene["train_max"] - scene["train_min"]), 0.0)
    for name, g, w in (("t", lt, t), ("alive", la, alive), ("valid", lvalid, valid),
                       ("pos01", p01, want01),
                       ("dt", ldt, torch.where(valid, dt, 0.0)),
                       ("ts", lts, torch.where(valid, ts, 0.0)),
                       ("t_end", lte, t_end), ("exited", lex, exited),
                       ("stopped", lst, stopped)):
        _bits_equal(g, w, name)
    rid = ids.long()
    r = mc.list_slot_rows(rows, n, K)
    dirs = rows["dir01"][r[valid]]
    _bits_equal(dirs, ((st["d"][rid] + 1.0) * 0.5)[None].expand(K, n, 3)[valid],
                "dir01")
    # the frame arrays of rays off the list are untouched
    off = torch.ones(st["t"].shape[0], dtype=torch.bool)
    off[rid] = False
    _bits_equal(frame["t"][off], st["t"][off], "t off the list")


def test_list_forms_reject_what_the_kernels_do_not_take():
    net, scene, opts, st = _start("jump", False)
    ids = _first_list(st)
    n = ids.numel()
    rows = mc.list_buffers(n, K, "cpu")
    count = torch.zeros(1, dtype=torch.int32)
    it = opts.advance_iters
    for bad_ids in (ids.long(), ids[:-1], ids[None]):
        with pytest.raises(ValueError):
            mc.walk_list(st, bad_ids, n, scene, opts, it, rows, count)
    for k, v in (("pos01", rows["pos01"][:, :2]), ("ts", rows["ts"][:-1]),
                 ("first", rows["first"].long()),
                 ("mask", rows["mask"][:-1]),
                 ("exited", rows["exited"].float())):
        with pytest.raises(ValueError):
            mc.walk_list(st, ids, n, scene, opts, it, {**rows, k: v}, count)
    with pytest.raises(ValueError):
        mc.walk_list(st, ids, n, scene, opts, it, rows, count.long())
    with pytest.raises(ValueError):
        mc.walk_list({**st, "t": st["t"].double()}, ids, n, scene, opts, it,
                     rows, count)
    with pytest.raises(ValueError):
        mc.walk_list(st, ids, n, scene, dataclasses.replace(
            opts, steps_per_round=mc.MAX_LIST_STEPS + 1), it, rows, count)
    with pytest.raises(ValueError):             # the rows start at 0
        mc.walk_list(st, ids, n, scene, opts, it, rows, count + 1)
    mc.walk_list(st, ids, n, scene, opts, it, rows, count)
    m = int(count[0])
    rgb, sigma = net(rows["pos01"][:m], rows["dir01"][:m],
                     compute_dtype=torch.float32)
    nxt, cnt = torch.empty_like(ids), torch.zeros(1, dtype=torch.int32)
    for args in ((rgb[:-1], sigma), (rgb, sigma[:-1]), (rgb.double(), sigma)):
        with pytest.raises(ValueError):
            mc.composite_list(st, ids, n, rows, m, *args, opts, nxt, cnt)
    with pytest.raises(ValueError):
        mc.composite_list(st, ids, n, rows, m, rgb, sigma, opts, nxt, None)
    with pytest.raises(ValueError):
        mc.composite_list(st, ids, n, rows, m, rgb, sigma, opts, nxt[:-1], cnt)
    with pytest.raises(ValueError):             # the next list starts at 0
        mc.composite_list(st, ids, n, rows, m, rgb, sigma, opts, nxt, cnt + 1)
    mc.composite_list(st, ids, n, rows, m, rgb, sigma, opts, nxt, cnt)
    assert int(cnt[0]) == int(st["alive"].sum())


# ---------------------------------------------------------------------------
# (d) The list kernels on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")


def _card_list(st, seed=5):
    """The first list, shuffled: the kernels must not depend on its
    order."""
    ids = _first_list(st)
    p = torch.from_numpy(np.random.default_rng(seed).permutation(ids.numel()))
    return ids[p.to(ids.device)].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("surface", [False, True], ids=["plain", "surface"])
@pytest.mark.parametrize("case", list(CASES))
def test_list_walk_kernel_on_card(case, surface):
    """The list walk's kernel on a shuffled list: against its plain version
    under the contract, and bit for bit the fused walk kernel
    (advance_samples) on the gathered copy, positions aten's on the
    card."""
    _needs_card()
    net, scene, opts, st = _start(case, surface, device="cuda")
    ids = _card_list(st)
    n = ids.numel()
    outs = []
    for fn in (mc.walk_list, mc.walk_list_reference):
        frame = _copy(st)
        rows = mc.list_buffers(n, K, "cuda")
        count = torch.zeros(1, dtype=torch.int32, device="cuda")
        before = mc.launches["walk_list"]
        fn(frame, ids, n, scene, opts, opts.advance_iters, rows, count)
        torch.cuda.synchronize()
        assert mc.launches["walk_list"] == before + (fn is mc.walk_list)
        outs.append(mc.list_walk_outputs(frame, ids, n, rows, K))
    r = mc.compare_with_plain("advance_samples", *outs)
    assert r["ok"], r
    sub = {k: st[k][ids.long()] for k in trm._GATHER}
    sub["alive"] = torch.ones(n, dtype=torch.bool, device="cuda")
    (t, alive), ((pos, dt, valid, ts), t_end, ex, sp) = mc.advance_samples(
        sub, scene, opts, opts.advance_iters)
    (lt, la), ((p01, ldt, lv, lts), lte, lex, lst) = outs[0]
    want01 = torch.where(valid[..., None], (pos - scene["train_min"]) / (
        scene["train_max"] - scene["train_min"]), 0.0)
    for name, g, w in (("t", lt, t), ("alive", la, alive), ("valid", lv, valid),
                       ("pos01", p01, want01),
                       ("dt", ldt, torch.where(valid, dt, 0.0)),
                       ("ts", lts, torch.where(valid, ts, 0.0)),
                       ("t_end", lte, t_end), ("exited", lex, ex),
                       ("stopped", lst, sp)):
        _bits_equal(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [K, 64])
@pytest.mark.parametrize("form", ["advance", "samples"])
@pytest.mark.parametrize("case", ["jump", "mips_cone"])
def test_list_walk_rows_on_card(case, form, steps):
    """The list walk's kernel on a shuffled list with gaps (every third
    entry of the shuffled first list left out), in its advance + samples
    form and its samples form (on the rays the advance form left): against
    its plain version under the contract; each slot's row (list_slot_rows)
    bit for bit the gathered epoch's kernel's on the gathered copy, its
    position and direction aten's; rows 0..m-1 each a slot's once, m the
    plain version's count; within a warp an entry's rows follow those of
    the entry before it (the layout the composite reads)."""
    _needs_card()
    net, scene, opts, st = _start(case, True, device="cuda",
                                  steps_per_round=steps)
    ids = _card_list(st)
    ids = ids[torch.arange(ids.numel(), device="cuda") % 3 != 2].contiguous()
    n = ids.numel()
    iters = opts.advance_iters

    def run(fn, frame, iters):
        rows = mc.list_buffers(n, steps, "cuda")
        count = torch.zeros(1, dtype=torch.int32, device="cuda")
        fn(frame, ids, n, scene, opts, iters, rows, count)
        torch.cuda.synchronize()
        return rows, int(count[0])

    start = _copy(st)
    if form == "samples":
        run(mc.walk_list, start, iters)
        iters = None
    got = []
    for fn in (mc.walk_list, mc.walk_list_reference):
        frame = _copy(start)
        rows, m = run(fn, frame, iters)
        got.append((mc.list_walk_outputs(frame, ids, n, rows, steps), rows, m))
    (out_k, rows, m), (out_p, _, m_p) = got
    kind = "advance_samples" if form == "advance" else "samples"
    pick = (lambda o: o) if form == "advance" else (lambda o: o[1])
    r = mc.compare_with_plain(kind, pick(out_k), pick(out_p))
    assert r["ok"], r
    idl = ids.long()
    sub = {k: start[k][idl] for k in trm._GATHER}
    if form == "advance":
        sub["alive"] = torch.ones(n, dtype=torch.bool, device="cuda")
        (t, alive), gen = mc.advance_samples(sub, scene, opts, iters)
        _bits_equal(out_k[0][0], t, "t")
        _bits_equal(out_k[0][1], alive, "alive")
    else:
        sub["alive"] = start["alive"][idl]
        gen = mc.samples(sub, scene, opts)
    (pos, dt, valid, ts), t_end, ex, sp = gen
    (p01, ldt, lv, lts), lte, lex, lst = out_k[1]
    want01 = torch.where(valid[..., None], (pos - scene["train_min"]) / (
        scene["train_max"] - scene["train_min"]), 0.0)
    for name, g, w in (("valid", lv, valid), ("pos01", p01, want01),
                       ("dt", ldt, torch.where(valid, dt, 0.0)),
                       ("ts", lts, torch.where(valid, ts, 0.0)),
                       ("t_end", lte, t_end), ("exited", lex, ex),
                       ("stopped", lst, sp)):
        _bits_equal(g, w, name)
    slot_rows = mc.list_slot_rows(rows, n, steps)
    used = slot_rows[slot_rows >= 0]
    assert m == m_p == used.numel() > 0
    _bits_equal(torch.sort(used).values, torch.arange(m, device="cuda"),
                "rows")
    _bits_equal(rows["dir01"][slot_rows.clamp(min=0)][valid],
                ((start["d"][idl] + 1.0) * 0.5)[None].expand(steps, n, 3)[valid],
                "dir01")
    first = rows["first"][:n].long()
    per = (slot_rows >= 0).sum(0)
    j = torch.arange(n - 1, device="cuda")
    warp = j // 32 == (j + 1) // 32
    _bits_equal(first[1:][warp], (first[:-1] + per[:-1])[warp], "first rows")


@pytest.mark.cuda
@pytest.mark.parametrize("deferred", [False, True], ids=["colour", "deferred"])
@pytest.mark.parametrize("case", ["jump", "mips_cone"])
def test_list_composite_kernel_on_card(case, deferred):
    """The list composite's kernel after the list walk's, on a shuffled
    list: against its plain version under the contract, bit for bit the
    composite kernel on the gathered copy and the same rows; it lists the
    rays it leaves alive, each once."""
    _needs_card()
    net, scene, opts, st = _start(case, True, device="cuda",
                                  deferred_color=deferred)
    ids = _card_list(st)
    n = ids.numel()
    rows = mc.list_buffers(n, K, "cuda")
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    mc.walk_list(st, ids, n, scene, opts, opts.advance_iters, rows, count)
    m = int(count[0])
    rgb, sigma = net(rows["pos01"][:m], rows["dir01"][:m],
                     compute_dtype=opts.cdtype)
    outs = {}
    for fn in (mc.composite_list, mc.composite_list_reference):
        frame = _copy(st)
        nxt = torch.empty_like(ids)
        cnt = torch.zeros(1, dtype=torch.int32, device="cuda")
        fn(frame, ids, n, rows, m, rgb, sigma, opts, nxt, cnt)
        torch.cuda.synchronize()
        idl = ids.long()
        live = nxt[:int(cnt[0])]
        assert torch.equal(torch.sort(live).values,
                           torch.sort(ids[frame["alive"][idl]]).values)
        outs[fn] = {k: frame[k][idl] for k in STATE}
    got, plain = outs[mc.composite_list], outs[mc.composite_list_reference]
    r = mc.compare_with_plain("composite", got, plain)
    assert r["ok"], r
    # the gathered copy: the rows where the network left them, their slots
    slot_rows = mc.list_slot_rows(rows, n, K)
    valid = slot_rows >= 0
    slots = torch.empty(m, dtype=torch.int64, device="cuda")
    slots[slot_rows[valid]] = torch.nonzero(valid.reshape(-1)).squeeze(1)
    dense = {}
    for k in ("ts", "dt"):
        dense[k] = torch.zeros((K, n), device="cuda")
        dense[k][valid] = rows[k][slot_rows[valid]]
    sub = {k: st[k][ids.long()] for k in trm._GATHER + ("alive",)}
    rnd = {"t_end": rows["t_end"][:n], "exited": rows["exited"][:n],
           "surf_stopped": rows["stopped"][:n], "valid": valid,
           "ts": dense["ts"], "dt": dense["dt"], "rgb": rgb, "sigma": sigma,
           "slots": slots}
    want = mc.composite(sub, rnd, opts)
    for k in ("rgba", "depth", "max_weight", "wn", "surf_a", "alive"):
        _bits_equal(got[k], want[k], k)
    _bits_equal(got["t"], rnd["t_end"], "t")


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_list_march_equals_gathered_march_on_card(case, rounds):
    """The whole list march on the card (list kernels, the network's
    kernels) equals the gathered march there (the fused walk, the row-form
    composite) bit for bit, at the bf16 compute dtype; the list march
    launches no gathered-epoch kernel."""
    _needs_card()
    net, scene, opts, st = _start(case, True, device="cuda",
                                  rounds_per_epoch=rounds,
                                  compute_dtype="bfloat16")
    a, b = _copy(st), _copy(st)
    epochs_a = trm._march_gathered(net, scene, a, opts)
    before = dict(mc.launches)
    epochs_b = trm._march_lists(net, scene, b, opts)
    torch.cuda.synchronize()
    assert epochs_a == epochs_b > 1
    _states_equal(b, a)
    grew = {k: mc.launches[k] - before[k] for k in mc.launches}
    assert grew["composite_list"] == epochs_b * rounds
    assert grew["walk_list"] >= epochs_b * rounds
    assert not any(grew[k] for k in ("advance", "samples", "advance_samples",
                                     "composite"))


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [12, 64])
def test_list_march_takes_more_slots_than_a_byte_on_card(steps):
    """The list march on the card with 12 and 64 slots a round equals the
    gathered march there bit for bit."""
    _needs_card()
    net, scene, opts, st = _start("dist", True, device="cuda",
                                  steps_per_round=steps)
    a, b = _copy(st), _copy(st)
    assert (trm._march_gathered(net, scene, a, opts)
            == trm._march_lists(net, scene, b, opts))
    torch.cuda.synchronize()
    _states_equal(b, a)
