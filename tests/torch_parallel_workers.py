"""Rank bodies for tests/test_torch_parallel.py, run by
nerf_glasses_tpu_torch.parallel.sharding.run_on_mesh.

Spawned ranks import this module by name, so it imports torch and the
port only: a rank never loads JAX. Every function takes the rank's Mesh
first and returns numpy (or plain Python) values. Tensors passed to a
rank arrive in memory shared with the parent and the other ranks: a body
that updates them in place works on a copy.
"""

import copy
import time

import torch

from nerf_glasses_tpu_torch.parallel import sharding


def _np(x):
    return x.detach().cpu().numpy()


def render_jobs(mesh, marches, images, hybrid):
    """marches: [(net, scene, o, d, surf, t_surf, opts)] through
    make_sharded_march; images: [(net, scene, cam, w, h, opts)] through
    render_image_sharded; hybrid: (net, scene, tri_mesh, xf, nm, cam, w, h,
    opts) through render_hybrid_sharded on the mesh -> dict of numpy
    results, plus what make_mesh(backend="nccl") raised in this gloo
    group."""
    out = {"march": [], "image": []}
    for net, scene, o, d, surf, ts, opts in marches:
        rgba, depth = sharding.make_sharded_march(mesh, opts)(
            net, scene, o, d, surf, ts)
        out["march"].append((_np(rgba), _np(depth)))
    for net, scene, cam, w, h, opts in images:
        out["image"].append(sharding.render_image_sharded(
            net, scene, cam, w, h, opts, mesh))
    net, scene, tm, xf, nm, cam, w, h, opts = hybrid
    out["hybrid"] = sharding.render_hybrid_sharded(net, scene, tm, xf, nm,
                                                   cam, w, h, opts, mesh)
    try:
        sharding.make_mesh(backend="nccl")
        out["nccl"] = None
    except (RuntimeError, ValueError) as e:
        out["nccl"] = type(e).__name__
    return out


def dp_step(mesh, cases):
    """cases: [(state, data, opts, per-rank draws)]: one data-parallel
    step of _make_local_step from each case's replicated state on this
    rank's draws -> [dict of the updated state as numpy]."""
    out = []
    for state, data, opts, draws in cases:
        state = copy.deepcopy(state)
        state, loss = sharding._make_local_step(mesh, opts)(
            state, data, draws[mesh.rank])
        out.append({
            "loss": float(loss),
            "params": {k: _np(p) for k, p in state["net"].named_parameters()},
            "aux": {k: _np(a) for k, a in state["aux"].items()},
            "error_map": _np(state["error_map"]),
            "loss_ema": float(state["loss_ema"]),
            "overflow": (int(state["overflow_steps"]),
                         int(state["overflow_samples"])),
            "mismatches": sharding.replica_mismatches(mesh, state)})
    return out


def fail_on_rank1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.reduce([torch.ones(2)])[0].tolist()


def sleep(mesh, seconds):
    time.sleep(seconds)


def _losses(tr, n):
    return [tr.train(1) for _ in range(n)]


def trainer_suite(mesh, ds, plain, compact, no_compact):
    """tests/test_parallel.py's three ShardedTrainer tests on this rank,
    and the replicas after a chunk -> dict of their observations."""
    out = {}
    tr = sharding.ShardedTrainer(ds, plain, mesh=mesh)
    out["seeds"] = (tr.gen.initial_seed(), tr.ray_gen.initial_seed())
    tr.occ_warmup_steps = 1 << 30      # keep occ dense for this smoke test
    early = _losses(tr, 5)
    tr.train(11)                       # to the end of the first chunk
    out["after_chunk"] = sharding.replica_mismatches(mesh, tr.state)
    tr.train(49)
    out["plain"] = {"early": early, "late": _losses(tr, 5), "step": tr.step,
                    "mismatches": sharding.replica_mismatches(mesh, tr.state)}

    tr = sharding.ShardedTrainer(ds, compact, mesh=mesh)
    tr.occ_warmup_steps = 16
    warm = (tr._chunk_fn_warmup, tr._step_fn_warmup)
    gate = [tr._fns_for(0) == warm]
    tr._compact_ready = True
    gate.append(tr._fns_for(tr.occ_warmup_steps) == (tr._chunk_fn,
                                                      tr._step_fn))
    gate.append(tr._fns_for(0) == warm)
    tr._compact_ready = False
    gate.append(tr._chunk_fn_warmup is not tr._chunk_fn)
    early = _losses(tr, 4)             # inside warmup
    tr.train(60)                       # crosses the gate
    out["compact"] = {"gate": gate, "early": early, "late": _losses(tr, 4),
                      "step": tr.step, "compacting": tr._compact_ready,
                      "overflow": tr.keep_overflow,
                      "mismatches": sharding.replica_mismatches(mesh,
                                                                tr.state)}

    tr = sharding.ShardedTrainer(ds, no_compact, mesh=mesh)
    out["shares"] = (tr._chunk_fn_warmup is tr._chunk_fn,
                     tr._step_fn_warmup is tr._step_fn)
    # the callback path takes the same steps as the chunked one
    a = sharding.ShardedTrainer(ds, no_compact, seed=5, mesh=mesh)
    b = sharding.ShardedTrainer(ds, no_compact, seed=5, mesh=mesh)
    a.train(6)
    seen = []
    b.train(6, callback=lambda s, l: seen.append(s))
    out["callback"] = {
        "steps": seen, "losses": a.loss_history == b.loss_history,
        "params": all(torch.equal(p, q) for p, q in
                      zip(a.net.parameters(), b.net.parameters()))}
    return out

