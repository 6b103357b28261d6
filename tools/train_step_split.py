"""The settled training step on the card, split by stage and by what it
runs, for one or more checkouts in turns.

    python3 tools/train_step_split.py [ROOT ...]

Each ROOT (default: this checkout) is a whole checkout; its package and
its chip_smoke.py (the capture and the trained snapshot) are used, each
turn in a process of its own run from ROOT, in the order ROOTs, then
ROOTs reversed. In each process the trainer resumes trained_head_v6 on
chip_smoke.py's capture (native_fast, 2048 rays x 48 samples, the
compaction gate open), as phase 14 does, and:

- one settled step (not a grid-refresh step) under torch.profiler: the
  device operations its host put on the card (CUDA API calls that launch
  a kernel, copy or fill; a graph replay counted as its nodes, the
  package's raymarch.graph_counts), each charged to the stage whose
  frame called it (the trainer's functions as in tools/train_step_ops.py;
  calls on autograd's own thread go to "backward"; a replayed step runs
  none of them: its host's calls are "outside any stage"), busy and
  wall ms;
- (a) the settled steps/s over 64 steps and three steps' busy and wall
  ms as the checkout runs them;
- (b) the same, eager (a replay calls no Python), with the MLPs' forward
  and backward and the network's Adam left out: the density MLP replaced
  by the first 16 columns of the encode, the rgb head by the first 3 of
  the density output, the Adam update by nothing (the unused weights'
  gradients not asked for);
- (c) the step's own network Adam update (train/trainer.py adam_update,
  on copies of its parameters, moments and one step's gradients) by CUDA
  events, beside one torch.optim.Adam(fused=True) step on copies of the
  same tensors (the same work by another formula).

It prints one line per turn and, last, one JSON object of every turn's
numbers. Needs a card.
"""
import collections
import json
import os
import subprocess
import sys
import time

CHILD = "--child"


def child():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from nerf_glasses_tpu_torch.config import NGPConfig
    from nerf_glasses_tpu_torch.ops import network as net_mod
    from nerf_glasses_tpu_torch.ops import network_cuda
    from nerf_glasses_tpu_torch.ops import raymarch as rm
    from nerf_glasses_tpu_torch.train import trainer as ttr

    dev = torch.device("cuda")
    ds = cs.build_capture(dev)[0]
    opts = ttr.TrainOptions(config=NGPConfig.native_fast())

    def settled():
        tr = ttr.Trainer(ds, opts, seed=3, device=dev)
        tr.load_snapshot(cs.SNAPSHOT)
        tr.train(cs.RATE_SETTLED[0])
        if not tr._compact_ready:
            raise AssertionError("the compaction gate is closed")
        return tr

    def to_step_start(tr):
        if tr.step % tr.opts.grid_update_interval == 0:
            tr.train(1)

    stages = {"draw_step": "draws", "_sample_pixels": "pixels",
              "_gen_rays": "rays", "march_training_samples": "hop pass",
              "compact_sample_sel": "keep set", "forward_rays": "forward",
              "adam_update": "adam", "_error_map_accum": "error map",
              "_error_map_apply": "error map", "_loss_fn": "loss"}
    puts = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset",
            "cuMemcpy", "cuMemset")

    def staged(fn, label):
        def call(*a, **k):
            with record_function("STAGE:" + label):
                return fn(*a, **k)
        return call

    def by_stage(tr):
        """One settled step's device operations by stage."""
        to_step_start(tr)
        saved = {name: getattr(ttr, name) for name in stages}
        grad = torch.autograd.grad
        for name, label in stages.items():
            setattr(ttr, name, staged(saved[name], label))
        torch.autograd.grad = staged(grad, "backward")
        graphs = getattr(rm, "graph_counts", {})
        nodes0 = graphs.get("nodes", 0)
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.train(1)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            for name in stages:
                setattr(ttr, name, saved[name])
            torch.autograd.grad = grad
        main = None
        counts = collections.Counter()
        busy = 0.0
        events = list(prof.events())
        for e in events:
            if e.name.startswith("STAGE:"):
                main = e.thread
                break
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith("STAGE:"):   # the annotations
                    busy += e.time_range.elapsed_us() / 1e3
                continue
            if not e.name.startswith(puts) and e.name != "cudaGraphLaunch":
                continue
            stage, p = None, e.cpu_parent
            while p is not None:
                if p.name.startswith("STAGE:"):
                    stage = p.name[6:]
                    break
                p = p.cpu_parent
            if stage is None:
                # where no stage ran (a replay) the host's calls around it
                stage = ("outside any stage" if main is None
                         else "backward" if e.thread != main else "other")
            if e.name == "cudaGraphLaunch":
                counts[stage + " (graph replays)"] += 1
            else:
                counts[stage] += 1
        nodes = graphs.get("nodes", 0) - nodes0
        if nodes:
            counts["graph nodes"] = nodes
        return {"ops": sum(v for k, v in counts.items()
                           if not k.endswith("(graph replays)")),
                "by_stage": dict(counts.most_common()), "busy_ms": busy,
                "wall_ms": wall}

    def rate_and_steps(tr):
        to_step_start(tr)
        sps = cs.timed_steps(tr, 64)
        steps = []
        for _ in range(3):
            to_step_start(tr)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.train(1)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            steps.append([busy, wall])
        return sps, steps

    out = {"root": os.getcwd(), "device": torch.cuda.get_device_name(0)}
    tr = settled()
    out["by_stage"] = [by_stage(tr) for _ in range(2)]
    out["a"] = rate_and_steps(tr)

    # (c): the step's Adam on copies, beside fused Adam
    got = {}
    adam = ttr.adam_update

    def keep(net, grads, opt, step, o, *rest):
        if not got:
            got["args"] = (net, {k: g.clone() for k, g in grads.items()},
                           opt, step, o, *rest)
        return adam(net, grads, opt, step, o, *rest)

    to_step_start(tr)
    ttr.adam_update = keep
    graphs = getattr(tr, "graphs", None)
    tr.graphs = False           # a replayed step calls no Python
    try:
        tr.train(1)
    finally:
        ttr.adam_update = adam
        tr.graphs = graphs
    net, grads, opt, step, o, *rest = got["args"]
    net_c = net.detached_copy()
    opt_c = {k: {n: t.clone() for n, t in opt[k].items()} for k in opt}
    out["adam_ms"] = cs.cuda_ms(
        lambda: adam(net_c, grads, opt_c, step, o, *rest), 20)
    params = [p.detach().clone().requires_grad_(True)
              for _, p in net.named_parameters()]
    for p, (n, _) in zip(params, net.named_parameters()):
        p.grad = grads[n].clone()
    fused = torch.optim.Adam(params, lr=o.learning_rate,
                             betas=(o.beta1, o.beta2), eps=o.eps, fused=True)
    out["fused_adam_ms"] = cs.cuda_ms(fused.step, 20)
    out["adam_elements"] = sum(p.numel() for p in params)

    # (b): the MLPs and Adam left out
    density, rgb = net_mod.NerfNetwork.density_raw, \
        net_mod.NerfNetwork.rgb_from_features

    def no_mlp(self, pos01, compute_dtype=torch.bfloat16,
               encode_dtype=torch.float32, count=None, out=None):
        if count is not None or not network_cuda.trains_on_card(
                self.grid, pos01):
            return density(self, pos01, compute_dtype, encode_dtype, count,
                           out)
        enc = network_cuda.HashEncode.apply(self.grid, pos01.contiguous(),
                                            self.config, encode_dtype)
        return enc[:, :self.density_mlp[-1].shape[0]].float()

    def no_head(self, feat, dir01, compute_dtype=torch.bfloat16, extra=None,
                count=None, out=None):
        if count is not None or not feat.requires_grad:
            return rgb(self, feat, dir01, compute_dtype, extra, count, out)
        return feat[:, :3]

    grad = torch.autograd.grad

    def used_only(outputs, inputs, *a, **k):
        inputs = list(inputs)
        use = [i for i, t in enumerate(inputs) if t.dim() == 3]
        res = grad(outputs, [inputs[i] for i in use], *a, **k)
        full = [None] * len(inputs)
        for i, g in zip(use, res):
            full[i] = g
        return tuple(full)

    net_mod.NerfNetwork.density_raw = no_mlp
    net_mod.NerfNetwork.rgb_from_features = no_head
    ttr.adam_update = lambda *a, **k: None
    torch.autograd.grad = used_only
    tr.graphs = False
    try:
        out["b"] = rate_and_steps(tr)
        out["b_by_stage"] = by_stage(tr)
    finally:
        net_mod.NerfNetwork.density_raw = density
        net_mod.NerfNetwork.rgb_from_features = rgb
        ttr.adam_update = adam
        torch.autograd.grad = grad
        tr.graphs = graphs
    print(json.dumps(out))


def main(roots):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [os.path.abspath(r) for r in roots] or [here]
    res = []
    for root in roots + roots[::-1]:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), CHILD],
                           cwd=root, capture_output=True, text=True,
                           timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"{root} failed:\n{p.stderr[-4000:]}")
        got = json.loads(p.stdout.strip().splitlines()[-1])
        res.append(got)
        a_sps, a_steps = got["a"]
        b_sps, b_steps = got["b"]
        print(f"{root} on {got['device']}: a settled step's device "
              f"operations by stage {[s['by_stage'] for s in got['by_stage']]}"
              f" ({[s['ops'] for s in got['by_stage']]} in all, busy "
              f"{[round(s['busy_ms'], 3) for s in got['by_stage']]} ms); "
              f"(a) as it is {a_sps:.2f} steps/s, busy / wall ms "
              f"{[[round(b, 3), round(w, 2)] for b, w in a_steps]}; (b) the "
              f"MLPs and Adam left out {b_sps:.2f} steps/s, "
              f"{[[round(b, 3), round(w, 2)] for b, w in b_steps]}, "
              f"{got['b_by_stage']['ops']} operations; (c) the step's Adam "
              f"{got['adam_ms']:.4f} ms, torch.optim.Adam(fused=True) "
              f"{got['fused_adam_ms']:.4f} ms on {got['adam_elements']} "
              f"elements", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    if sys.argv[1:] == [CHILD]:
        child()
    else:
        main(sys.argv[1:])
