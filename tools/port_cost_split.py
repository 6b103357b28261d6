"""Where the port's list walk and mesh plan spend their time on the card
(PERF.md section 6 rows 11-12, section 7): kernel variants built from
edited copies of the sources, each timed in turns with the others on the
exact and multi-cascade 720p frames' own first-epoch calls.

    mkdir -p _chipwork/before
    git archive 82e6be5 nerf_glasses_tpu_torch | tar -x -C _chipwork/before
    python3 tools/port_cost_split.py _chipwork/before > split.log 2>&1

DIR holds the package as it was at commit 82e6be5 (its list walk wrote a
lane's rows itself, its plan wrote every tile's rays). Under _chipwork/split/
(git-ignored) the script writes copies of DIR's ops/march_cuda.py and
csrc/march.cu with one edit each:
- nostore: the list walk writes no row (its first rows, slot bits and
  ends only; the found slots' t then go unused, and their local array
  with them);
- noatomic: each warp's rows at a fixed place instead of the row
  counter's;
- owner_stage: a lane puts its own rows into shared memory a 64-row chunk
  at a time and the warp writes each chunk contiguous (this tree's
  design's first form: a lane a row instead, the slots' t in shared
  memory);
and of this tree's csrc/frame.cu: bins_only, the plan without its rays.
Each list walk runs on the frame's list and on an identity list over the
gathered copy of the same rays (what the scattered reads cost), bit for
bit this tree's per slot (list_slot_rows) where the variant writes its
rows, beside the fused walk on the gathered copy; with
cuobjdump -res-usage and the LDL/STL count of each LIST instance. Device
time by torch.profiler with L2 flushed (chip_smoke.kernel_device_ms).
Needs one NVIDIA GPU and nvcc.
"""
import concurrent.futures
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerf_glasses_tpu_torch.ops import (cuda_build, frame_cuda,  # noqa: E402
                                        march_cuda, mesh_cuda, network_cuda)

REPS = 20
OUT = os.path.join(ROOT, "_chipwork", "split")

# 82e6be5's list walk: a lane's rows, written by the lane
BEFORE_ROWS = """      // (the room is K x the list's length, all a list can fill from row
      // 0; the bound keeps a caller's count that did not start at 0 from
      // writing past it)
      for (int q = 0; q < n_found && first + q < a.row_cap; ++q) {
        const long long row = first + q;
        const float tk = t_found[q];
        float p[3];
        at(r, tk, p);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a.row_pos01[3 * row + c] = __fdiv_rn(__fsub_rn(p[c], lo[c]), ext[c]);
          a.row_dir01[3 * row + c] = dir01[c];
        }
        a.row_ts[row] = tk;
        a.row_dt[row] = calc_dt(tk - t0, P);
      }
"""
OWNER_STAGE_ROWS = """      float* const s_pos = s_rows[threadIdx.x >> 5];
      float* const s_dir = s_pos + 3 * 64;
      float* const s_ts = s_pos + 6 * 64;
      float* const s_dt = s_pos + 7 * 64;
      const int excl = incl - n_found;
      for (int c0 = 0; c0 < total; c0 += 64) {
        const int q1 = min(n_found, c0 + 64 - excl);
        for (int q = max(c0 - excl, 0); q < q1; ++q) {
          const int w = excl + q - c0;
          const float tk = t_found[q];
          float p[3];
          at(r, tk, p);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            s_pos[3 * w + c] = __fdiv_rn(__fsub_rn(p[c], lo[c]), ext[c]);
            s_dir[3 * w + c] = dir01[c];
          }
          s_ts[w] = tk;
          s_dt[w] = calc_dt(tk - t0, P);
        }
        __syncwarp();
        const long long row0 = (long long)base + c0;
        const int len = (int)max(min((long long)min(64, total - c0),
                                     a.row_cap - row0), 0LL);
        for (int x = lane; x < 3 * len; x += 32) {
          a.row_pos01[3 * row0 + x] = s_pos[x];
          a.row_dir01[3 * row0 + x] = s_dir[x];
        }
        for (int x = lane; x < len; x += 32) {
          a.row_ts[row0 + x] = s_ts[x];
          a.row_dt[row0 + x] = s_dt[x];
        }
        __syncwarp();
      }
"""
BEFORE_T = "    float t_found[LIST ? MAX_LIST_STEPS : 1];"
BEFORE_ATOMIC = ("      if (lane == 31u && total > 0) base = "
               "atomicAdd(a.row_count, total);")
WALK_EDITS = {
    "nostore": [(BEFORE_ROWS, "      (void)lo; (void)ext; (void)dir01; (void)first;\n")],
    "noatomic": [(BEFORE_ATOMIC, """      if (lane == 31u && total > 0)
        base = (int)((blockIdx.x * (WALK_THREADS / 32) + (threadIdx.x >> 5))
                     * 32 * P.steps);""")],
    "owner_stage": [(BEFORE_ROWS, OWNER_STAGE_ROWS),
                    (BEFORE_T, BEFORE_T + "\n    __shared__ float s_rows[LIST ? "
                     "WALK_THREADS / 32 : 1][LIST ? 8 * 64 : 1];")],
}
PLAN_EDITS = {"bins_only": [(
    "  if (count == 0) return;              // (the block's total: uniform)",
    "  return;                             // the lists alone: no ray")]}


def variant(src_pkg, name, module, source, edits):
    """A copy of src_pkg's ops/<module>.py and csrc/<source> under
    OUT/name with `edits` (old, new) made in the source -> its DIR."""
    pkg = os.path.join(OUT, name, "nerf_glasses_tpu_torch")
    os.makedirs(os.path.join(pkg, "ops"), exist_ok=True)
    os.makedirs(os.path.join(pkg, "csrc"), exist_ok=True)
    shutil.copy(os.path.join(src_pkg, "ops", f"{module}.py"),
                os.path.join(pkg, "ops", f"{module}.py"))
    with open(os.path.join(src_pkg, "csrc", source)) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor is not in "
                               f"{src_pkg}/csrc/{source} once")
        text = text.replace(old, new)
    with open(os.path.join(pkg, "csrc", source), "w") as f:
        f.write(text)
    return os.path.join(OUT, name)


def res_usage(module, label):
    """Registers, stack and local bytes (cuobjdump -res-usage) and LDL/STL
    instructions (-sass) of each walk_kernel LIST instance."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    lib = module.load_library()._name

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, check=True).stdout.splitlines()

    def name_of(line):
        k = cs.MARCH_KERNEL_NAME.search(line)
        return (f"{k.group(1)}<" + ", ".join(re.findall(r"L[ib](\d+)E",
                                                         k.group(2))) + ">"
                if k else None)

    out, cur = {}, None
    for line in dump("-res-usage"):
        if "Function" in line:
            cur = name_of(line)
        elif cur and cs.RES_USAGE.search(line):
            out[cur] = list(map(int, cs.RES_USAGE.search(line).groups())) + [0]
    cur = None
    for line in dump("-sass"):
        if "Function :" in line:
            cur = name_of(line)
        elif cur in out and cs.LOCAL_OP.search(line):
            out[cur][3] += 1
    for k, (reg, stack, local, ldst) in sorted(out.items()):
        if k.startswith("walk_kernel") and k.endswith(", 1>"):
            print(f"{label} {k}: {reg} registers, {stack} stack, {local} "
                  f"local bytes, {ldst} LDL/STL")


def walk_split(calls, label, others):
    """Each list walk version in turns on the recorded first epoch (the
    advance + samples form and the samples form), on the list and on an
    identity list over the gathered copy, beside the fused walk on the
    gathered copy."""
    gathered = cs.gathered_calls(calls)
    held = {"walk_list": calls["walk_list"],
            "walk_list:samples": cs.samples_form_call(calls)}
    for key, args in held.items():
        gname = "advance_samples" if key == "walk_list" else "samples"
        frame, ids, n = args[:3]
        idl = ids[:n].long()
        dense = dict(frame)
        for k in march_cuda._STATE:
            dense[k] = frame[k][idl].contiguous()
        ident = (dense, torch.arange(n, dtype=torch.int32, device=ids.device),
                 n) + tuple(args[3:])
        ref = cs.list_copy("walk_list", args)
        march_cuda.walk_list(*ref)
        torch.cuda.synchronize()
        ref_out = cs.list_outputs("walk_list", ref)
        versions = []
        for vlabel, mod in [("this tree", march_cuda)] + others:
            for lst, a in (("list", args), ("identity list", ident)):
                work = cs.list_copy("walk_list", a)
                mod.walk_list(*work)
                torch.cuda.synchronize()
                same = cs.same_bits(cs.list_outputs("walk_list", work, mod),
                                    ref_out)
                print(f"{label} {key} {vlabel} on the {lst}: per slot bit "
                      f"for bit this tree's on the frame's list: {same}")
                cs.list_restore("walk_list", work, a)
                versions.append((f"{vlabel} {lst}", (
                    lambda mod=mod, work=work, a=a: cs.march_ms(
                        "walk_list", lambda: mod.walk_list(*work), REPS,
                        lambda: cs.list_restore("walk_list", work, a)))))
        g_args = gathered[gname]
        versions.append((f"fused {gname} (gathered)", lambda: cs.march_ms(
            gname, lambda: getattr(march_cuda, gname)(*g_args), REPS)))
        times = {v: [] for v, _ in versions}
        for v, fn in versions + versions[::-1]:
            times[v].append(fn())
        b_ms, _ = cs.march_bound(key, args)
        print(f"{label} {key}: {n} listed rays, {int(ref[7][0])} rows, bound "
              f"{b_ms:.4f} ms; device ms in turns (torch.profiler, L2 "
              f"flushed):")
        for v, ts in times.items():
            print(f"  {v:34s} " + ", ".join(f"{t:.4f}" for t in ts)
                  + f"  mean {np.mean(ts):.4f}")


def plan_split(renderer, label, others):
    """This tree's mesh plan against the plain plan (busy tiles' rays and
    the triangles bit for bit), then each version in turns."""
    renderer.update_model_view_proj()
    args, kw = cs.first_frame_calls(renderer.frame)["mesh_plan"]
    out_k = frame_cuda.mesh_plan(*args, **kw)
    out_p = frame_cuda.mesh_plan_reference(*args, **kw)
    torch.cuda.synchronize()
    busy, nt = out_p["tile_counts"] > 0, out_p["tile_counts"].shape[0]
    bit = cs.same_bits(out_k["tri_scalars"], out_p["tri_scalars"]) and all(
        cs.same_bits(out_k[k].view(nt, -1, 3)[busy],
                     out_p[k].view(nt, -1, 3)[busy]) for k in ("o", "d"))
    b_ms, b_by, nbytes = cs.frame_bound("mesh_plan", args, kw, out_k)
    print(f"{label} mesh_plan vs plain: "
          f"{frame_cuda.compare_with_plain('mesh_plan', out_k, out_p)}; busy "
          f"tiles' rays and triangles bit for bit the card's plain version: "
          f"{bit}; {int(busy.sum())} of {nt} tiles busy; bound {b_ms:.4f} ms "
          f"({b_by}, {nbytes / 1e6:.3f} MB)")
    versions = [("this tree", frame_cuda)] + others
    times = {v: [] for v, _ in versions}
    for v, m in (versions + versions[::-1]) * 2:
        times[v].append(cs.frame_kernel_ms(
            "mesh_plan", lambda m=m: m.mesh_plan(*args, **kw), REPS, m)[0])
    print(f"{label} mesh_plan device ms in turns (torch.profiler, L2 flushed):")
    for v, ts in times.items():
        print(f"  {v:20s} " + ", ".join(f"{x:.4f}" for x in ts)
              + f"  mean {np.mean(ts):.4f}")


def main(tmp, before):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the split runs on the GPU only")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    src = os.path.join(before, "nerf_glasses_tpu_torch")
    walk_dirs = [before] + [variant(src, name, "march_cuda", "march.cu", edits)
                          for name, edits in WALK_EDITS.items()]
    plan_dirs = [before] + [variant(os.path.join(ROOT, "nerf_glasses_tpu_torch"),
                                  name, "frame_cuda", "frame.cu", edits)
                          for name, edits in PLAN_EDITS.items()]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(m.load_library) for m in
                  (mesh_cuda, march_cuda, network_cuda, frame_cuda)]:
            f.result()
    walk_others = [(os.path.basename(p), m) for p, m in
                   cs.other_checkouts(walk_dirs, "march_cuda")]
    plan_others = [(os.path.basename(p), m) for p, m in
                   cs.other_checkouts(plan_dirs, "frame_cuda")]
    for label, m in [("this tree", march_cuda)] + walk_others:
        res_usage(m, label)
    glasses = os.path.join(tmp, "glasses.gltf")
    cs.write_glasses_gltf(glasses)
    renderer, _ = cs.make_renderer(dev, cs.W, cs.H, glasses)
    renderer.frame()
    plan_split(renderer, "exact 720p", plan_others)
    renderer.update_model_view_proj()
    walk_split(cs.first_march_calls(renderer.frame), "exact 720p",
               walk_others)
    print(f"[exact frame: {time.perf_counter() - t0:.1f} s]")
    # the multi-cascade scene as chip_smoke.py phase 22 trains it
    ds, _, _ = cs.capture_phase(dev, lambda n: None)
    ds4 = dataclasses.replace(
        ds, aabb_scale=cs.MC_AABB_SCALE,
        render_aabb=cs.BoundingBox([cs.MC_AABB[0]] * 3, [cs.MC_AABB[1]] * 3))
    tr = cs.ttr.Trainer(ds4, cs.ttr.TrainOptions(
        config=cs.NGPConfig.native_fast(aabb_scale=cs.MC_AABB_SCALE)),
        seed=3, device=dev)
    tr.train(cs.MC_TRAIN_STEPS)
    snap = os.path.join(tmp, "multicascade.msgpack")
    tr.save_snapshot(snap)
    del tr
    renderer, _ = cs.make_renderer(dev, cs.W, cs.H, glasses, snap, cs.MC_AABB)
    renderer.frame()
    renderer.update_model_view_proj()
    walk_split(cs.first_march_calls(renderer.frame),
               "multi-cascade exact 720p", walk_others)
    plan_split(renderer, "multi-cascade exact 720p", plan_others)
    print(f"[done: {time.perf_counter() - t0:.1f} s]")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    with tempfile.TemporaryDirectory() as d:
        main(d, os.path.abspath(sys.argv[1]))
