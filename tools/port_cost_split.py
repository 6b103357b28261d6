"""Where the port's kernels spend their time on the card (PERF.md section
6 rows 7-9 and 11-13, section 7): kernel variants built from edited copies
of the sources, each timed in turns with the others on the 720p frames'
own calls (the encode's backward: on the settled trainer's own step).
Four splits:

    mkdir -p _chipwork/before
    git archive 82e6be5 nerf_glasses_tpu_torch | tar -x -C _chipwork/before
    python3 tools/port_cost_split.py walk _chipwork/before > split.log 2>&1

    mkdir -p _chipwork/parent
    git archive 37ce2e7 nerf_glasses_tpu_torch | tar -x -C _chipwork/parent
    python3 tools/port_cost_split.py shade _chipwork/parent [DIR ...] > shade.log 2>&1

    mkdir -p _chipwork/parent
    git archive 29e255e nerf_glasses_tpu_torch | tar -x -C _chipwork/parent
    python3 tools/port_cost_split.py encode _chipwork/parent [DIR ...] > encode.log 2>&1

    python3 tools/port_cost_split.py backward [DIR ...] > backward.log 2>&1

walk: DIR holds the package as it was at commit 82e6be5 (its list walk
wrote a lane's rows itself, its plan wrote every tile's rays). Under
_chipwork/split/ (git-ignored) the script writes copies of DIR's
ops/march_cuda.py and csrc/march.cu with one edit each:
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
cuobjdump -res-usage and the LDL/STL count of each LIST instance, and the
mesh plan's variants on the exact and multi-cascade frames.

shade: DIR holds the package as it was at commit 37ce2e7 (a thread a NeRF
pixel in the surface shade). Copies of DIR's ops/frame_cuda.py and
csrc/frame.cu with one edit each:
- zeros: every pixel written as zeros, the busy ones too (no hit read,
  nothing shaded), as four 4-byte stores and a depth store;
- zeros16: zeros with the colour as one 16-byte store;
- shade_only: the busy tiles' pixels alone, shaded; the others unwritten;
and of this tree's: nofill (the shading alone, the idle tiles' pixels
unwritten) and noshade (everything but shade_hit: a hit's colour its t);
each timed in turns with DIR's kernel, those of any further DIRs (other
forms of the kernel, each a package with ops/frame_cuda.py and
csrc/frame.cu) and this tree's on the exact frame's own surface shade
call (each compared with this tree's bit for bit). Then the f32 bodies on
the f32 frame's first-epoch calls (chip_smoke.py phase 4b): DIR's and
this tree's rgb head and density MLP, and the further DIRs' that have
ops/network_cuda.py, each beside its bound with the launches a frame
times the time over the bound, and each rgb_head_kernel and mlp_kernel
instance's registers, stack, LDL/STL and SASS instructions, with the
opcodes whose counts differ from DIR's.

encode: DIR holds the package as it was at commit 29e255e (a thread a
(sample, level) in the standalone hash encode, i = sample * L + level
divided by L in 64 bits, the output a thread's F features). Copies of
DIR's ops/network_cuda.py and csrc/network.cu with one edit each:
- nostore: no output store (the sums kept live by a store that never
  runs);
- nogather: no table load (each corner's row made from its index in
  registers; the stores kept);
- idx32: the sample and level from 32-bit arithmetic in place of i / L;
and of this tree's: tree_nogather (no table load); each timed in turns
with DIR's kernel, any further DIRs' and this tree's on the f32 frame's
first-epoch encode call (chip_smoke.py phase 4b), each compared with
this tree's bit for bit, beside the bound; with, for each version's f32
and bf16 instance at F = 4, how many of its table loads issue before
the first instruction that reads one (cuobjdump -sass). Then the f32
bodies and the encode on that frame's calls as in shade (f32_split),
against DIR's and any further DIRs'. Every variant builds in parallel.

backward: the encode's backward on the settled trainer's own step
(chip_smoke.py phase 14b's call: trained_head_v6 resumed on the capture,
16 steps, then one step's first call). Copies of this tree's
ops/network_cuda.py and csrc/network.cu with one edit each to
nmr_hash_encode_backward:
- stores: each row stored, not added (a race: timing only);
- noadd: no row written at all (the index and weight work alone);
each timed in turns with this tree's (and any further DIRs' that have
the wrapper, held to the contract) on the step's call, beside the bound
and one index_add_ of the same rows.

Device time by torch.profiler with L2 flushed (chip_smoke.kernel_device_ms).
Needs one NVIDIA GPU and nvcc.
"""
import collections
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
# 37ce2e7's surface shade: a thread a NeRF pixel
SHADE_EDITS = {
    "zeros": [("  if (a.counts[tile] > 0) {\n", "  if (false) {\n")],
    "zeros16": [("  if (a.counts[tile] > 0) {\n", "  if (false) {\n"),
                ("#pragma unroll\n  for (int c = 0; c < 4; ++c) "
                 "a.rgba[4 * i + c] = acc[c];\n",
                 "  reinterpret_cast<float4*>(a.rgba)[i] =\n"
                 "      make_float4(acc[0], acc[1], acc[2], acc[3]);\n")],
    "shade_only": [("  const int tile = ty * P.ntx + tx;\n  float acc[4]",
                    "  const int tile = ty * P.ntx + tx;\n"
                    "  if (a.counts[tile] == 0) return;\n  float acc[4]")],
}
# this tree's surface shade: its shading alone, its work without the
# shading
TREE_SHADE_EDITS = {
    "nofill": [("    else\n      fill_unit(P, a, s_busy, (unsigned)(u - n_shade)"
                " * FILL_PIXELS, n_out);\n", "")],
    "noshade": [("        shade_hit(P, a, nrm_mats, id, a.u[r], a.v[r], t, d, "
                 "rgb);\n", "        rgb[0] = rgb[1] = rgb[2] = t;\n")],
}
# this tree's standalone encode with no table load (timing only)
TREE_ENCODE_EDITS = {
    "tree_nogather": [(
        "  for (int c = 0; c < 8; ++c) load_row<F>(lvl + (long long)idx[c] * F, v[c]);\n",
        "  for (int c = 0; c < 8; ++c)   // no load: a row from the index\n"
        "#pragma unroll\n    for (int f = 0; f < F; ++f)\n"
        "      v[c][f] = __uint_as_float(0x3f800000u | (idx[c] & 7u));\n")],
}
# 29e255e's standalone encode: a thread a (sample, level)
ENCODE_EDITS = {
    "nostore": [(
        "    const long long o = i * F;                // (s * L + l) * F\n",
        "    if (__fadd_rn(__fadd_rn(acc[0], acc[F > 1 ? 1 : 0]),\n"
        "                  __fadd_rn(acc[F > 2 ? 2 : 0], acc[F - 1])) !=\n"
        "        1.5e-38f)\n"
        "      continue;             // always: the sums live, never stored\n"
        "    const long long o = i * F;                // (s * L + l) * F\n")],
    "nogather": [(
        "    float v[F];\n    load_row<F>(lvl + (long long)idx * F, v);\n",
        "    float v[F];\n    (void)lvl;\n#pragma unroll\n"
        "    for (int f = 0; f < F; ++f)     // no load: a row from the index\n"
        "      v[f] = __uint_as_float(0x3f800000u | (idx & 7u));\n")],
    "idx32": [(
        "    const long long s = i / L;\n    const int l = (int)(i - s * L);\n",
        "    const unsigned s = (unsigned)i / (unsigned)L;\n"
        "    const int l = (int)((unsigned)i - s * (unsigned)L);\n")],
}
# this tree's encode backward
BACKWARD_EDITS = {
    "stores": [("      atomic_add_row<F>(lvl + (long long)idx[c] * F, v);\n",
                "      for (int f = 0; f < F; ++f)   // a race: timing only\n"
                "        lvl[(long long)idx[c] * F + f] = v[f];\n")],
    "noadd": [("      atomic_add_row<F>(lvl + (long long)idx[c] * F, v);\n",
               "      if (v[0] == 1.5e-38f)   // never: the rows live, unwritten\n"
               "        atomic_add_row<F>(lvl + (long long)idx[c] * F, v);\n")],
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


def f32_instances(module, label):
    """Registers, stack bytes, LDL/STL and SASS instructions of each f32
    rgb_head_kernel and mlp_kernel instance in `module`'s library
    (cuobjdump) -> each instance's count of each SASS opcode."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    lib = module.load_library()._name

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, check=True).stdout.splitlines()

    def name_of(line):
        k = cs.KERNEL_NAME.search(line)
        return (cs.instance_name(k) if k and k.group(1) in (
            "rgb_head_kernel", "mlp_kernel") else None)

    out, ops, cur = {}, {}, None
    for line in dump("-res-usage"):
        if "Function" in line:
            cur = name_of(line)
        elif cur and cs.RES_USAGE.search(line):
            out[cur] = list(map(int, cs.RES_USAGE.search(line).groups())) + [0]
            ops[cur] = collections.Counter()
    cur = None
    for line in dump("-sass"):
        if "Function :" in line:
            cur = name_of(line)
        elif cur in out:
            m = cs.SASS_OP.search(line)
            if m:
                ops[cur][m.group(2)] += 1
            if cs.LOCAL_OP.search(line):
                out[cur][3] += 1
    for k, (reg, stack, local, ldst) in sorted(out.items()):
        print(f"{label} {k}: {reg} registers, {stack} stack, {local} local "
              f"bytes, {ldst} LDL/STL, {sum(ops[k].values())} SASS "
              f"instructions")
    return ops


def sass_diffs(versions):
    """versions: [(label, f32_instances' counts)], the first the base:
    for each other version's instance, the opcodes whose counts differ
    from the base's."""
    (base_label, base), rest = versions[0], versions[1:]
    for label, ops in rest:
        for k in sorted(set(base) & set(ops)):
            d = {op: ops[k][op] - base[k][op] for op in base[k] | ops[k]
                 if ops[k][op] != base[k][op]}
            print(f"{label} {k} SASS against {base_label}'s: "
                  + (", ".join(f"{op} {n:+d}" for op, n in sorted(d.items()))
                     or "the same opcodes and counts"))


SASS_LOAD = re.compile(r"^LDG\.E(?:\.(64|128))?")
SASS_REG = re.compile(r"\bR(\d+)\b")


def loads_in_flight(module, label):
    """For hash_encode_kernel<4, f32> and <4, bf16> in `module`'s library
    (cuobjdump -sass): each run of global loads that issue before the
    first instruction that reads one of them (their destination
    registers), the run's length; a gather of 8 corner rows whose loads
    are all in flight before the first add shows runs of 8 or more."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    lib = module.load_library()._name
    lines = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    funcs, cur = {}, None
    for line in lines:
        if "Function :" in line:
            k = cs.KERNEL_NAME.search(line)
            cur = cs.instance_name(k) if k and k.group(1) == (
                "hash_encode_kernel") and k.group(2) == "4" else None
            if cur:
                funcs[cur] = []
        elif cur:
            m = cs.SASS_OP.search(line)
            if m:
                funcs[cur].append((m.group(2), m.group(3)))
    for name, ops in sorted(funcs.items()):
        runs, pending, run = [], set(), 0
        for op, args in ops:
            regs = [int(r) for r in SASS_REG.findall(args)]
            ld = SASS_LOAD.match(op)
            srcs = regs if op.startswith(("ST", "RED", "ATOM")) else regs[1:]
            if pending & set(srcs):
                runs.append(run)
                pending, run = set(), 0
            if ld and regs:
                width = {"64": 2, "128": 4}.get(ld.group(1), 1)
                pending |= set(range(regs[0], regs[0] + width))
                run += 1
        print(f"{label} {name}: {len(ops)} SASS instructions; table and "
              f"position loads issued before the first use of one, run by "
              f"run: {runs}")


def encode_split(args, label, others):
    """The standalone encode's versions in turns on the f32 frame's first
    call, each against this tree's bit for bit, beside the bound."""
    with torch.no_grad():
        got = network_cuda.hash_encode(*args)
        torch.cuda.synchronize()
        b_ms, b_by = cs.network_bound("hash_encode", args)
        print(f"{label} hash_encode: {args[1].shape[0]} samples, bound "
              f"{b_ms:.4f} ms ({b_by}); against the plain version "
              f"{network_cuda.compare_with_plain('encode', got, network_cuda.hash_encode_reference(*args), args[3])}")
        for v, m in others:
            print(f"{label} hash_encode of {v} bit for bit this tree's: "
                  f"{cs.same_bits(m.hash_encode(*args), got)}")
        versions = others + [("this tree", network_cuda)]
        times = {v: [] for v, _ in versions}
        for v, m in (versions + versions[::-1]) * 2:
            times[v].append(cs.kernel_device_ms(
                "hash_encode", lambda m=m: m.hash_encode(*args), REPS))
    print(f"{label} hash_encode device ms in turns (torch.profiler, L2 "
          f"flushed):")
    for v, ts in times.items():
        print(f"  {v:20s} " + ", ".join(f"{x:.4f}" for x in ts)
              + f"  mean {np.mean(ts):.4f}, {b_ms / np.mean(ts):.1%} of the "
              f"bound")


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


def shade_split(renderer, label, others):
    """The surface shade's versions in turns on the frame's own call, this
    tree's against the plain version and bit for bit each other's."""
    renderer.update_model_view_proj()
    args, kw = cs.first_frame_calls(renderer.frame)["surface_shade"]
    out_k = frame_cuda.surface_shade(*args, **kw)
    out_p = frame_cuda.surface_shade_reference(*args, **kw)
    torch.cuda.synchronize()
    b_ms, b_by, nbytes = cs.frame_bound("surface_shade", args, kw, out_k)
    print(f"{label} surface_shade vs plain: "
          f"{frame_cuda.compare_with_plain('surface_shade', out_k, out_p)}; "
          f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.3f} MB)")
    for v, m in others:
        res = m.surface_shade(*args, **kw)
        torch.cuda.synchronize()
        print(f"{label} {v}: rgba and depth bit for bit this tree's: "
              f"{cs.same_bits(res, out_k)}")
    versions = others + [("this tree", frame_cuda)]
    times = {v: [] for v, _ in versions}
    for v, m in (versions + versions[::-1]) * 2:
        times[v].append(cs.frame_kernel_ms(
            "surface_shade", lambda m=m: m.surface_shade(*args, **kw), REPS,
            m)[0])
    print(f"{label} surface_shade device ms in turns (torch.profiler, L2 "
          f"flushed):")
    for v, ts in times.items():
        print(f"  {v:20s} " + ", ".join(f"{x:.4f}" for x in ts)
              + f"  mean {np.mean(ts):.4f}")


def f32_calls(renderer, nerf):
    """The f32 frame's first-epoch network calls (chip_smoke.py phase 4b)
    and the frame's launches of each wrapper."""
    saved = dict(nerf.march_overrides)
    nerf.march_overrides = {**saved, "compute_dtype": "float32"}
    try:
        renderer.update_model_view_proj()
        before = dict(network_cuda.launches)
        calls = cs.first_network_calls(renderer.frame)
        torch.cuda.synchronize()
        runs = {k: network_cuda.launches[k] - before[k] for k in before}
    finally:
        nerf.march_overrides = saved
    return calls, runs


def f32_split(renderer, nerf, label, others):
    """The f32 frame's first-epoch rgb head, density MLP and encode calls:
    each version's device time beside the bound, and launches x (time -
    bound) over the frame; the encode of the first of `others` (DIR)
    only."""
    calls, runs = f32_calls(renderer, nerf)
    with torch.no_grad():
        for name, mine in (("rgb_head", others), ("mlp", others),
                           ("hash_encode", others[:1])):
            args = calls[name]
            b_ms, b_by = cs.network_bound(name, args)
            got = getattr(network_cuda, name)(*args)
            torch.cuda.synchronize()
            versions = mine + [("this tree", network_cuda)]
            for v, m in mine:
                print(f"{label} f32 {name} of {v} bit for bit this tree's: "
                      f"{cs.same_bits(getattr(m, name)(*args), got)}")
            times = {v: [] for v, _ in versions}
            for v, m in versions + versions[::-1]:
                times[v].append(cs.kernel_device_ms(
                    name, lambda m=m: getattr(m, name)(*args), REPS))
            print(f"{label} f32 {name}: {runs[name]} launches a frame, "
                  f"{args[1 if name == 'hash_encode' else 0].shape[0]} rows "
                  f"on the first; bound {b_ms:.4f} "
                  f"ms ({b_by}); device ms in turns (torch.profiler, L2 "
                  f"flushed):")
            for v, ts in times.items():
                print(f"  {v:20s} " + ", ".join(f"{x:.4f}" for x in ts)
                      + f"  mean {np.mean(ts):.4f}; launches x (ms - bound) "
                      f"{runs[name] * (np.mean(ts) - b_ms):.3f} ms a frame")


def setup(tmp):
    """The card's name and limit printed, the kernels built -> the device
    and the glasses' path."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the split runs on the GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(m.load_library) for m in
                  (mesh_cuda, march_cuda, network_cuda, frame_cuda)]:
            f.result()
    glasses = os.path.join(tmp, "glasses.gltf")
    cs.write_glasses_gltf(glasses)
    return torch.device("cuda"), glasses


def main_shade(tmp, before, extra=()):
    t0 = time.perf_counter()
    dev, glasses = setup(tmp)
    src = os.path.join(before, "nerf_glasses_tpu_torch")
    here = os.path.join(ROOT, "nerf_glasses_tpu_torch")
    dirs = ([before]
            + [variant(src, name, "frame_cuda", "frame.cu", edits)
               for name, edits in SHADE_EDITS.items()]
            + [variant(here, name, "frame_cuda", "frame.cu", edits)
               for name, edits in TREE_SHADE_EDITS.items()] + list(extra))
    others = [(os.path.basename(p), m) for p, m in
              cs.other_checkouts(dirs, "frame_cuda")]
    net_others = [(os.path.basename(p), m) for p, m in
                  cs.other_checkouts([before] + list(extra), "network_cuda")]
    sass_diffs([(label, f32_instances(m, label))
                for label, m in net_others + [("this tree", network_cuda)]])
    renderer, nerf = cs.make_renderer(dev, cs.W, cs.H, glasses)
    renderer.frame()
    shade_split(renderer, "exact 720p", others)
    f32_split(renderer, nerf, "exact 720p", net_others)
    print(f"[done: {time.perf_counter() - t0:.1f} s]")


def main_encode(tmp, before, extra=()):
    t0 = time.perf_counter()
    dev, glasses = setup(tmp)
    src = os.path.join(before, "nerf_glasses_tpu_torch")
    here = os.path.join(ROOT, "nerf_glasses_tpu_torch")
    dirs = ([before] + [variant(src, name, "network_cuda", "network.cu",
                                edits)
                        for name, edits in ENCODE_EDITS.items()]
            + [variant(here, name, "network_cuda", "network.cu", edits)
               for name, edits in TREE_ENCODE_EDITS.items()]
            + list(extra))
    others = [(os.path.basename(p), m) for p, m in
              cs.other_checkouts(dirs, "network_cuda")]
    for label, m in others + [("this tree", network_cuda)]:
        loads_in_flight(m, label)
    net_others = [o for o in others if o[0] not in ENCODE_EDITS
                  and o[0] not in TREE_ENCODE_EDITS]
    sass_diffs([(label, f32_instances(m, label))
                for label, m in net_others + [("this tree", network_cuda)]])
    renderer, nerf = cs.make_renderer(dev, cs.W, cs.H, glasses)
    renderer.frame()
    encode_split(f32_calls(renderer, nerf)[0]["hash_encode"], "exact 720p f32",
                 others)
    f32_split(renderer, nerf, "exact 720p", net_others)
    print(f"[done: {time.perf_counter() - t0:.1f} s]")


def settled_step_calls(dev):
    """chip_smoke.py phase 14b's recorded calls: the capture, trained_head_v6
    resumed and 16 steps, then one step's first calls -> {wrapper: args}."""
    ds, _, _ = cs.capture_phase(dev, lambda n: None)
    tr = cs.ttr.Trainer(ds, cs.ttr.TrainOptions(
        config=cs.NGPConfig.native_fast()), seed=3, device=dev)
    tr.load_snapshot(cs.SNAPSHOT)
    tr.train(cs.RATE_SETTLED[0])
    if tr.step % tr.opts.grid_update_interval == 0:
        tr.train(1)
    return cs.first_train_calls(lambda: tr.train(1))


def main_backward(tmp, extra=()):
    t0 = time.perf_counter()
    dev, _ = setup(tmp)
    here = os.path.join(ROOT, "nerf_glasses_tpu_torch")
    net = [(os.path.basename(p), m) for p, m in cs.other_checkouts(
        [variant(here, name, "network_cuda", "network.cu", edits)
         for name, edits in BACKWARD_EDITS.items()] + list(extra),
        "network_cuda")]
    args = settled_step_calls(dev)["hash_encode_backward"]
    table, pos, grad, cfg, dtype, _ = args
    want = network_cuda.hash_encode_backward_reference(*args)
    b_ms, b_by = cs.bound_ms(*network_cuda.encode_backward_work(
        table, pos, cfg, dtype))
    ids, rows = network_cuda.backward_rows(table, pos, grad, cfg, dtype)
    flat = torch.zeros((table.shape[0] * table.shape[1], table.shape[2]),
                       device=dev)
    lib_ms = cs.cuda_ms(lambda: flat.index_add_(0, ids, rows), REPS)
    print(f"settled step hash_encode_backward: {pos.shape[0]} samples, "
          f"{rows.shape[0]} rows added, bound {b_ms:.5f} ms ({b_by}), one "
          f"index_add_ of the rows {lib_ms:.4f} ms by events")

    def check(label, got):
        if label.endswith(tuple(f" of {v}" for v in BACKWARD_EDITS)):
            return
        r = network_cuda.compare_gradients(got, want)
        print(f"  {label}: table gradient {r['table']['rel']:.2e} of max |g|")
        if not r["ok"]:
            raise AssertionError(f"{label} disagrees: {r}")

    have = [(v, m) for v, m in net if hasattr(m, "hash_encode_backward")]
    cs.in_turns(have, network_cuda, "hash_encode_backward", check, args,
                lambda fn: cs.kernel_device_ms("hash_encode_backward", fn,
                                               REPS))
    print(f"[done: {time.perf_counter() - t0:.1f} s]")


def main(tmp, before):
    t0 = time.perf_counter()
    dev, glasses = setup(tmp)
    src = os.path.join(before, "nerf_glasses_tpu_torch")
    walk_dirs = [before] + [variant(src, name, "march_cuda", "march.cu", edits)
                          for name, edits in WALK_EDITS.items()]
    plan_dirs = [before] + [variant(os.path.join(ROOT, "nerf_glasses_tpu_torch"),
                                  name, "frame_cuda", "frame.cu", edits)
                          for name, edits in PLAN_EDITS.items()]
    walk_others = [(os.path.basename(p), m) for p, m in
                   cs.other_checkouts(walk_dirs, "march_cuda")]
    plan_others = [(os.path.basename(p), m) for p, m in
                   cs.other_checkouts(plan_dirs, "frame_cuda")]
    for label, m in [("this tree", march_cuda)] + walk_others:
        res_usage(m, label)
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
    if len(sys.argv) < 2 or sys.argv[1] not in ("walk", "shade", "encode",
                                                "backward") or (
            sys.argv[1] == "walk" and len(sys.argv) != 3) or (
            sys.argv[1] in ("shade", "encode") and len(sys.argv) < 3):
        sys.exit(__doc__)
    with tempfile.TemporaryDirectory() as d:
        if sys.argv[1] == "backward":
            main_backward(d, [os.path.abspath(x) for x in sys.argv[2:]])
        elif sys.argv[1] == "walk":
            main(d, os.path.abspath(sys.argv[2]))
        elif sys.argv[1] == "encode":
            main_encode(d, os.path.abspath(sys.argv[2]),
                        [os.path.abspath(x) for x in sys.argv[3:]])
        else:
            main_shade(d, os.path.abspath(sys.argv[2]),
                       [os.path.abspath(x) for x in sys.argv[3:]])
