// The exact march's per-ray loops for Hopper: one thread per ray.
//
// None of them replaces a Pallas kernel. The JAX package runs each loop
// as a fori_loop inside its one compiled march (nerf_glasses_tpu/ops/
// raymarch.py), because the TPU could not gather from its fast memory
// inside a kernel (docs/KERNELS.md section 2); the port ran them as
// eager aten ops, about 15 launches a probe iteration. Here:
//   walk_kernel       (nmr_march_walk)      one body for the march's
//       walks, four forms a route: the advance pass alone (ops/
//       march_cuda.py::advance; JAX raymarch.py:730-764), a round's K
//       samples of <= skip_iters probes alone (::samples; JAX
//       raymarch.py:782-812), the advance followed by the first round's
//       samples in the same thread (::advance_samples), and init_rays'
//       bounded walk (::init_walk; JAX raymarch.py:518-565);
//   composite_kernel  (nmr_march_composite) ::composite, the round's
//       in-march surface blend, K-sample front-to-back loop and final
//       surface blend from the network's rows; JAX _march_round after
//       the network (raymarch.py:873, :1005, :1031);
//   the list forms of the two (::walk_list, ::composite_list: the
//       walk's advance + samples and samples forms, composite_list_kernel)
//       that the exact epoch of unbaked sequential rounds runs
//       (raymarch._march_lists), described below.
//   training_samples_kernel (nmr_training_samples) ::training_samples,
//       the trainer's geometry pass (train/trainer.py::
//       march_training_samples; JAX train/trainer.py:443-513, a
//       jax.lax.scan of march_hops hops inside the step's one program),
//       described at the kernel.
// A ray leaves its loop as soon as it settles, where the plain version
// masks it for the remaining iterations.
//
// What bounds the walks: on a frame's first-epoch advance, the length of
// the longest rays' probe chains, not bytes (7.4x the rays cost the
// first advance kernel 1.4x its time, 4x the probe cap 1.7x); on the
// init walk's 921,600 rays of up to 16 probes, the instructions issued
// (its time follows the rays almost linearly: PERF.md). Each probe is a
// chain of dependent steps, a gather among them, and the next probe
// waits for it. So the design shortens the chain and runs fewer of them:
// the fused form loads the state once and carries the advanced ray
// straight into its K slots (one launch, one wrapper call and one state
// read an epoch fewer, and the tail is the longest advance + samples
// rather than the longest advance plus the longest samples); divisions
// by powers of two are products by exact reciprocals, per-ray invariants
// leave the loop, cells are integers, exponents are read from the bits,
// and a probe that finds its voxel occupied stops there. The samples'
// slot stores stay coalesced (slot k of ray i at k * n + i). One block
// of 256 threads a tile of rays, scheduled as blocks finish; the init
// walk's tiles are 128 rays (its 256-thread instance compiled a longer
// probe loop and ran 1-2% slower). A persistent grid, a bit pyramid of
// the jump levels staged in shared memory, three exact rewrites of the
// clearance pyramid's six divisions by d (only the least quotient
// divided; a product by 1 / d with one or two FMA corrections) and a
// table of the ladder's expf(nb * lg) were measured and were slower
// (PERF.md): the IEEE division's and expf's own sequences are short.
//
// What bounds the composite: not its bytes (under a third of that bound:
// the per-ray state, the valid and colour-mask bytes, a used slot's ts,
// dt and raw density or alpha, each row's colour and slot; the row map
// is the design's scratch and not counted), but the round around it and
// the chain of loads a ray runs. The round's
// network leaves one row a used slot (14.6% of
// the slots on an exact frame's first epoch); the composite reads those
// rows where the network left them (the raw density a column of the
// density MLP's output, the raw colour) and applies the activations and
// alpha = 1 - exp(-sigma dt) itself, so the round no longer zero-fills
// dense (K, n) alpha and colour, gathers dt, runs the activations and
// the alpha chain as aten ops and scatters into the dense tensors (12 of
// the 13 device operations from the network to the composite's outputs).
// A slot finds its row in a row map that the entry's first kernel
// scatters from the rows' slots (row_map_kernel: one small launch where
// the aten tail was twelve; nothing fills the map, so a row number counts
// only where the row's slot is the slot that read it); a slot the loop
// does not use reads its valid byte and nothing else. The baked round keeps its dense alpha
// (from the baked sigma grid) and gives colour rows for the slots it
// colours. What is left bounds the kernel by latency: a used slot's
// loads wait for its row number, so a ray with many used slots runs a
// longer chain than the former kernel's one load a slot (PERF.md).
//
// The list forms: what an exact epoch reads and writes, not how it
// walks or blends. The JAX package (raymarch.py:1212-1238) and the port
// before them gathered eleven state arrays of the live rays into a
// compacted copy each epoch, built every slot's network input over all
// K x n slots (28.6 MB written for the 15% of slots used on a 720p
// frame's first epoch), listed the used slots with a host read and
// scattered seven arrays back: ~80 device operations and 3-4 host reads
// an epoch, more device time than the kernels. Here a thread takes ray
// ids[j] of the epoch's live-ray list and reads and writes the frame's
// own arrays through it. The walk (WALK_LIST) advances the ray, writes t
// and alive back, and gives each valid slot a row of the network's
// input: the rows of a warp are allocated with one atomicAdd on the
// row count, a lane's rows together and in slot order, so the rows'
// order is the warps' and not the slots' (the network's kernels give a
// row the same bits wherever it lies). A list entry hands the composite
// its first row and a bit a slot (the valid slots): slot k's row is the
// first row plus the valid slots below k. What bounds the list walk is
// writing those rows, not reading its rays through the list (PERF.md
// section 7: over an identity list on a dense copy it takes as long, and
// with no rows written 40% less): so a valid slot's t waits in shared
// memory (a column a thread), and once the warp's rows are allocated the
// warp makes them a lane a row, 32 at a time (the row's owner, its
// lane, found among the warp's prefix sums, its ray from the owner's
// registers by shuffle), and writes each array of the 32 rows as one
// contiguous run: consecutive lanes on consecutive words. (Were each
// lane to write its own rows, a warp's stores at each step would fall a
// ray's rows apart, and a lane with many rows would hold the others idle
// through its loop of divisions.) The composite finds its slots' rows
// so, writes the ray's state in place and appends the rays still alive
// to the next epoch's list: a block
// scan, one atomicAdd a block, so the next list keeps a block's rays
// together in the order of this one
// (the order changes no ray's result). The next epoch's walk reads the
// list's length from the device (it launches over the previous length):
// one host read an epoch gives that length and the row count together.
// The probe and blend arithmetic are the other forms' own, bit for bit.
//
// The probe (probe<ROUTE>) has the four routes of ops/march_cuda.py::
// _skip_probe, one template instance each, chosen on the host
// (probe_route): the cascade-0 jump levels + advance_to_next_voxel, the
// cascade-0 clearance grid (_dist_probe), the per-cascade clearance
// pyramid (_dist_probe_mips + _ladder_jump), the per-voxel DDA
// (_occupied + advance_to_next_voxel with its 8-step cone loop).
//
// Numerics: the plain version's float32 operations one by one. The build
// takes -fmad=false, so no product and sum fuse unless written fmaf; no
// fast math, so division and 1/x are IEEE, logf and expf the accurate
// ones aten calls on the card, and no result is flushed to zero. A
// division by 2^k is the product with 2^-k here, which rounds the same
// real number and so gives the same bits; a division by any other number
// (dt_min, dt_max, lg, d) stays a division.
// The activations are aten's on the card (exp, 1 / (1 + exp(-x)), relu
// and clamp keeping NaN). Python scalars of the plain version arrive as
// float32 values made on the host (MarchParams). torch semantics spelled
// out: clamp, minimum, maximum, amin and amax propagate NaN (nmin, nmax,
// clamp_lo, clamp_hi); nan_to_num maps NaN to 0 and +-inf to +-FLT_MAX;
// sign(d) + (d == 0); frexp's exponent; 2^k built from its bits. The
// render box's 3x3 `local` product is the one place where aten's order
// is a library's (a GEMM): it is taken as an FMA chain from the first
// term, exact for the identity (whose product is then skipped: the same
// containment test). On the card aten divides by a Python scalar as a
// product with its reciprocal; these kernels divide, as the CPU does, so
// they give the CPU plain version's bits and the card plain version may
// be a step apart (ops/march_cuda.py::compare_with_plain holds the
// count). The composite differs from its plain version in one case: a
// NaN colour row on a slot the loop does not use (a ray that saturated
// earlier in the round) leaves the ray's colour alone here and turns it
// to NaN there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Layout shared with ops/march_cuda.py::MarchParams.
struct MarchParams {
  int route;         // ROUTE_JUMP, ROUTE_DIST, ROUTE_DIST_MIPS, ROUTE_DDA
  int mode;          // walk: WALK_ADVANCE | WALK_SAMPLES
  int max_cascade;
  int min_mip;
  int iters;         // advance, init walk: probes
  int skip_iters;    // samples: probes a slot
  int steps;         // samples, composite: K
  int deferred;      // composite: the wn terms
  int stage;         // composite: STAGE_BLEND | STAGE_SAMPLES
  int density_act;   // composite: ACT_* of the network's density
  int rgb_act;       // composite: ACT_* of the network's colour
  float cone;        // cone_angle; 0 = constant dt
  float dt_min, dt_max;
  float t1, t2, t1_end, t2_cap, lg;   // _ladder_jump's constants
  float dtmip_cap;   // MAX_CONE_STEPSIZE - 1e-9
  float tau_den;     // 2 * G * cone_angle
  float inv_cone;    // 1 / cone where cone is a power of two, else 0
  float inv_tau_den; // 1 / tau_den likewise
  float sat_alpha;   // 1 - min_transmittance
  long long grid_numel;
};

// Layout shared with ops/march_cuda.py::WalkArgs: the walk's tensors.
struct WalkArgs {
  const float *o, *d, *t, *t_start, *t_surf, *surf_a;
  const uint8_t *alive, *grid;
  const float *box_lo, *box_hi, *local;
  float* t_out;          // advance
  uint8_t* alive_out;
  float *pos_k, *dt_k;   // samples
  uint8_t* valid_k;
  float *ts_k, *t_end;
  uint8_t *exited, *stopped;
  // the list form (WALK_LIST): ray ids[j] of the frame's arrays for
  // j < the list's length (*n_list, or n where it is null); t_out and
  // alive_out the frame's t and alive; t_end, exited, stopped indexed by
  // j; the rows' network inputs, t and dt, from row 0 on (*row_count
  // holds 0 at the launch); entry j's first row and its valid slots'
  // bits, bits 8b..8b+7 in byte b * length + j
  const int *ids, *n_list;
  const float *train_min, *train_max;
  float *row_pos01, *row_dir01, *row_ts, *row_dt;
  int *row_first, *row_count;
  uint8_t* slot_mask;
  long long row_cap;
};

// Layout shared with ops/march_cuda.py::CompositeArgs: the composite's
// tensors. The round's slots are (K, n), slot k of ray i at k * n + i;
// the network's rows are (M), one a slot of `color` (null: `valid`), row
// j that of slot slots[j]. `rows` (K * n) is scratch: the entry launch
// writes each such slot's row there (row_map_kernel) and the composite
// reads it; a row whose slot lies outside the K * n slots is left out,
// and a slot with no row has alpha 0 (without a dense alpha) and colour
// 0. Alpha comes dense (baked sigma) or from the rows' raw density
// `sigma` (its rows sigma_stride floats apart) and dt.
struct CompositeArgs {
  const float *rgba, *depth, *max_w, *wn, *surf_a, *t_round;
  const uint8_t* alive;
  const float *surf, *t_surf, *t_end;
  const uint8_t *exited, *stopped;
  const uint8_t *valid, *color;
  const float *ts_k, *dt_k, *alpha, *sigma, *rgb;
  const long long* slots;
  int* rows;
  long long sigma_stride, m;
  float *rgba_out, *depth_out, *max_w_out, *wn_out, *surf_a_out;
  uint8_t* alive_out;
  // the list form (ids non-null): ray ids[j]'s state read and written in
  // place in the frame's arrays (the *_out pointers are the inputs'; t
  // written from t_end); t_end, exited, stopped indexed by j; a slot's row
  // from the walk's first row and slot bits of entry j, the row's t and
  // dt beside its network outputs; the rays still alive appended to
  // next_ids from 0 on (*next_count holds 0 at the launch)
  const int *ids, *row_first;
  const uint8_t* slot_mask;
  const float *row_ts, *row_dt;
  float* t_out;
  int *next_ids, *next_count;
  long long next_cap;
};

// Layout shared with ops/march_cuda.py::TrainArgs: the training march's
// tensors. Slot k of ray i at k * n + i.
struct TrainArgs {
  const float *o, *d;              // (n, 3)
  const float* u;                  // (S, n) uniform draws
  const uint8_t* occ;              // the occupancy grid, grid_numel bytes
  const float *aabb_min, *aabb_max;
  float *t, *dt;                   // (S, n)
  uint8_t* valid;                  // (S, n)
};

namespace {

constexpr int G = 128;
constexpr float VOX = 1.0f / 128.0f;
constexpr float F32_MAX = 3.402823466e38f;
constexpr int THREADS = 128;        // composite
constexpr int WALK_THREADS = 256;   // the walks: one block a 256-ray tile
constexpr int INIT_THREADS = 128;   // the init walk's tile (PERF.md)
constexpr int MAX_LIST_STEPS = 64;  // the list walk's slot bits
// the list walk's staged t: slot q of thread x at q * T_STRIDE + x (the
// pad puts one owner's slots in different banks)
constexpr int T_STRIDE = WALK_THREADS + 1;
enum { ROUTE_JUMP = 0, ROUTE_DIST = 1, ROUTE_DIST_MIPS = 2, ROUTE_DDA = 3 };
enum { WALK_ADVANCE = 1, WALK_SAMPLES = 2, WALK_INIT = 4, WALK_LIST = 8 };
enum { STAGE_BLEND = 1, STAGE_SAMPLES = 2 };
// ops/network.py's activations; ACT_EXP_CLAMPED is the colour's
// exponential, exp(clamp(x, -10, 10))
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LOGISTIC = 2, ACT_EXP = 3,
       ACT_EXP_CLAMPED = 4 };

// torch.minimum / maximum / clamp: a NaN operand gives NaN.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x > hi ? hi : x;
}
// occupancy._cell and the probes' nan_to_num(q * G).trunc().clamp(0, G-1)
// as an integer: the conversion truncates, saturates and takes NaN to 0,
// which is what nan_to_num (NaN to 0, +-inf to +-FLT_MAX), trunc and the
// clamp give
__device__ __forceinline__ int cell_i(float q) {
  return min(max(__float2int_rz(q * (float)G), 0), G - 1);
}
// 2^e, exact
__device__ __forceinline__ float pow2i(int e) {
  return (e >= -126 && e <= 127) ? __int_as_float((e + 127) << 23)
                                 : ldexpf(1.0f, e);
}
// frexp's exponent, read from the bits of a normal number
__device__ __forceinline__ int frexp_e(float x) {
  const int field = (__float_as_int(x) >> 23) & 0xff;
  if (field != 0 && field != 0xff) return field - 126;
  int e = 0;
  frexpf(x, &e);
  return e;
}
// x / c for a host constant c, a product where c is a power of two
__device__ __forceinline__ float div_const(float x, float c, float inv_c) {
  return inv_c != 0.0f ? x * inv_c : x / c;
}

struct Box {
  float lo[3], hi[3], m[9];
  bool identity;     // local == I and finite bounds: q = p in every row
};

__device__ __forceinline__ Box load_box(const float* lo, const float* hi,
                                        const float* local) {
  Box b;
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b.lo[i] = __ldg(lo + i);
    b.hi[i] = __ldg(hi + i);
    finite = finite && isfinite(b.lo[i]) && isfinite(b.hi[i]);
  }
  bool eye = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    b.m[i] = __ldg(local + i);
    eye = eye && b.m[i] == (i % 4 == 0 ? 1.0f : 0.0f);
  }
  b.identity = eye && finite;
  return b;
}

// row r of (x @ local.T)
__device__ __forceinline__ float local_row(const Box& b, int r, const float x[3]) {
  return fmaf(x[2], b.m[3 * r + 2], fmaf(x[1], b.m[3 * r + 1], x[0] * b.m[3 * r]));
}

// _contains_local. With the identity the FMA chain gives p's own
// coordinate (a zero's sign aside) when p is finite, and NaN in every row
// when a coordinate is not, where the coordinate's own row fails the
// finite bounds as well.
__device__ __forceinline__ bool contains_local(const Box& b, const float p[3]) {
  bool in = true;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float q = b.identity ? p[r] : local_row(b, r, p);
    in = in && q >= b.lo[r] && q <= b.hi[r];
  }
  return in;
}

// _ray_exit_t: the render box's exit distance, -inf for a ray that misses
__device__ float ray_exit_t(const Box& b, const float o[3], const float d[3]) {
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float ol = local_row(b, r, o);
    const float inv = 1.0f / local_row(b, r, d);
    const float t0 = (b.lo[r] - ol) * inv;
    const float t1 = (b.hi[r] - ol) * inv;
    const float a = nmin(t0, t1), c = nmax(t0, t1);
    tmin = r == 0 ? a : nmax(tmin, a);
    tmax = r == 0 ? c : nmin(tmax, c);
  }
  if (tmin > tmax) tmax = F32_MAX;
  return tmax >= 3e38f ? -INFINITY : tmax;
}

__device__ __forceinline__ float calc_dt(float t, const MarchParams& P) {
  if (P.cone == 0.0f) return P.dt_min;
  return clamp_hi(clamp_lo(t * P.cone, P.dt_min), P.dt_max);
}

__device__ __forceinline__ int mip_from_pos(const float p[3], int max_cascade) {
  const float m = nmax(nmax(fabsf(p[0] - 0.5f), fabsf(p[1] - 0.5f)),
                       fabsf(p[2] - 0.5f));
  return min(max(frexp_e(m) + 1, 0), max_cascade);
}

__device__ __forceinline__ int mip_from_dt(float dt, const float p[3],
                                           int max_cascade) {
  const int mip = mip_from_pos(p, max_cascade);
  const float x = dt * (float)(2 * G);
  return x < 1.0f ? mip : min(max(frexp_e(x), mip), max_cascade);
}

// A ray and what its probes reuse: 1 / d, the DDA's half step
// 0.5 (sign(d) + (d == 0)), the clearance probes' d with 1 for 0.
struct Ray {
  float o[3], d[3], idir[3], half_s[3], safe_d[3];
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.o[c] = o[3 * i + c];
    r.d[c] = d[3 * i + c];
    r.idir[c] = 1.0f / r.d[c];
    const float s = (r.d[c] > 0.0f ? 1.0f : (r.d[c] < 0.0f ? -1.0f : 0.0f))
                    + (r.d[c] == 0.0f ? 1.0f : 0.0f);
    r.half_s[c] = 0.5f * s;
    r.safe_d[c] = r.d[c] == 0.0f ? 1.0f : r.d[c];
  }
  return r;
}

__device__ __forceinline__ void at(const Ray& r, float t, float p[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = r.o[c] + r.d[c] * t;
}

// occupancy.distance_to_next_voxel at res = 2^k (inv_res = 2^-k)
__device__ __forceinline__ float distance_to_next_voxel(
    const float p[3], const Ray& r, float res, float inv_res) {
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float x = res * p[i];
    const float tt = (floorf((x + 0.5f) + r.half_s[i]) - x) * r.idir[i];
    t = i == 0 ? tt : nmin(t, tt);
  }
  return clamp_lo(t * inv_res, 0.0f);
}

// occupancy.advance_to_next_voxel
__device__ __forceinline__ float advance_to_next_voxel(
    float t, const MarchParams& P, const float p[3], const Ray& r, float res,
    float inv_res) {
  const float t_target = t + distance_to_next_voxel(p, r, res, inv_res);
  if (P.cone == 0.0f) {
    const float n = clamp_lo(ceilf((t_target - t) / P.dt_min), 1.0f);
    return t + n * P.dt_min;
  }
  float t1 = t;
  for (int i = 0; i < 8 && t1 < t_target; ++i) t1 = t1 + calc_dt(t1, P);
  return nmax(t1, t + calc_dt(t, P));
}

// _ladder_jump
__device__ float ladder_jump(float t, float target, const MarchParams& P) {
  if (P.cone == 0.0f) {
    const float n = clamp_lo(ceilf((target - t) / P.dt_min), 1.0f);
    return t + n * P.dt_min;
  }
  float out = t;
  if (t < P.t1) {
    const float ta_end = clamp_hi(target, P.t1_end);
    const float na = ceilf(clamp_lo(ta_end - t, 0.0f) / P.dt_min);
    out = t + na * P.dt_min;
  }
  if (out < target && out >= P.t1 && out < P.t2) {
    const float ratio = clamp_lo(clamp_hi(target, P.t2_cap)
                                 / clamp_lo(out, 1e-30f), 1.0f);
    const float nb = ceilf(logf(ratio) / P.lg);
    out = out * expf(nb * P.lg);
  }
  if (out < target && out >= P.t2) {
    const float nc = ceilf((target - out) / P.dt_max);
    out = out + nc * P.dt_max;
  }
  return nmax(out, t + calc_dt(t, P));
}

// _skip_probe on one route -> whether the voxel is occupied; where it is
// not, *adv the advanced t.
template <int ROUTE>
__device__ __forceinline__ bool probe(
    const MarchParams& P, const uint8_t* __restrict__ grid, const float p[3],
    float t, const Ray& r, float dt, float* adv) {
  if (ROUTE == ROUTE_JUMP || ROUTE == ROUTE_DDA) {
    int k;                                     // res = 2^(7 - k)
    if (ROUTE == ROUTE_JUMP) {
      const int lv = __ldg(grid + ((cell_i(p[2]) * G + cell_i(p[1])) * G
                                   + cell_i(p[0])));
      if (lv == 255) return true;
      k = min(lv, 4);
    } else {
      const int mip = max(mip_from_dt(dt, p, P.max_cascade), P.min_mip);
      const float scale = pow2i(-mip);
      const long long c0 = cell_i((p[0] - 0.5f) * scale + 0.5f);
      const long long c1 = cell_i((p[1] - 0.5f) * scale + 0.5f);
      const long long c2 = cell_i((p[2] - 0.5f) * scale + 0.5f);
      long long flat = (((long long)mip * G + c2) * G + c1) * G + c0;
      flat = flat < 0 ? 0 : (flat > P.grid_numel - 1 ? P.grid_numel - 1 : flat);
      if (__ldg(grid + flat) != 0) return true;
      k = mip;
    }
    *adv = advance_to_next_voxel(t, P, p, r, pow2i(7 - k), pow2i(k - 7));
    return false;
  }
  if (ROUTE == ROUTE_DIST) {
    int ci[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) ci[i] = cell_i(p[i]);
    const int kv = __ldg(grid + ((ci[2] * G + ci[1]) * G + ci[0]));
    if (kv == 0) return true;
    const float k = (float)kv;
    float delta = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float vi = (float)ci[i];
      const float bound = r.d[i] > 0.0f ? (vi + k) * VOX
                                        : (vi - (k - 1.0f)) * VOX;
      const float tt = r.d[i] == 0.0f ? 1e9f : (bound - p[i]) / r.d[i];
      delta = i == 0 ? tt : nmin(delta, tt);
    }
    delta = clamp_lo(delta, 0.0f);
    *adv = t + clamp_lo(ceilf(delta / P.dt_min), 1.0f) * P.dt_min;
    return false;
  }
  // ROUTE_DIST_MIPS
  const int mip = max(mip_from_dt(dt, p, P.max_cascade), P.min_mip);
  const float s = pow2i(mip), inv_s = pow2i(-mip);
  float q[3];
  int ci[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q[i] = (p[i] - 0.5f) * inv_s + 0.5f;
    ci[i] = cell_i(q[i]);
  }
  long long flat = (((long long)mip * G + ci[2]) * G + ci[1]) * G + ci[0];
  flat = flat < 0 ? 0 : (flat > P.grid_numel - 1 ? P.grid_numel - 1 : flat);
  const int kv = __ldg(grid + flat);
  if (kv == 0) return true;
  const float k = (float)kv;
  float ball = 0.0f, cube = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool zero = r.d[i] == 0.0f;
    const float cell = (float)ci[i];
    const float bound = r.d[i] > 0.0f ? (cell + k) * VOX
                                      : (cell - (k - 1.0f)) * VOX;
    const float tt = zero ? 1e9f : (bound - q[i]) / (r.safe_d[i] * inv_s);
    const float cb = r.d[i] > 0.0f ? 0.5f + 0.5f * s : 0.5f - 0.5f * s;
    const float tc = zero ? 1e9f : (cb - p[i]) / r.safe_d[i];
    ball = i == 0 ? tt : nmin(ball, tt);
    cube = i == 0 ? tc : nmin(cube, tc);
  }
  float delta = nmin(clamp_lo(ball, 0.0f), clamp_lo(cube, 0.0f) + VOX);
  if (P.cone > 0.0f) {
    const int e = frexp_e(dt * (float)(2 * G));
    const float tau_next = div_const(pow2i(max(e, 0)), P.tau_den,
                                     P.inv_tau_den);
    const float tau = div_const(dt, P.cone, P.inv_cone);
    const float dtmip = dt >= P.dtmip_cap ? 1e9f
                                          : clamp_lo(tau_next - tau, 0.0f) + dt;
    delta = nmin(delta, dtmip);
  }
  *adv = ladder_jump(t, t + delta, P);
  return false;
}

// The walk: a thread per ray. ADVANCE: the advance pass, writing t and
// alive; SAMPLES: the round's K slots from there (from the state's t and
// alive without ADVANCE); INIT (alone): init_rays' bounded walk, dt from
// the absolute t, which reads neither t_start nor surf_a. LIST (with
// SAMPLES): thread j takes ray ids[j] of the frame's arrays (alive is
// implied with ADVANCE, read without it), writes t and alive back with
// ADVANCE, and writes each valid slot's row (its network input, t and
// dt) where a warp-aggregated counter puts it, and at j its first row,
// its slot bits and the ray's t_end, exited and stopped; it takes
// steps * T_STRIDE floats of dynamic shared memory. Its threads past the
// list's length walk nothing but take part in the warp's rows.
template <int ROUTE, bool ADVANCE, bool SAMPLES, bool INIT, bool LIST = false>
__global__ void __launch_bounds__(INIT ? INIT_THREADS : WALK_THREADS)
walk_kernel(MarchParams P, int n, WalkArgs a) {
  const int j = blockIdx.x * (INIT ? INIT_THREADS : WALK_THREADS) + threadIdx.x;
  if (!LIST && j >= n) return;
  // the list's length and the thread's ray; a thread past the list reads
  // ray 0 (the frame has one) and writes nothing
  const int len = LIST ? (a.n_list ? min(*a.n_list, n) : n) : n;
  const bool on = !LIST || j < len;
  const int i = LIST ? (on ? a.ids[j] : 0) : j;
  if (INIT) {
    float t = a.t[i];
    bool alive = a.alive[i] != 0;
    if (alive && P.iters > 0) {
      const Box b = load_box(a.box_lo, a.box_hi, a.local);
      const Ray r = load_ray(a.o, a.d, i);
      const float ts = a.t_surf[i];
      const bool has_surface = ts > 0.0f;
      for (int it = 0; it < P.iters; ++it) {
        if (has_surface && t > ts) {            // past the surface: park
          t = ts;
          break;
        }
        float p[3], adv;
        at(r, t, p);
        if (!contains_local(b, p)) {            // left the box
          if (has_surface) t = ts;
          else alive = false;
          break;
        }
        if (probe<ROUTE>(P, a.grid, p, t, r, calc_dt(t, P), &adv)) break;
        t = adv;
      }
    }
    a.t_out[i] = t;
    a.alive_out[i] = alive;
    return;
  }
  const Box b = load_box(a.box_lo, a.box_hi, a.local);
  const Ray r = load_ray(a.o, a.d, i);
  const float ts = a.t_surf[i], t0 = a.t_start[i], sa = a.surf_a[i];
  float t = a.t[i];
  bool alive = LIST ? on && (ADVANCE || a.alive[i] != 0) : a.alive[i] != 0;
  if (ADVANCE) {
    if (alive && P.iters > 0) {
      const bool surf_live = ts > 0.0f && sa > 0.0f;
      const float t_exit = ray_exit_t(b, r.o, r.d);
      for (int it = 0; it < P.iters; ++it) {
        const bool pending = surf_live && t >= ts;
        const bool inside = t <= t_exit;
        if (pending || (!inside && surf_live)) {  // park at the surface
          t = ts;
          break;
        }
        if (!inside) {                            // a clean exit
          alive = false;
          break;
        }
        float p[3], adv;
        at(r, t, p);
        if (probe<ROUTE>(P, a.grid, p, t, r, calc_dt(t - t0, P), &adv))
          break;
        t = adv;
      }
    }
    if (on) {
      a.t_out[i] = t;
      a.alive_out[i] = alive;
    }
  }
  if (SAMPLES) {
    const bool has_surface = ts > 0.0f;
    const bool surf_full = sa >= 1.0f;
    bool gen_alive = alive, exited = false, stopped = false;
    // LIST: the valid slots' bits, and their t in this thread's column of
    // s_t (K <= MAX_LIST_STEPS)
    extern __shared__ float s_t[];
    unsigned long long found_mask = 0;
    int n_found = 0;
    for (int k = 0; k < P.steps; ++k) {
      int status = gen_alive ? 0 : -1;
      for (int s = 0; s < P.skip_iters && status == 0; ++s) {
        float p[3], adv;
        at(r, t, p);
        if (has_surface && t > ts && surf_full) {
          status = 3;                             // an opaque surface stops it
        } else if (!contains_local(b, p)) {
          status = 2;                             // left the box
        } else if (probe<ROUTE>(P, a.grid, p, t, r, calc_dt(t - t0, P),
                                &adv)) {
          status = 1;                             // a sample
        } else {
          t = adv;
        }
      }
      const bool found = status == 1;
      const float dt = calc_dt(t - t0, P);
      if (LIST) {
        if (found) s_t[n_found++ * T_STRIDE + threadIdx.x] = t;
        found_mask |= (unsigned long long)found << k;
      } else {
        const long long slot = (long long)k * n + i;
        float p[3];
        at(r, t, p);
#pragma unroll
        for (int c = 0; c < 3; ++c) a.pos_k[3 * slot + c] = p[c];
        a.dt_k[slot] = dt;
        a.valid_k[slot] = found;
        a.ts_k[slot] = t;
      }
      exited = exited || status == 2;
      stopped = stopped || status == 3;
      t = found ? t + dt : (status == 3 ? ts : t);
      gen_alive = gen_alive && (found || status == 0);
    }
    const int out = LIST ? j : i;
    if (on) {
      a.t_end[out] = t;
      a.exited[out] = exited && alive;
      a.stopped[out] = stopped && alive;
    }
    if (LIST) {
      // the warp's rows: one atomicAdd, a lane's rows in slot order after
      // the rows of the lanes below it
      const unsigned lane = threadIdx.x & 31u;
      int incl = n_found;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= (unsigned)off) incl += y;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      int base = 0;
      if (lane == 31u && total > 0) base = atomicAdd(a.row_count, total);
      base = __shfl_sync(0xffffffffu, base, 31);
      const long long first = (long long)base + incl - n_found;
      if (on) {
        a.row_first[j] = (int)first;
        for (int q = 0; 8 * q < P.steps; ++q)      // slots 8q..8q+7
          a.slot_mask[(long long)q * len + j] = (uint8_t)(found_mask >> (8 * q));
      }
      if (total == 0) return;
      float lo[3], ext[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = __ldg(a.train_min + c);
        ext[c] = __fsub_rn(__ldg(a.train_max + c), lo[c]);
      }
      // the warp's rows [base, base + total), 32 at a time: row c0 + lane
      // made by this lane, its owner the lane whose rows end past it; ts
      // and dt stored as made, the positions and directions through
      // shared memory as contiguous runs. (The room is K x the list's
      // length, all a list can fill from row 0; the bound keeps a
      // caller's count that did not start at 0 from writing past it.)
      __shared__ float s_rows[LIST ? WALK_THREADS / 32 : 1][LIST ? 6 * 32 : 1];
      float* const s_pos = s_rows[threadIdx.x >> 5];
      float* const s_dir = s_pos + 3 * 32;
      const float* const s_tw = s_t + (threadIdx.x & ~31u);
      const int excl = incl - n_found;
      for (int c0 = 0; c0 < total; c0 += 32) {
        const int w = c0 + (int)lane;
        int owner = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int v = __shfl_sync(0xffffffffu, incl, owner + step - 1);
          if (v <= w) owner += step;
        }
        const int q = w - __shfl_sync(0xffffffffu, excl, owner);
        float o[3], d[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o[c] = __shfl_sync(0xffffffffu, r.o[c], owner);
          d[c] = __shfl_sync(0xffffffffu, r.d[c], owner);
        }
        const float t0w = __shfl_sync(0xffffffffu, t0, owner);
        const long long row0 = (long long)base + c0;
        const int len = (int)max(min((long long)min(32, total - c0),
                                     a.row_cap - row0), 0LL);
        if ((int)lane < len) {
          // aten's (pos - train_min) / (train_max - train_min) and (d + 1)
          // * 0.5, each rounded on its own
          const float tk = s_tw[q * T_STRIDE + owner];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float p = o[c] + d[c] * tk;
            s_pos[3 * lane + c] = __fdiv_rn(__fsub_rn(p, lo[c]), ext[c]);
            s_dir[3 * lane + c] = __fmul_rn(__fadd_rn(d[c], 1.0f), 0.5f);
          }
          a.row_ts[row0 + lane] = tk;
          a.row_dt[row0 + lane] = calc_dt(tk - t0w, P);
        }
        __syncwarp();
        for (int x = (int)lane; x < 3 * len; x += 32) {
          a.row_pos01[3 * row0 + x] = s_pos[x];
          a.row_dir01[3 * row0 + x] = s_dir[x];
        }
        __syncwarp();
      }
    }
  }
}

// ops/network.py's apply_density_activation / apply_rgb_activation as aten
// computes them on the card: torch.relu and torch.clamp keep NaN, sigmoid
// is 1 / (1 + exp(-x))
__device__ __forceinline__ float activate(float x, int kind) {
  switch (kind) {
    case ACT_RELU: return x != x ? x : fmaxf(x, 0.0f);
    case ACT_LOGISTIC: return 1.0f / (1.0f + expf(-x));
    case ACT_EXP: return expf(x);
    case ACT_EXP_CLAMPED:
      return expf(x != x ? x : fminf(fmaxf(x, -10.0f), 10.0f));
    default: return x;
  }
}

// The row map: rows[slots[j]] = j, a thread a row; a slot outside the
// round's `total` slots is left out.
__global__ void __launch_bounds__(THREADS) row_map_kernel(
    const long long* __restrict__ slots, long long m, long long total,
    int* __restrict__ rows) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= m) return;
  const long long s = slots[j];
  if (s >= 0 && s < total) rows[s] = (int)j;
}

// A ray's compositing state, and the three steps of a round's composite
// that both forms run: the in-march surface blend, one slot of the
// front-to-back loop, the final surface blend.
struct Comp {
  float c[4], sc[4], depth, max_w, wn, sa;
  bool comp;           // still compositing
};

// the in-march surface blend, once before the round's samples
__device__ __forceinline__ void surface_blend(Comp& s, const MarchParams& P,
                                              float ts, float t_payload) {
  if (s.comp && ts > 0.0f && t_payload > ts && s.sa > 0.0f) {
    const float w = s.sa * (1.0f - s.c[3]);
#pragma unroll
    for (int j = 0; j < 3; ++j) s.c[j] = s.c[j] + s.sc[j] * w;
    s.c[3] = s.c[3] + w;
    s.sa = 0.0f;
    if (s.c[3] > 0.99f) {
      const float inv = 1.0f / clamp_lo(s.c[3], 1e-9f);
#pragma unroll
      for (int j = 0; j < 4; ++j) s.c[j] = s.c[j] * inv;
      if (P.deferred) s.wn = s.wn * inv;
      s.comp = false;
    }
  }
}

// one slot: weight w (0 where the slot is not used) of colour rgb ->
// whether the slot is the ray's new max-weight sample
__device__ __forceinline__ bool add_slot(Comp& s, const MarchParams& P,
                                         bool use, float w,
                                         const float rgb[3]) {
#pragma unroll
  for (int m = 0; m < 3; ++m) s.c[m] = s.c[m] + rgb[m] * w;
  s.c[3] = s.c[3] + w;
  if (P.deferred) s.wn = s.wn + w;
  const bool done = use && s.c[3] > P.sat_alpha;
  const bool upd = w > s.max_w;
  if (upd) s.max_w = w;
  if (done) {
    const float inv = 1.0f / clamp_lo(s.c[3], 1e-9f);
#pragma unroll
    for (int m = 0; m < 4; ++m) s.c[m] = s.c[m] * inv;
    if (P.deferred) s.wn = s.wn * inv;
    s.comp = false;
  }
  return upd && use;
}

// the final surface blend of rays that ended
__device__ __forceinline__ void final_blend(Comp& s, bool ended) {
  if (s.comp && ended && s.sa > 0.0f) {
    const float T = 1.0f - s.c[3];
#pragma unroll
    for (int j = 0; j < 4; ++j) s.c[j] = s.c[j] + s.sc[j] * T;
  }
  s.comp = s.comp && !ended;
}

__device__ __forceinline__ Comp load_comp(const CompositeArgs& a, int i) {
  Comp s;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.c[j] = a.rgba[4 * i + j];
    s.sc[j] = a.surf[4 * i + j];
  }
  s.depth = a.depth[i];
  s.max_w = a.max_w[i];
  s.wn = a.wn[i];
  s.sa = a.surf_a[i];
  return s;
}

__device__ __forceinline__ void store_comp(const CompositeArgs& a, int i,
                                           const Comp& s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a.rgba_out[4 * i + j] = s.c[j];
  a.depth_out[i] = s.depth;
  a.max_w_out[i] = s.max_w;
  a.wn_out[i] = s.wn;
  a.surf_a_out[i] = s.sa;
  a.alive_out[i] = s.comp;
}

// The round's composite, a thread per ray: the in-march surface blend
// (STAGE_BLEND), then (STAGE_SAMPLES) the front-to-back loop over the K
// slots and the final surface blend. The slots come in chunks of
// COMPOSITE_CHUNK: the chunk's valid and colour-mask bytes first, then
// the row numbers of its valid slots, each step's loads in flight
// together, then the loop over the chunk. A slot the loop uses (valid,
// on a ray that is alive and still compositing) reads its alpha (dense,
// or 1 - exp(-act(sigma) dt) from its row's raw density) and its colour
// (act(rgb) of its row where it owns one, else 0); one it does not use
// reads nothing more and adds a weight of 0. The row map is scratch that
// nothing fills: a row number r counts only where 0 <= r < m and row r's
// slot is this slot (loaded beside the row's values), so a slot without
// a row has alpha 0 (without a dense alpha) and colour 0, as in the plain
// version's dense tensors.
constexpr int COMPOSITE_CHUNK = 8;

__global__ void __launch_bounds__(THREADS) composite_kernel(
    MarchParams P, int n, CompositeArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  Comp s = load_comp(a, i);
  const float ts = a.t_surf[i];
  const bool alive = a.alive[i] != 0;
  const bool exited = a.exited[i] != 0, stopped = a.stopped[i] != 0;
  s.comp = alive;
  if (P.stage & STAGE_BLEND)
    surface_blend(s, P, ts, exited ? a.t_round[i]
                                   : (stopped ? ts : a.t_end[i]));
  if (P.stage & STAGE_SAMPLES) {
    for (int k0 = 0; k0 < P.steps; k0 += COMPOSITE_CHUNK) {
      unsigned valid = 0, owns = 0;
      int row[COMPOSITE_CHUNK];
      const bool reads = s.comp && alive;
#pragma unroll
      for (int j = 0; j < COMPOSITE_CHUNK; ++j) {
        const long long slot = (long long)(k0 + j) * n + i;
        if (reads && k0 + j < P.steps) {
          const bool v = a.valid[slot] != 0;
          valid |= (unsigned)v << j;
          owns |= (unsigned)(a.color ? a.color[slot] != 0 : v) << j;
        }
      }
#pragma unroll
      for (int j = 0; j < COMPOSITE_CHUNK; ++j) {
        const long long slot = (long long)(k0 + j) * n + i;
        row[j] = (owns >> j & 1u) && a.m > 0 ? a.rows[slot] : -1;
      }
#pragma unroll
      for (int j = 0; j < COMPOSITE_CHUNK; ++j) {
        if (k0 + j >= P.steps) break;
        const long long slot = (long long)(k0 + j) * n + i;
        const bool use = s.comp && (valid >> j & 1u) && alive;
        float w = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
        if (use) {
          const long long r = row[j];
          // the row's slot and values, loaded together
          long long back = -1;
          float raw_sigma = 0.0f, dt = 0.0f, raw_rgb[3] = {0.0f, 0.0f, 0.0f};
          if (r >= 0 && r < a.m) {
            back = a.slots[r];
            if (!a.alpha) {
              raw_sigma = a.sigma[r * a.sigma_stride];
              dt = a.dt_k[slot];
            }
#pragma unroll
            for (int m = 0; m < 3; ++m) raw_rgb[m] = a.rgb[3 * r + m];
          }
          const bool own = back == slot;
          float alpha = 0.0f;
          if (a.alpha) {
            alpha = a.alpha[slot];
          } else if (own) {
            const float sigma = activate(raw_sigma, P.density_act);
            alpha = 1.0f - expf(-sigma * dt);
          }
          if (own) {
#pragma unroll
            for (int m = 0; m < 3; ++m) rgb[m] = activate(raw_rgb[m], P.rgb_act);
          }
          w = alpha * (1.0f - s.c[3]);
        }
        if (add_slot(s, P, use, w, rgb)) s.depth = a.ts_k[slot];
      }
    }
    final_blend(s, exited || stopped);
  }
  store_comp(a, i, s);
}

// The list form, a thread per entry j of the epoch's list, ray ids[j]:
// the blend, the K slots and the final blend of composite_kernel on the
// frame's arrays, in place, with t = t_end; the valid slots, from the
// walk's slot bits of entry j, take its rows in order from its first
// row (a slot the loop reaches only after the ray settled reads
// nothing), the row's raw density, colour, t and dt read together; then
// the rays still compositing are appended to next_ids (a block scan of
// the flags, one atomicAdd a block). Entries past the list take part in
// the scan only.
__global__ void __launch_bounds__(THREADS) composite_list_kernel(
    MarchParams P, int n, CompositeArgs a) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const bool on = j < n;
  const int i = on ? a.ids[j] : 0;
  bool keep = false;
  if (on) {
    Comp s = load_comp(a, i);
    const float ts = a.t_surf[i];
    const bool alive = a.alive[i] != 0;
    const bool exited = a.exited[j] != 0, stopped = a.stopped[j] != 0;
    const float t_end = a.t_end[j];
    s.comp = alive;
    surface_blend(s, P, ts, exited ? a.t_round[i] : (stopped ? ts : t_end));
    long long r = a.row_first[j];
    for (int k0 = 0; k0 < P.steps; k0 += 8) {
      // the chunk's 8 slot bits; a valid slot takes the next row
      const unsigned bits = s.comp && alive
                                ? a.slot_mask[(long long)(k0 >> 3) * n + j] : 0u;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (k0 + c >= P.steps) break;
        const bool use = s.comp && (bits >> c & 1u);
        float w = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f}, t_slot = 0.0f;
        if (use) {
          // (a row past the network's, none where the walk's count
          // started at 0, has alpha and colour 0)
          float alpha = 0.0f;
          if (r < a.m) {
            const float raw_sigma = a.sigma[r * a.sigma_stride];
            const float dt = a.row_dt[r];
            float raw_rgb[3];
#pragma unroll
            for (int m = 0; m < 3; ++m) raw_rgb[m] = a.rgb[3 * r + m];
            t_slot = a.row_ts[r];
            const float sigma = activate(raw_sigma, P.density_act);
            alpha = 1.0f - expf(-sigma * dt);
#pragma unroll
            for (int m = 0; m < 3; ++m) rgb[m] = activate(raw_rgb[m], P.rgb_act);
          }
          ++r;
          w = alpha * (1.0f - s.c[3]);
        }
        if (add_slot(s, P, use, w, rgb)) s.depth = t_slot;
      }
    }
    final_blend(s, exited || stopped);
    store_comp(a, i, s);
    a.t_out[i] = t_end;
    keep = s.comp;
  }
  if (!a.next_ids) return;
  __shared__ int warp_base[THREADS / 32];
  __shared__ int block_base;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    block_base = total > 0 ? atomicAdd(a.next_count, total) : 0;
  }
  __syncthreads();
  if (keep) {
    const long long at_ = (long long)block_base + warp_base[warp]
                          + __popc(ballot & ((1u << lane) - 1u));
    // (the room is the list's length, all a next list can fill from 0;
    // the bound keeps a count that did not start at 0 from writing past)
    if (at_ < a.next_cap) a.next_ids[at_] = i;
  }
}

// occupancy.occupied_at on the uint8 (8, G, G, G) grid: the cell of p at
// `mip`, the flat index clamped into the grid
__device__ __forceinline__ bool occupied_at(const uint8_t* __restrict__ occ,
                                            long long numel, const float p[3],
                                            int mip) {
  const float scale = pow2i(-mip);
  const long long c0 = cell_i((p[0] - 0.5f) * scale + 0.5f);
  const long long c1 = cell_i((p[1] - 0.5f) * scale + 0.5f);
  const long long c2 = cell_i((p[2] - 0.5f) * scale + 0.5f);
  long long flat = (((long long)mip * G + c2) * G + c1) * G + c0;
  flat = flat < 0 ? 0 : (flat > numel - 1 ? numel - 1 : flat);
  return __ldg(occ + flat) != 0;
}

// The trainer's geometry pass (ops/march_cuda.py::training_samples_reference,
// formerly train/trainer.py::march_training_samples' body): a thread a ray.
// Pass 1 hops the ray H = P.iters times through the occupancy grid from its
// aabb entry, an occupied cell a segment of min(stride, tmax - t), an
// empty one skipped by advance_to_next_voxel (the 8-step cone loop where
// cone > 0), and records each hop's start, its inclusive occupied length
// and the exclusive one in shared memory, hop h of thread x at
// h * TRAIN_THREADS + x (bank x: no conflicts). Pass 2 places the S =
// P.steps stratified samples by inverse CDF over that length: torch.
// searchsorted's right-side binary search over the thread's sums, the
// index clamped to H - 1; an invalid sample keeps its t (t_start[H-1] + s
// - cum_ex[H-1]) as the plain version writes it.
//
// What bounds it: the chain of H dependent hops of a ray (each a gather
// from the 16 MiB grid and the voxel advance that waits for it), not
// bytes: a warp is as slow as its longest hop chain. The design runs the
// chain once and keeps the whole pass in one launch (the port ran ~70
// aten operations a hop, ~8,900 a step); the sums stay in shared memory
// (3 x 4 bytes x H a ray, 24 KB a block at H = 128), so nothing of the
// (H, B) intermediates the plain version makes is written to device
// memory. Blocks of 16 rays: 2,048 rays a step are 128 half-full warps,
// about one an SM, each the longest chain of 16 rays rather than 32
// (3.6% faster than 32 on the settled step, PERF.md section 6). A dead
// ray (t >= tmax, or NaN) keeps its t and adds nothing, as the plain
// version's masks give.
//
// Numerics: the plain version's float32 operations one by one; the sums
// in double, each rounded to float32, as aten's cumsum on the CPU takes
// them (its accumulator is double there), so the kernel gives the CPU
// plain version's bits; locc / S and span / H are true divisions, as on
// the CPU (the card's aten multiplies by the reciprocal, and sums in
// float32 in a parallel scan: ops/march_cuda.py::compare_training_samples
// holds the kernel to the card's plain version under a contract).
constexpr int TRAIN_THREADS = 16;

__global__ void __launch_bounds__(TRAIN_THREADS) training_samples_kernel(
    MarchParams P, int n, TrainArgs a) {
  extern __shared__ float train_smem[];
  const int H = P.iters, S = P.steps;
  const int x = threadIdx.x;
  const int i = blockIdx.x * TRAIN_THREADS + x;
  if (i >= n) return;       // a thread reads and writes its own column alone
  float* const s_start = train_smem + x;
  float* const s_cum = s_start + H * TRAIN_THREADS;
  float* const s_cum_ex = s_cum + H * TRAIN_THREADS;
  const Ray r = load_ray(a.o, a.d, i);
  // utils/bbox.ray_intersect_aabb
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ta = (__ldg(a.aabb_min + c) - r.o[c]) * r.idir[c];
    const float tb = (__ldg(a.aabb_max + c) - r.o[c]) * r.idir[c];
    const float lo = nmin(ta, tb), hi = nmax(ta, tb);
    tmin = c == 0 ? lo : nmax(tmin, lo);
    tmax = c == 0 ? hi : nmin(tmax, hi);
  }
  if (tmin > tmax) tmin = tmax = F32_MAX;
  const float t0 = clamp_lo(tmin, 0.0f) + 1e-6f;
  const float span = clamp_lo(tmax - t0, 0.0f);
  const float stride = clamp_lo(span / (float)H, VOX);
  float t = t0;
  double cum = 0.0;
  for (int h = 0; h < H; ++h) {
    float seg = 0.0f, t_next = t;
    if (t < tmax) {
      float p[3];
      at(r, t, p);
      const float dt = calc_dt(t, P);
      const int mip = mip_from_dt(dt, p, P.max_cascade);
      if (occupied_at(a.occ, P.grid_numel, p, mip)) {
        seg = nmin(stride, tmax - t);
        t_next = t + seg;
      } else {
        t_next = nmax(advance_to_next_voxel(t, P, p, r, pow2i(7 - mip),
                                            pow2i(mip - 7)),
                      t + 1e-6f);
      }
    }
    cum += (double)seg;
    const float c = (float)cum;
    s_start[h * TRAIN_THREADS] = t;
    s_cum[h * TRAIN_THREADS] = c;
    s_cum_ex[h * TRAIN_THREADS] = c - seg;
    t = t_next;
  }
  const float locc = s_cum[(H - 1) * TRAIN_THREADS];
  const float dt_eff = locc > 0.0f ? locc / (float)S : 1.0f;
  for (int k = 0; k < S; ++k) {
    const long long o = (long long)k * n + i;
    const float s = ((float)k + __ldg(a.u + o)) * dt_eff;
    int lo = 0, hi = H;                  // the first hop whose sum is > s
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(s_cum[mid * TRAIN_THREADS] > s)) lo = mid + 1;
      else hi = mid;
    }
    const int h = min(lo, H - 1) * TRAIN_THREADS;
    const bool valid = s < locc;
    a.t[o] = s_start[h] + (s - s_cum_ex[h]);
    a.dt[o] = valid ? dt_eff : 0.0f;
    a.valid[o] = valid;
  }
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

template <int ROUTE, bool ADVANCE, bool SAMPLES, bool INIT = false,
          bool LIST = false>
int launch_walk(const MarchParams& P, int n, const WalkArgs& a,
                cudaStream_t s) {
  constexpr int tile = INIT ? INIT_THREADS : WALK_THREADS;
  // the list form's staged t: K floats a thread
  const int smem = LIST ? P.steps * T_STRIDE * (int)sizeof(float) : 0;
  if (LIST && smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<ROUTE, ADVANCE, SAMPLES, INIT, LIST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  walk_kernel<ROUTE, ADVANCE, SAMPLES, INIT, LIST>
      <<<(n + tile - 1) / tile, tile, smem, s>>>(P, n, a);
  return static_cast<int>(cudaGetLastError());
}

template <int ROUTE>
int launch_walk_mode(const MarchParams& P, int n, const WalkArgs& a,
                     cudaStream_t s) {
  switch (P.mode) {
    case WALK_ADVANCE: return launch_walk<ROUTE, true, false>(P, n, a, s);
    case WALK_SAMPLES: return launch_walk<ROUTE, false, true>(P, n, a, s);
    case WALK_ADVANCE | WALK_SAMPLES:
      return launch_walk<ROUTE, true, true>(P, n, a, s);
    case WALK_INIT: return launch_walk<ROUTE, false, false, true>(P, n, a, s);
    case WALK_LIST | WALK_ADVANCE | WALK_SAMPLES:
      return launch_walk<ROUTE, true, true, false, true>(P, n, a, s);
    case WALK_LIST | WALK_SAMPLES:
      return launch_walk<ROUTE, false, true, false, true>(P, n, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each copies the parameters,
// launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success); none synchronises or allocates. n > 0.
extern "C" int nmr_march_walk(const MarchParams* p, int n, const WalkArgs* a,
                              void* stream) {
  const MarchParams P = *p;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P.route) {
    case ROUTE_JUMP: return launch_walk_mode<ROUTE_JUMP>(P, n, *a, s);
    case ROUTE_DIST: return launch_walk_mode<ROUTE_DIST>(P, n, *a, s);
    case ROUTE_DIST_MIPS: return launch_walk_mode<ROUTE_DIST_MIPS>(P, n, *a, s);
    case ROUTE_DDA: return launch_walk_mode<ROUTE_DDA>(P, n, *a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The composite: the list form's kernel where the arguments carry a
// list; else the row map of the network's rows (where there are any),
// then the composite kernel.
extern "C" int nmr_march_composite(const MarchParams* p, int n,
                                   const CompositeArgs* a, void* stream) {
  const MarchParams P = *p;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->ids) {
    composite_list_kernel<<<blocks(n), THREADS, 0, s>>>(P, n, *a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a->m > 0) {
    row_map_kernel<<<(unsigned)((a->m + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        a->slots, a->m, (long long)P.steps * n, a->rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  composite_kernel<<<blocks(n), THREADS, 0, s>>>(P, n, *a);
  return static_cast<int>(cudaGetLastError());
}

// The trainer's geometry pass: training_samples_kernel on n rays, P.iters
// hops and P.steps samples a ray, 12 * P.iters * TRAIN_THREADS bytes of
// dynamic shared memory a block (the launch raises the limit past 48 KB).
extern "C" int nmr_training_samples(const MarchParams* p, int n,
                                    const TrainArgs* a, void* stream) {
  const MarchParams P = *p;
  if (P.iters < 1 || P.steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * P.iters * TRAIN_THREADS * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        training_samples_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  training_samples_kernel<<<(n + TRAIN_THREADS - 1) / TRAIN_THREADS,
                            TRAIN_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(P, n, *a);
  return static_cast<int>(cudaGetLastError());
}
