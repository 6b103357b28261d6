// The exact march's per-ray loops for Hopper: one thread per ray.
//
// None of them replaces a Pallas kernel. The JAX package runs each loop
// as a fori_loop inside its one compiled march (nerf_glasses_tpu/ops/
// raymarch.py), because the TPU could not gather from its fast memory
// inside a kernel (docs/KERNELS.md section 2); the port ran them as
// eager aten ops, about 15 launches a probe iteration. Here:
//   walk_kernel       (nmr_march_walk)      one body for the epoch's two
//       walks, three forms a route: the advance pass alone (ops/
//       march_cuda.py::advance; JAX raymarch.py:730-764), a round's K
//       samples of <= skip_iters probes alone (::samples; JAX
//       raymarch.py:782-812), and the advance followed by the first
//       round's samples in the same thread (::advance_samples);
//   init_walk_kernel  (nmr_march_init_walk) ::init_walk, init_rays'
//       bounded walk; JAX raymarch.py:518-565;
//   composite_kernel  (nmr_march_composite) ::composite, the round's
//       in-march surface blend, K-sample front-to-back loop and final
//       surface blend; JAX _march_round after the network.
// A ray leaves its loop as soon as it settles, where the plain version
// masks it for the remaining iterations.
//
// What bounds the walks: the length of the longest rays' probe chains,
// not bytes. A thread reads its ray's state once and writes its outputs
// once (the first, separate advance and samples kernels reached 5-44% of
// that bound), but each probe is a chain of dependent steps, a gather
// among them, and the next probe waits for it: 7.4x the rays cost the
// first advance kernel 1.4x its time, 4x the probe cap 1.7x (PERF.md).
// So the design shortens the chain and runs fewer of them: the fused
// form loads the state once and carries the advanced ray straight into
// its K slots (one launch, one wrapper call and one state read an epoch
// fewer, and the tail is the longest advance + samples rather than the
// longest advance plus the longest samples); divisions
// by powers of two are products by exact reciprocals, per-ray invariants
// leave the loop, cells are integers, exponents are read from the bits,
// and a probe that finds its voxel occupied stops there. The samples'
// slot stores stay coalesced (slot k of ray i at k * n + i). One block
// of 256 threads a tile of rays, scheduled as blocks finish; a persistent
// grid, and a bit pyramid of the jump levels with its coarse levels
// staged in shared memory, were measured and were slower (PERF.md).
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
// (dt_min, dt_max, lg, d) stays a division. Python scalars of the plain
// version arrive as float32 values made on the host (MarchParams). torch
// semantics spelled out: clamp, minimum, maximum, amin and amax propagate
// NaN (nmin, nmax, clamp_lo, clamp_hi); nan_to_num maps NaN to 0 and
// +-inf to +-FLT_MAX; sign(d) + (d == 0); frexp's exponent; 2^k built
// from its bits. The render box's 3x3 `local` product is the one place
// where aten's order is a library's (a GEMM): it is taken as an FMA chain
// from the first term, exact for the identity (whose product is then
// skipped: the same containment test). On the card aten divides by a
// Python scalar as a product with its reciprocal; these kernels divide,
// as the CPU does, so they give the CPU plain version's bits and the card
// plain version may be a step apart (ops/march_cuda.py::compare_with_plain
// holds the count).

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
};

namespace {

constexpr int G = 128;
constexpr float VOX = 1.0f / 128.0f;
constexpr float F32_MAX = 3.402823466e38f;
constexpr int THREADS = 128;        // init walk, composite
constexpr int WALK_THREADS = 256;   // the walk: one block a 256-ray tile
enum { ROUTE_JUMP = 0, ROUTE_DIST = 1, ROUTE_DIST_MIPS = 2, ROUTE_DDA = 3 };
enum { WALK_ADVANCE = 1, WALK_SAMPLES = 2 };
enum { STAGE_BLEND = 1, STAGE_SAMPLES = 2 };

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
// alive without ADVANCE).
template <int ROUTE, bool ADVANCE, bool SAMPLES>
__global__ void __launch_bounds__(WALK_THREADS) walk_kernel(
    MarchParams P, int n, WalkArgs a) {
  const int i = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (i >= n) return;
  const Box b = load_box(a.box_lo, a.box_hi, a.local);
  const Ray r = load_ray(a.o, a.d, i);
  const float ts = a.t_surf[i], t0 = a.t_start[i], sa = a.surf_a[i];
  float t = a.t[i];
  bool alive = a.alive[i] != 0;
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
    a.t_out[i] = t;
    a.alive_out[i] = alive;
  }
  if (SAMPLES) {
    const bool has_surface = ts > 0.0f;
    const bool surf_full = sa >= 1.0f;
    bool gen_alive = alive, exited = false, stopped = false;
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
      const long long slot = (long long)k * n + i;
      float p[3];
      at(r, t, p);
#pragma unroll
      for (int c = 0; c < 3; ++c) a.pos_k[3 * slot + c] = p[c];
      a.dt_k[slot] = dt;
      a.valid_k[slot] = found;
      a.ts_k[slot] = t;
      exited = exited || status == 2;
      stopped = stopped || status == 3;
      t = found ? t + dt : (status == 3 ? ts : t);
      gen_alive = gen_alive && (found || status == 0);
    }
    a.t_end[i] = t;
    a.exited[i] = exited && alive;
    a.stopped[i] = stopped && alive;
  }
}

template <int ROUTE>
__global__ void __launch_bounds__(THREADS) init_walk_kernel(
    MarchParams P, int n, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_in,
    const float* __restrict__ t_surf, const uint8_t* __restrict__ alive_in,
    const uint8_t* __restrict__ grid, const float* box_lo,
    const float* box_hi, const float* local, float* __restrict__ t_out,
    uint8_t* __restrict__ alive_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float t = t_in[i];
  bool alive = alive_in[i] != 0;
  if (alive && P.iters > 0) {
    const Box b = load_box(box_lo, box_hi, local);
    const Ray r = load_ray(o, d, i);
    const float ts = t_surf[i];
    const bool has_surface = ts > 0.0f;
    for (int it = 0; it < P.iters; ++it) {
      if (has_surface && t > ts) {              // past the surface: park
        t = ts;
        break;
      }
      float p[3], adv;
      at(r, t, p);
      if (!contains_local(b, p)) {              // left the box
        if (has_surface) t = ts;
        else alive = false;
        break;
      }
      if (probe<ROUTE>(P, grid, p, t, r, calc_dt(t, P), &adv)) break;
      t = adv;
    }
  }
  t_out[i] = t;
  alive_out[i] = alive;
}
__global__ void __launch_bounds__(THREADS) composite_kernel(
    MarchParams P, int n, const float* __restrict__ rgba_in,
    const float* __restrict__ depth_in, const float* __restrict__ max_w_in,
    const float* __restrict__ wn_in, const float* __restrict__ surf_a_in,
    const float* __restrict__ t_round, const uint8_t* __restrict__ alive_in,
    const float* __restrict__ surf, const float* __restrict__ t_surf,
    const float* __restrict__ t_end, const uint8_t* __restrict__ exited_in,
    const uint8_t* __restrict__ stopped_in, const float* __restrict__ alpha,
    const uint8_t* __restrict__ valid, const float* __restrict__ ts_k,
    const float* __restrict__ rgb, float* __restrict__ rgba_out,
    float* __restrict__ depth_out, float* __restrict__ max_w_out,
    float* __restrict__ wn_out, float* __restrict__ surf_a_out,
    uint8_t* __restrict__ alive_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float c[4], sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = rgba_in[4 * i + j];
    sc[j] = surf[4 * i + j];
  }
  float depth = depth_in[i], max_w = max_w_in[i], wn = wn_in[i];
  float sa = surf_a_in[i];
  const float ts = t_surf[i];
  const bool alive = alive_in[i] != 0;
  const bool exited = exited_in[i] != 0, stopped = stopped_in[i] != 0;
  bool comp = alive;
  if (P.stage & STAGE_BLEND) {
    // the in-march surface blend, once before the round's samples
    const float t_payload = exited ? t_round[i] : (stopped ? ts : t_end[i]);
    if (comp && ts > 0.0f && t_payload > ts && sa > 0.0f) {
      const float w = sa * (1.0f - c[3]);
#pragma unroll
      for (int j = 0; j < 3; ++j) c[j] = c[j] + sc[j] * w;
      c[3] = c[3] + w;
      sa = 0.0f;
      if (c[3] > 0.99f) {
        const float inv = 1.0f / clamp_lo(c[3], 1e-9f);
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = c[j] * inv;
        if (P.deferred) wn = wn * inv;
        comp = false;
      }
    }
  }
  if (P.stage & STAGE_SAMPLES) {
    for (int k = 0; k < P.steps; ++k) {
      const long long slot = (long long)k * n + i;
      const bool use = comp && valid[slot] != 0 && alive;
      const float w = use ? alpha[slot] * (1.0f - c[3]) : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) c[j] = c[j] + rgb[3 * slot + j] * w;
      c[3] = c[3] + w;
      if (P.deferred) wn = wn + w;
      const bool done = use && c[3] > P.sat_alpha;
      const bool upd = w > max_w;
      if (upd) max_w = w;
      if (upd && use) depth = ts_k[slot];
      if (done) {
        const float inv = 1.0f / clamp_lo(c[3], 1e-9f);
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = c[j] * inv;
        if (P.deferred) wn = wn * inv;
        comp = false;
      }
    }
    // the final surface blend of rays that ended
    const bool ended = exited || stopped;
    if (comp && ended && sa > 0.0f) {
      const float T = 1.0f - c[3];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = c[j] + sc[j] * T;
    }
    comp = comp && !ended;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) rgba_out[4 * i + j] = c[j];
  depth_out[i] = depth;
  max_w_out[i] = max_w;
  wn_out[i] = wn;
  surf_a_out[i] = sa;
  alive_out[i] = comp;
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

template <int ROUTE, bool ADVANCE, bool SAMPLES>
int launch_walk(const MarchParams& P, int n, const WalkArgs& a,
                cudaStream_t s) {
  walk_kernel<ROUTE, ADVANCE, SAMPLES>
      <<<(n + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0, s>>>(P, n, a);
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

extern "C" int nmr_march_init_walk(
    const MarchParams* p, int n, const float* o, const float* d,
    const float* t, const float* t_surf, const uint8_t* alive,
    const uint8_t* grid, const float* box_lo, const float* box_hi,
    const float* local, float* t_out, uint8_t* alive_out, void* stream) {
  const MarchParams P = *p;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NMR_INIT(R)                                                          \
  init_walk_kernel<R><<<blocks(n), THREADS, 0, s>>>(                         \
      P, n, o, d, t, t_surf, alive, grid, box_lo, box_hi, local, t_out,      \
      alive_out)
  switch (P.route) {
    case ROUTE_JUMP: NMR_INIT(ROUTE_JUMP); break;
    case ROUTE_DIST: NMR_INIT(ROUTE_DIST); break;
    case ROUTE_DIST_MIPS: NMR_INIT(ROUTE_DIST_MIPS); break;
    case ROUTE_DDA: NMR_INIT(ROUTE_DDA); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NMR_INIT
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nmr_march_composite(
    const MarchParams* p, int n, const float* rgba, const float* depth,
    const float* max_w, const float* wn, const float* surf_a,
    const float* t_round, const uint8_t* alive, const float* surf,
    const float* t_surf, const float* t_end, const uint8_t* exited,
    const uint8_t* stopped, const float* alpha, const uint8_t* valid,
    const float* ts_k, const float* rgb, float* rgba_out, float* depth_out,
    float* max_w_out, float* wn_out, float* surf_a_out, uint8_t* alive_out,
    void* stream) {
  const MarchParams P = *p;
  composite_kernel<<<blocks(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, n, rgba, depth, max_w, wn, surf_a, t_round, alive, surf, t_surf,
      t_end, exited, stopped, alpha, valid, ts_k, rgb, rgba_out, depth_out,
      max_w_out, wn_out, surf_a_out, alive_out);
  return static_cast<int>(cudaGetLastError());
}
