// Mesh ray-casts (Moller-Trumbore, back faces culled) for Hopper: two
// kernels that share one intersection routine.
//
// raycast_tiled_kernel (nmr_raycast_tiled) replaces
// nerf_glasses_tpu/ops/mesh_pallas.py::raycast_pallas_tiled (kernel
// _tiled_kernel). Rays arrive grouped by screen tile (tile_rays
// consecutive rays per tile); each tile carries a front-packed list of
// candidate triangle ids in ascending order (ops/triangles.py::
// _bin_triangles) and a count. raycast_kernel (nmr_raycast) replaces
// mesh_pallas.py::raycast_pallas (kernel _kernel): every ray against all
// n_tris triangles, ids implicit. Both compute, for each ray, the nearest
// hit among its candidates:
//   det > 1e-9 (back faces culled), u >= -1e-5, v >= -1e-5,
//   u + v <= 1 + 1e-5, 1e-4 < t < best,
// walking the candidates in ascending id order with a strict `<`, so the
// earliest candidate wins a tie. A miss gives t = 1e16, id -1, u = v = 0.
//
// What bounds them: arithmetic, the fused form's 32 flops per ray x
// candidate test (an FMA counted as 2, as the fp32 peak counts it); the
// rays and outputs are 40 bytes a ray. The card issues one warp
// instruction per clock on each of its 4x132 schedulers, so the test's
// instruction count is the cost: about 32 a test (21 products, 8 for the
// tests, a share of the shared-memory loads and the loop), which at full
// issue is half the peak's rate.
//
// The test in two steps.
//  1. may_hit: fused products (__fmaf_rn, every contraction spelled out,
//     so the build does not choose them) in a form that reads
//     m = e2 x e1, which pack_tris stores once per triangle in the float4
//     padding: with t = o - v0 and s = t x d, det = d.m, u*det = s.e2,
//     v*det = -s.e1 and t*det = -t.m (21 instructions); then the
//     acceptance tests scaled by det, so that no division is taken:
//     u*det and v*det >= -tol, their sum <= det + tol, and t*det <
//     lim*det with lim = best_t * FILTER_T_SCALE (8 instructions). The
//     plain version's det > 1e-9 and t > 1e-4 are left to step 2: a back
//     face or a hit behind the ray rarely passes the others, and leaving
//     them out makes the filter pass more candidates, never fewer.
//     Nearly every test ends here.
//  2. exact_hit, for a candidate that passes: the plain version's
//     arithmetic in its order, every operation rounded on its own
//     (__fmul_rn, __fadd_rn), the IEEE reciprocal, and the plain
//     version's tests, then t < best_t.
// The margin tol follows the rounding error of u*det and v*det. Both
// sums cancel: their terms are of size |o - v0| |e| and their result a
// fraction of |e|^2, so the fused products and the plain version's
// differ by about eps |o - v0| |e| (to first order at most 19 units of
// roundoff, u = 2^-24, times |o - v0|_inf (|e1|_1 + |e2|_1)), whatever
// det is. So tol = FILTER_UV*det + ray.tol, where ray.tol =
// FILTER_ABS * reach * extent: reach bounds |o - v0|_inf over the mesh's
// box of v0 and extent is the mesh's largest |e1|_1 + |e2|_1 (pack_tris
// reduces both). FILTER_ABS is 8u, under that worst case, which is
// rarely approached, so that far from the mesh the filter still drops
// nearly every test: a float64 model of it passes every plain hit at
// 150 to 1.5e5 times the triangles' size away and at most 2% of all
// tests at the farthest, where a margin of det alone drops plain hits
// (tests/test_torch_kernel.py). With it the filter passes the candidates
// that the plain version accepts, and the kernel then computes the plain
// version's t, u, v and decisions: bit for bit, in practice. t, u and v
// are not taken from the fused products alone, which stray from the
// plain version's by more than the contract's 1e-5 (the same tests).
//
// Numerics contract, kernel against plain version (raycast_tiled_reference,
// raycast_reference; ops/mesh_cuda.py::compare_with_plain): rays whose hit
// mask or id differ number at most max(4, ceil(1e-4 x hits)); on rays
// whose ids agree, |dt| <= 1e-5 max(1, t) and |du|, |dv| <= 1e-5. It
// leaves room for a candidate whose fused t errs by more than
// FILTER_T_SCALE allows (a triangle seen almost edge-on) and for a
// difference past 8u in u*det or v*det, which the filter would drop.
//
// Kernel 2, raycast_kernel: a block of RT_THREADS threads holds RT_RAYS
// rays in registers per thread; the packed triangles [0, n_tris) stream
// through a two-stage ring in shared memory, three float4 (48 B) each, so
// the inner loop reads a triangle with three 16-byte broadcasts and tests
// it against RT_RAYS rays. cp.async fills the next stage while the
// current one is tested. Any ray count.
//
// Kernel 1, raycast_tiled_kernel: a tile's list is cut into chunks of
// TL_CHUNK candidates; a unit of work is (slice of TL_THREADS*TL_RAYS
// rays of one tile, one chunk), so no thread walks more than one chunk
// and the heaviest tile no longer sets the tail. plan_tiles lists the
// units and the tiles without candidates with atomics; a persistent grid
// takes them from an atomic counter, the chunks first (the empty tiles'
// stores then fill the tail; the other order took longer on the card).
// A tile without candidates writes the miss without reading its rays. A
// tile of one chunk writes its results directly. A tile of several
// chunks merges the chunks' bests with a
// 64-bit atomicMin on hit_key(t, id): t > 1e-4 > 0, so t's bits order as
// unsigned integers, and the smallest key is the smallest t and, among
// equal t, the smallest id, which is exactly what the strict-`<`
// ascending walk keeps. The last unit of a (tile, slice) to finish reads
// the keys back and recomputes u and v of each winner with exact_hit (the
// same values the winning test produced).

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e16f;

// Filter margins. FILTER_UV is 2^-7 of the triangle's barycentric extent
// beyond the plain version's 1e-5, for the rounding that scales with det
// (the reciprocal, det's own error); FILTER_ABS (2^-21, 8 units of
// roundoff) scales ray.tol, for the error that scales with the distance
// (the head of the file); FILTER_T_SCALE is 2^-10 of t beyond the best
// hit, far above the fused t's relative rounding error but for a
// triangle seen almost edge-on.
constexpr float FILTER_UV = 1e-5f + 0.0078125f;
constexpr float FILTER_ABS = 4.76837158203125e-07f;
constexpr float FILTER_T_SCALE = 1.0f + 0.0009765625f;

// Mesh extent that pack_tris reduces into the scratch: the maxima of
// -v0 and of v0 per axis (the box of v0) and of |e1|_1 + |e2|_1, as
// order_key words, so that atomicMax orders them and 0 lies below all.
constexpr int N_STATS = 7;

// Kernel 2. 128 threads x 4 rays: 4 rays a thread let one triangle read
// from shared memory serve 4 tests and give the scheduler 4 independent
// chains, within 128 registers (__launch_bounds__ below) and no spills.
// A stage of 128 triangles is 6 KB; two stages 12 KB.
constexpr int RT_THREADS = 128;
constexpr int RT_RAYS = 4;
constexpr int RT_STAGE = 128;

// Kernel 1. A unit is 256 rays (128 threads x 2) against at most 128
// candidates: the main path's 4,243 candidates in 24 busy tiles make 45
// chunks, 1,440 units, so that the tail is one short unit (chunks of 256
// took longer on the card). 2 rays a thread keep the registers, and with
// them the blocks per SM, up.
constexpr int TL_THREADS = 128;
constexpr int TL_RAYS = 2;
constexpr int TL_CHUNK = 128;
constexpr int TL_SLICE = TL_THREADS * TL_RAYS;
constexpr int PLAN_THREADS = 256;
constexpr int PACK_THREADS = 256;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tol;
};

// Floats to unsigned words in the same order (negative floats' bits
// inverted, positive floats' sign bit set).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ ((b >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xFFFFFFFFu));
}

struct Extent {
  float lox, loy, loz, hix, hiy, hiz, e;
};

__device__ __forceinline__ Extent load_extent(const unsigned* stats) {
  return Extent{-from_order_key(stats[0]), -from_order_key(stats[1]),
                -from_order_key(stats[2]), from_order_key(stats[3]),
                from_order_key(stats[4]),  from_order_key(stats[5]),
                from_order_key(stats[6])};
}

// A packed triangle: (v0, m.x), (e1, m.y), (e2, m.z) with m = e2 x e1.
struct Packed {
  float4 a, b, c;
};

struct Best {
  float t, u, v, lim;
  int i;
};

// A ray and its filter margin ray.tol (the head of the file).
__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        long long ray, bool active,
                                        const Extent& x) {
  if (!active) return Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  Ray r{o[ray * 3 + 0], o[ray * 3 + 1], o[ray * 3 + 2],
        d[ray * 3 + 0], d[ray * 3 + 1], d[ray * 3 + 2], 0.f};
  const float reach = fmaxf(
      fmaxf(fmaxf(__fsub_rn(r.ox, x.lox), __fsub_rn(x.hix, r.ox)),
            fmaxf(__fsub_rn(r.oy, x.loy), __fsub_rn(x.hiy, r.oy))),
      fmaxf(__fsub_rn(r.oz, x.loz), __fsub_rn(x.hiz, r.oz)));
  r.tol = __fmul_rn(__fmul_rn(FILTER_ABS, reach), x.e);
  return r;
}

__device__ __forceinline__ Best no_hit() {
  return Best{BIG, 0.f, 0.f, BIG * FILTER_T_SCALE, -1};
}

// Step 1: fused products, tests scaled by det (see the head of the file).
__device__ __forceinline__ bool may_hit(const Packed& p, const Ray& r,
                                        float lim) {
  const float tx = __fsub_rn(r.ox, p.a.x);
  const float ty = __fsub_rn(r.oy, p.a.y);
  const float tz = __fsub_rn(r.oz, p.a.z);
  const float sx = __fmaf_rn(ty, r.dz, -__fmul_rn(tz, r.dy));
  const float sy = __fmaf_rn(tz, r.dx, -__fmul_rn(tx, r.dz));
  const float sz = __fmaf_rn(tx, r.dy, -__fmul_rn(ty, r.dx));
  const float det =
      __fmaf_rn(r.dz, p.c.w, __fmaf_rn(r.dy, p.b.w, __fmul_rn(r.dx, p.a.w)));
  const float un =
      __fmaf_rn(sz, p.c.z, __fmaf_rn(sy, p.c.y, __fmul_rn(sx, p.c.x)));
  const float sv =  // -v*det
      __fmaf_rn(sz, p.b.z, __fmaf_rn(sy, p.b.y, __fmul_rn(sx, p.b.x)));
  const float tm =  // -t*det
      __fmaf_rn(tz, p.c.w, __fmaf_rn(ty, p.b.w, __fmul_rn(tx, p.a.w)));
  const float tol = __fmaf_rn(FILTER_UV, det, r.tol);
  return (un >= -tol) & (sv <= tol) &
         (__fsub_rn(un, sv) <= __fadd_rn(det, tol)) &
         (tm > __fmul_rn(-lim, det));
}

// Step 2: the plain version's arithmetic and tests, in its order, every
// operation rounded on its own (the caller adds t < best).
__device__ __forceinline__ bool exact_hit(const Packed& p, const Ray& r,
                                          float& t, float& u, float& v) {
  const float v0x = p.a.x, v0y = p.a.y, v0z = p.a.z;
  const float e1x = p.b.x, e1y = p.b.y, e1z = p.b.z;
  const float e2x = p.c.x, e2y = p.c.y, e2z = p.c.z;
  const float px = __fsub_rn(__fmul_rn(r.dy, e2z), __fmul_rn(r.dz, e2y));
  const float py = __fsub_rn(__fmul_rn(r.dz, e2x), __fmul_rn(r.dx, e2z));
  const float pz = __fsub_rn(__fmul_rn(r.dx, e2y), __fmul_rn(r.dy, e2x));
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, px), __fmul_rn(e1y, py)),
                              __fmul_rn(e1z, pz));
  const bool valid = det > 1e-9f;
  const float inv = __frcp_rn(valid ? det : 1.0f);
  const float tx = __fsub_rn(r.ox, v0x);
  const float ty = __fsub_rn(r.oy, v0y);
  const float tz = __fsub_rn(r.oz, v0z);
  u = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(tx, px), __fmul_rn(ty, py)),
                          __fmul_rn(tz, pz)),
                inv);
  const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
  const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
  const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
  v = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(r.dx, qx), __fmul_rn(r.dy, qy)),
                          __fmul_rn(r.dz, qz)),
                inv);
  t = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)),
                          __fmul_rn(e2z, qz)),
                inv);
  return valid && u >= -1e-5f && v >= -1e-5f && __fadd_rn(u, v) <= 1.00001f &&
         t > 1e-4f;
}

// One candidate against a thread's N rays: step 1 for each, and step 2
// behind a single branch for the rare candidate that passes for any.
template <int N>
__device__ __forceinline__ void walk_step(const Packed& p, int id,
                                          const Ray (&ray)[N],
                                          Best (&best)[N]) {
  bool pass[N];
  bool any = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    pass[k] = may_hit(p, ray[k], best[k].lim);
    any |= pass[k];
  }
  if (!any) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float t, u, v;
    if (pass[k] && exact_hit(p, ray[k], t, u, v) && t < best[k].t)
      best[k] = Best{t, u, v, __fmul_rn(t, FILTER_T_SCALE), id};
  }
}

// Mirrored by ops/mesh_cuda.py::pack_hit_keys.
__device__ __forceinline__ unsigned long long hit_key(float t, int id) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned int>(id);
}

__device__ __forceinline__ void write_hit(long long ray, const Best& b,
                                          float* t_out, int* idx_out,
                                          float* u_out, float* v_out) {
  t_out[ray] = b.t;
  idx_out[ray] = b.i;
  u_out[ray] = b.u;
  v_out[ray] = b.v;
}

// Triangles [v0 | e1 | e2] (36 B rows) -> Packed (48 B, 16-byte aligned),
// and the mesh extent into stats (zeroed by the caller).
__global__ void __launch_bounds__(PACK_THREADS)
pack_tris(const float* __restrict__ tri, int n_tris,
          float4* __restrict__ packed, unsigned* __restrict__ stats) {
  const int j = blockIdx.x * PACK_THREADS + threadIdx.x;
  unsigned key[N_STATS] = {0u, 0u, 0u, 0u, 0u, 0u, 0u};
  if (j < n_tris) {
    const float* s = tri + static_cast<long long>(j) * 9;
    const float e1x = s[3], e1y = s[4], e1z = s[5];
    const float e2x = s[6], e2y = s[7], e2z = s[8];
    const float mx = __fmaf_rn(e2y, e1z, -__fmul_rn(e2z, e1y));
    const float my = __fmaf_rn(e2z, e1x, -__fmul_rn(e2x, e1z));
    const float mz = __fmaf_rn(e2x, e1y, -__fmul_rn(e2y, e1x));
    packed[3 * j] = make_float4(s[0], s[1], s[2], mx);
    packed[3 * j + 1] = make_float4(e1x, e1y, e1z, my);
    packed[3 * j + 2] = make_float4(e2x, e2y, e2z, mz);
    const float e = __fadd_rn(
        __fadd_rn(__fadd_rn(fabsf(e1x), fabsf(e1y)), fabsf(e1z)),
        __fadd_rn(__fadd_rn(fabsf(e2x), fabsf(e2y)), fabsf(e2z)));
    key[0] = order_key(-s[0]);
    key[1] = order_key(-s[1]);
    key[2] = order_key(-s[2]);
    key[3] = order_key(s[0]);
    key[4] = order_key(s[1]);
    key[5] = order_key(s[2]);
    key[6] = order_key(e);
  }
#pragma unroll
  for (int k = 0; k < N_STATS; ++k) {
    const unsigned m = __reduce_max_sync(0xFFFFFFFFu, key[k]);
    if ((threadIdx.x & 31) == 0 && m != 0u) atomicMax(&stats[k], m);
  }
}

__device__ __forceinline__ Packed load_packed(const float4* p, int j) {
  return Packed{p[3 * j], p[3 * j + 1], p[3 * j + 2]};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies packed triangles [base, base + nb) into a stage.
__device__ __forceinline__ void stage_tris(float4* stage, const float4* packed,
                                           int base, int nb) {
  const float4* src = packed + static_cast<long long>(base) * 3;
  for (int k = threadIdx.x; k < nb * 3; k += RT_THREADS)
    cp_async16(stage + k, src + k);
  cp_async_commit();
}

__global__ void __launch_bounds__(RT_THREADS, 4)
raycast_kernel(const float4* __restrict__ packed,
               const unsigned* __restrict__ stats,
               const float* __restrict__ o, const float* __restrict__ d,
               int n_tris, long long n_rays, float* __restrict__ t_out,
               int* __restrict__ idx_out, float* __restrict__ u_out,
               float* __restrict__ v_out) {
  __shared__ float4 s_tri[2][RT_STAGE * 3];

  const long long first =
      static_cast<long long>(blockIdx.x) * (RT_THREADS * RT_RAYS) +
      threadIdx.x;
  const Extent x = load_extent(stats);
  Ray ray[RT_RAYS];
  Best best[RT_RAYS];
#pragma unroll
  for (int k = 0; k < RT_RAYS; ++k) {
    const long long r = first + k * RT_THREADS;
    ray[k] = load_ray(o, d, r, r < n_rays, x);
    best[k] = no_hit();
  }

  const int n_stages = (n_tris + RT_STAGE - 1) / RT_STAGE;
  if (n_stages > 0) stage_tris(s_tri[0], packed, 0, min(RT_STAGE, n_tris));
  for (int b = 0; b < n_stages; ++b) {
    const int base = b * RT_STAGE;
    const int nb = min(RT_STAGE, n_tris - base);
    if (b + 1 < n_stages) {
      stage_tris(s_tri[(b + 1) & 1], packed, base + RT_STAGE,
                 min(RT_STAGE, n_tris - base - RT_STAGE));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage b has landed for every thread's copies
    const float4* st = s_tri[b & 1];
#pragma unroll 2
    for (int j = 0; j < nb; ++j)
      walk_step(load_packed(st, j), base + j, ray, best);
    __syncthreads();  // stage b is read before it is filled again
  }
#pragma unroll
  for (int k = 0; k < RT_RAYS; ++k) {
    const long long r = first + k * RT_THREADS;
    if (r < n_rays) write_hit(r, best[k], t_out, idx_out, u_out, v_out);
  }
}

// Work list of the tiled kernel, laid out in the caller's scratch.
struct TiledWork {
  unsigned long long* keys;  // per ray; only multi-chunk tiles' are used
  int* ctr;                  // chunks, empty tiles, next unit taken
  unsigned* stats;           // the mesh extent (pack_tris), after ctr
  int2* chunks;              // (tile, chunk) of every chunk
  int* empty;                // tiles without candidates
  int* done;                 // finished chunks per (tile, slice)
};

__device__ __forceinline__ int tile_count(const int* counts, int tile,
                                          int list_len) {
  return min(counts[tile], list_len);
}

// One block per tile: lists its chunks or marks it empty, and readies the
// keys and chunk counters of a tile of several chunks.
__global__ void __launch_bounds__(PLAN_THREADS)
plan_tiles(const int* __restrict__ counts, int list_len, int tile_rays,
           int slices, TiledWork w) {
  const int tile = blockIdx.x;
  const int c = tile_count(counts, tile, list_len);
  const int n_chunks = (c + TL_CHUNK - 1) / TL_CHUNK;
  if (n_chunks > 1) {
    const unsigned long long miss = hit_key(BIG, -1);
    for (int r = threadIdx.x; r < tile_rays; r += PLAN_THREADS)
      w.keys[static_cast<long long>(tile) * tile_rays + r] = miss;
    for (int s = threadIdx.x; s < slices; s += PLAN_THREADS)
      w.done[tile * slices + s] = 0;
  }
  if (threadIdx.x != 0) return;
  if (n_chunks == 0) {
    w.empty[atomicAdd(&w.ctr[1], 1)] = tile;
    return;
  }
  const int first = atomicAdd(&w.ctr[0], n_chunks);
  for (int k = 0; k < n_chunks; ++k) w.chunks[first + k] = make_int2(tile, k);
}

__global__ void __launch_bounds__(TL_THREADS)
raycast_tiled_kernel(const float4* __restrict__ packed,
                     const float* __restrict__ o,
                     const float* __restrict__ d,
                     const int* __restrict__ lists,
                     const int* __restrict__ counts, int list_len,
                     int tile_rays, int slices, TiledWork w,
                     float* __restrict__ t_out, int* __restrict__ idx_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 s_tri[TL_CHUNK * 3];
  __shared__ int s_id[TL_CHUNK];
  __shared__ int s_unit, s_last;

  const int chunk_units = w.ctr[0] * slices;
  const int units = chunk_units + w.ctr[1];
  const Extent x = load_extent(w.stats);
  for (;;) {
    if (threadIdx.x == 0) s_unit = atomicAdd(&w.ctr[2], 1);
    __syncthreads();
    const int unit = s_unit;
    __syncthreads();  // every thread has read s_unit before it changes
    if (unit >= units) return;

    if (unit >= chunk_units) {  // a tile without candidates: the miss
      const long long first =
          static_cast<long long>(w.empty[unit - chunk_units]) * tile_rays;
      for (int r = threadIdx.x; r < tile_rays; r += TL_THREADS)
        write_hit(first + r, no_hit(), t_out, idx_out, u_out, v_out);
      continue;
    }

    const int job_i = unit / slices;
    const int2 job = w.chunks[job_i];
    const int tile = job.x, slice = unit - job_i * slices;
    const int c = tile_count(counts, tile, list_len);
    const int n_chunks = (c + TL_CHUNK - 1) / TL_CHUNK;
    const int base = job.y * TL_CHUNK;
    const int nb = min(TL_CHUNK, c - base);
    const int* list = lists + static_cast<long long>(tile) * list_len + base;
    for (int k = threadIdx.x; k < nb; k += TL_THREADS) {
      const int id = list[k];
      s_id[k] = id;
      s_tri[3 * k] = packed[3 * id];
      s_tri[3 * k + 1] = packed[3 * id + 1];
      s_tri[3 * k + 2] = packed[3 * id + 2];
    }
    __syncthreads();

    const long long tile0 = static_cast<long long>(tile) * tile_rays;
    const int r0 = slice * TL_SLICE + threadIdx.x;
    Ray ray[TL_RAYS];
    Best best[TL_RAYS];
#pragma unroll
    for (int k = 0; k < TL_RAYS; ++k) {
      const int r = r0 + k * TL_THREADS;
      ray[k] = load_ray(o, d, tile0 + r, r < tile_rays, x);
      best[k] = no_hit();
    }
#pragma unroll 2
    for (int j = 0; j < nb; ++j)
      walk_step(load_packed(s_tri, j), s_id[j], ray, best);

    if (n_chunks == 1) {
#pragma unroll
      for (int k = 0; k < TL_RAYS; ++k) {
        const int r = r0 + k * TL_THREADS;
        if (r < tile_rays)
          write_hit(tile0 + r, best[k], t_out, idx_out, u_out, v_out);
      }
    } else {
#pragma unroll
      for (int k = 0; k < TL_RAYS; ++k) {
        const int r = r0 + k * TL_THREADS;
        if (r < tile_rays && best[k].i >= 0)
          atomicMin(&w.keys[tile0 + r], hit_key(best[k].t, best[k].i));
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        s_last = atomicAdd(&w.done[tile * slices + slice], 1) == n_chunks - 1;
      __syncthreads();
      if (s_last) {  // every chunk of this slice is merged: finish it
        __threadfence();
#pragma unroll
        for (int k = 0; k < TL_RAYS; ++k) {
          const int r = r0 + k * TL_THREADS;
          if (r >= tile_rays) continue;
          const unsigned long long key = __ldcg(&w.keys[tile0 + r]);
          Best b = no_hit();
          b.i = static_cast<int>(static_cast<unsigned int>(key));
          if (b.i >= 0) {
            float t;
            exact_hit(load_packed(packed, b.i), ray[k], t, b.u, b.v);
            b.t = __uint_as_float(static_cast<unsigned int>(key >> 32));
          }
          write_hit(tile0 + r, b, t_out, idx_out, u_out, v_out);
        }
      }
    }
    __syncthreads();  // s_tri, s_id and s_last are free for the next unit
  }
}

long long align_up(long long bytes) { return (bytes + 255) / 256 * 256; }

long long packed_bytes(int n_tris) {
  return align_up(static_cast<long long>(n_tris) * 3 * sizeof(float4));
}

// The tiled kernel's three counters and the mesh extent, zeroed together.
constexpr int N_HEAD = 3 + N_STATS;

struct TiledLayout {
  long long packed, keys, ctr, chunks, empty, done, total;
};

TiledLayout tiled_layout(int n_tris, int n_tiles, int list_len,
                         int tile_rays) {
  const long long slices = (tile_rays + TL_SLICE - 1) / TL_SLICE;
  const long long max_chunks =
      static_cast<long long>(n_tiles) * ((list_len + TL_CHUNK - 1) / TL_CHUNK);
  TiledLayout l;
  l.packed = 0;
  l.keys = packed_bytes(n_tris);
  l.ctr = l.keys + align_up(static_cast<long long>(n_tiles) * tile_rays * 8);
  l.chunks = l.ctr + align_up(N_HEAD * sizeof(int));
  l.empty = l.chunks + align_up(max_chunks * sizeof(int2));
  l.done = l.empty + align_up(static_cast<long long>(n_tiles) * sizeof(int));
  l.total = l.done + align_up(n_tiles * slices * sizeof(int));
  return l;
}

cudaError_t launch_pack(const float* tri, int n_tris, float4* packed,
                        unsigned* stats, cudaStream_t s) {
  if (n_tris > 0)
    pack_tris<<<(n_tris + PACK_THREADS - 1) / PACK_THREADS, PACK_THREADS, 0,
                s>>>(tri, n_tris, packed, stats);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch each entry point needs for these shapes.
extern "C" long long nmr_raycast_tiled_scratch(int n_tris, int n_tiles,
                                               int list_len, int tile_rays) {
  return tiled_layout(n_tris, n_tiles, list_len, tile_rays).total;
}

extern "C" long long nmr_raycast_scratch(int n_tris) {
  return packed_bytes(n_tris) + align_up(N_STATS * sizeof(unsigned));
}

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns the first cudaError_t (0 on success); none synchronises or
// allocates. `scratch` holds the bytes that the matching *_scratch
// function gives, 256-byte aligned.
extern "C" int nmr_raycast_tiled(const float* tri, int n_tris, const float* o,
                                 const float* d, const int* lists,
                                 const int* counts, int list_len,
                                 int n_tiles, int tile_rays, float* t,
                                 int* idx, float* u, float* v, void* scratch,
                                 void* stream) {
  if (n_tiles == 0 || tile_rays == 0) return 0;
  static int grid = 0;  // a persistent grid: every block resident at once
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  raycast_tiled_kernel,
                                                  TL_THREADS, 0);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const TiledLayout l = tiled_layout(n_tris, n_tiles, list_len, tile_rays);
  char* base = static_cast<char*>(scratch);
  float4* packed = reinterpret_cast<float4*>(base + l.packed);
  TiledWork w;
  w.keys = reinterpret_cast<unsigned long long*>(base + l.keys);
  w.ctr = reinterpret_cast<int*>(base + l.ctr);
  w.stats = reinterpret_cast<unsigned*>(w.ctr + 3);
  w.chunks = reinterpret_cast<int2*>(base + l.chunks);
  w.empty = reinterpret_cast<int*>(base + l.empty);
  w.done = reinterpret_cast<int*>(base + l.done);
  const int slices = (tile_rays + TL_SLICE - 1) / TL_SLICE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(w.ctr, 0, N_HEAD * sizeof(int), s);
  if (err == cudaSuccess) err = launch_pack(tri, n_tris, packed, w.stats, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_tiles<<<n_tiles, PLAN_THREADS, 0, s>>>(counts, list_len, tile_rays,
                                              slices, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  raycast_tiled_kernel<<<grid, TL_THREADS, 0, s>>>(
      packed, o, d, lists, counts, list_len, tile_rays, slices, w, t, idx, u,
      v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nmr_raycast(const float* tri, const float* o, const float* d,
                           int n_tris, long long n_rays, float* t, int* idx,
                           float* u, float* v, void* scratch, void* stream) {
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* packed = static_cast<float4*>(scratch);
  unsigned* stats = reinterpret_cast<unsigned*>(
      static_cast<char*>(scratch) + packed_bytes(n_tris));
  cudaError_t err = cudaMemsetAsync(stats, 0, N_STATS * sizeof(unsigned), s);
  if (err == cudaSuccess) err = launch_pack(tri, n_tris, packed, stats, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (n_rays + RT_THREADS * RT_RAYS - 1) / (RT_THREADS * RT_RAYS);
  raycast_kernel<<<static_cast<unsigned>(blocks), RT_THREADS, 0, s>>>(
      packed, stats, o, d, n_tris, n_rays, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}
