// The frame around the march for Hopper: four kernels that take the
// place of the eager aten glue between the mesh ray-cast, the march and
// the frame buffer (ops/frame_cuda.py holds their wrappers and plain
// versions). On the TPU, XLA fused this glue into the frame's few
// programs; run eagerly it was ~320 device operations and 3 host reads of
// the exact 720p hybrid frame's 482 (PERF.md section 5), none of them
// long, each a launch the host waits to issue.
//
//   mesh_plan_kernel (nmr_mesh_plan) replaces ops/triangles.py's
//       world_triangles (three batched einsums and gathers), _bin_triangles
//       (the projection, the bbox tests and a stable argsort over
//       (n_tiles, T) that front-packs each tile's list) and the ray
//       generation of tiled_raycast_inputs (the ndc @ cam3.T matmul, the
//       norm, the tile-major permute, the broadcast origin's copy), all
//       now ops/frame_cuda.py::mesh_plan_reference (formerly
//       ops/triangles.py:133, :304 and :335); JAX
//       nerf_glasses_tpu/ops/triangles.py:603 _bin_triangles and the ray
//       and triangle set-up of render_mesh_pass_tiled (:383).
//       What bounds it: the bytes that are read later: the rays of the
//       tiles that hold a candidate (24 B a ray, 8192 a tile; 24 of the
//       720p x 2 pass's 460 tiles), the triangles and the candidates.
//       Design: a block a tile, in clusters of PLAN_CLUSTER blocks. Each
//       round of PLAN_CLUSTER x 256 triangles, a block's threads put a
//       triangle each in world space from the instance transforms (kernel
//       parameters while they fit) and project its padded screen bbox into
//       shared memory; then each block tests its tile against the round's
//       boxes, read from the cluster's blocks (distributed shared memory),
//       so a triangle is projected once a cluster rather than once a tile.
//       Each thread keeps a bit a box; one block scan of the warps'
//       counts front-packs the overlapping ids in ascending order (no
//       sort). Only a row's first count entries are written: the ray-cast
//       reads no further (the plain version's argsort also orders the
//       rest). Then, where its count is above 0, the block writes its
//       tile's 8192 rays, four a thread at a time as three 16 B stores
//       each of o and d, consecutive threads on consecutive bytes. The
//       rays of a tile with no candidate are left unwritten, undefined:
//       the tiled ray-cast writes such a tile's misses without reading its
//       rays, and the shade reads a ray only for a hit (at 720p x 2 all
//       the rays are 90 MB, the busy tiles' 4.7 MB: PERF.md).
//   surface_shade_kernel (nmr_surface_shade) replaces the body of
//       ops/triangles.py::render_mesh_pass_tiled after the ray-cast:
//       stable_partition_ids over the tiles with hits (two host reads),
//       the gathers of those tiles, shade_hits (the TBN, the five texture
//       slots, GGX, the batched einsums), linear_to_srgb, the FxF
//       coverage average and depth max, the scatter and the permute back
//       to row-major, now frame_cuda.py::surface_shade_reference and
//       shade_hits (formerly triangles.py:387-422 and :202-283); JAX
//       triangles.py:254 shade_hits, :529 render_mesh_surface, :699
//       downsample_surface.
//       What bounds it: the output it writes (20 B a NeRF pixel) and the
//       busy tiles' hits it reads; the hits' shading (a few per cent of the
//       rays, each four powf and up to five texture fetches in a chain)
//       sets the latency. Design: one launch of persistent blocks; each
//       lists the busy tiles from the counts (a block scan in shared
//       memory) and walks work units: first the busy tiles' rays, a thread
//       a supersampled ray with a pixel's F x F rays in adjacent lanes,
//       their terms summed by the pixel's first lane from shuffles in the
//       order of a thread-per-pixel loop over them (fy outer, fx inner),
//       so a pixel's sums are that loop's bit for bit; then the idle
//       tiles' pixels, zeros in 16-byte stores.
//       Materials from one table and one texel buffer packed at load_mesh;
//       outputs row-major (H, W, 4) and (H, W), the layout the march
//       takes.
//   ray_init_kernel (nmr_ray_init) replaces ops/raymarch.py's ray
//       generation for a plain perspective camera (render_image_device),
//       init_rays before and after its walk (the aabb entry, the
//       containment test, the surface takeover, the start-t jitter,
//       t_start), _make_state's fills and the flash floor rule, and on the
//       list route the first live-ray list (torch.nonzero), now
//       frame_cuda.py::ray_init_reference, init_rays and make_state
//       (formerly raymarch.py:950-1018, :279-303, :418-443 and :796); JAX
//       raymarch.py:518 init_rays, :690 _make_state, :1472
//       render_image_device.
//       What bounds it: the state it writes (~77 B a ray). Design: a
//       thread a pixel; where init_rays has a walk (several cascades, a
//       cone angle) the wrapper splits it in two stages around the walk
//       kernel (STAGE_RAYS before, STAGE_STATE after, each array written
//       by one of them); else one launch does both in registers. Rays the
//       caller made (another camera model, a march of given rays:
//       STAGE_GIVEN) are read in place of the camera's. The
//       list: a block scan of the alive flags and one atomicAdd a block
//       (the count zeroed by the entry point), so a block's rays stay
//       together and in order.
//   finalize_kernel (nmr_frame_finalize) replaces raymarch.py's _finalize
//       (the w > 0.001 keep, the alpha > 0.2 depth gate) and _shade_frame
//       (srgb_to_linear), now frame_cuda.py::finalize_reference (formerly
//       raymarch.py:672 and :1034); JAX raymarch.py:1096 and :1515.
//       Bound: its 40 B a pixel; one elementwise pass writing the (H, W,
//       4) frame and the (H, W) depth.
//
// Numerics: the plain versions' float32 operations one by one (built with
// -fmad=false: no product and sum fuse unless written fmaf). The card's
// plain version divides by a Python number as the product with its
// float32 reciprocal (aten's div_true with a CPU scalar); the kernels take
// the same reciprocals, made on the host. A matrix product of the plain
// version (the einsums, ndc @ cam3.T) is a library's, whose order is its
// own: here an FMA chain from the first term (the GEMM's, bit for bit on
// the card; the batched GEMV of the shade's normal matrices may differ),
// and a sum or norm over 3 in the order of aten's reduction. So the lists
// and counts of the mesh plan, the coverage and depth of the surface
// shade, and the flags of the ray init come out as the plain version's (a
// bbox edge or a containment test a rounding away from a boundary aside),
// the floats within a few ulps (ops/frame_cuda.py::compare_with_plain's
// contract).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 128;
constexpr int TILE_H = 64;
constexpr int TILE_RAYS = TILE_W * TILE_H;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PLAN_CLUSTER = 8;     // the plan's blocks that share boxes
constexpr float F32_MAX = 3.402823466e38f;

}  // namespace

constexpr int MAX_INSTANCES = 16;   // instance transforms passed by value
constexpr int MAT_STRIDE = 12;      // floats a material in the table
constexpr int TEX_SLOTS = 5;

// Layouts shared with ops/frame_cuda.py (ctypes structures of the same
// names and order).
struct PlanParams {
  float cam[12];        // the packed camera (3, 4), row-major
  float cam_inv[9];     // inverse of cam[:, :3], row-major
  float inv_w, inv_h;   // float32 1 / width, 1 / height
  float width_f, height_f, wp_f;
  float hp_f;
  int n_tris, n_inst, ntx, nty, n_tiles;
  float xf[MAX_INSTANCES * 12];   // instance transforms (I, 3, 4)
};

struct PlanArgs {
  const float *v0, *e1, *e2;      // (T, 3) object space
  const long long* inst;          // (T,)
  const float* xf;                // (I, 3, 4) on the device, or null: P.xf
  float* tri;                     // (T, 9) world [v0 | e1 | e2]
  float *o, *d;                   // (n_tiles * 8192, 3) tile-major; a
                                  // tile with count 0 left unwritten
  int* lists;                     // (n_tiles, T): row k's first counts[k]
  int* counts;                    // (n_tiles,)
};

struct ShadeParams {
  float eye[3], light[3];
  float inv_ff;         // float32 1 / (F * F)
  int out_w, out_h, factor, ntx, n_inst, n_mat, n_tiles;
  float nrm[MAX_INSTANCES * 9];   // instance normal matrices (I, 3, 3)
};

struct ShadeArgs {
  const float *t, *u, *v;         // the ray-cast's outputs (n_tiles * 8192,)
  const int* tri;
  const int* counts;              // (n_tiles,)
  const float* d;                 // (n_tiles * 8192, 3)
  const float *n, *tan, *uv;      // (T, 3, 3), (T, 3, 4), (T, 3, 2)
  const long long *mat_id, *inst_id;
  const float* nrm;               // (I, 3, 3) on the device, or null: P.nrm
  const float* mat;               // (M, MAT_STRIDE)
  const int* tex;                 // (M, TEX_SLOTS, 4): offset, h, w, c
  const float* texels;
  float* rgba;                    // (out_h, out_w, 4)
  float* depth;                   // (out_h, out_w)
};

// STAGE_GIVEN: the rays are the caller's, in o and d
enum { STAGE_RAYS = 1, STAGE_STATE = 2, STAGE_GIVEN = 4 };

struct InitParams {
  float cam[12];
  float eye[3];         // cam[:, 3] + 0.5
  float ox, oy;         // sub-pixel offsets
  float inv_w, inv_h;
  float cone, dt_min, dt_max;
  int width, height, stage, jitter, max_cascade;
  int lowres_f, coarse_w;         // flash floor: factor and coarse width
  int make_list;
  unsigned int seed;
};

struct InitArgs {
  const float *box_lo, *box_hi;   // the render aabb (3,)
  const float *surf_in, *t_surf_in;   // (N, 4), (N,), or null: none
  const float* t_floor;           // (Hl, Wl) or null
  const uint8_t* alive_img;       // (Hl, Wl)
  const float* t_walk;            // STAGE_STATE alone: the walk's t, alive
  const uint8_t* alive_walk;
  float *o, *d;                   // (N, 3), read with STAGE_GIVEN
  float *surf, *t_surf;           // written where none is given, or
                                  // copied where they are not surf_in's
  float* t_pre;                   // STAGE_RAYS alone: t, alive for the walk
  uint8_t* alive_pre;
  float *t, *t_start, *rgba, *depth, *max_weight, *wn, *surf_a;
  uint8_t* alive;
  int *ids, *n_ids;               // the first live-ray list and its length
};

struct FinalizeParams {
  int n, linear;
  float keep_a, depth_a;          // 0.001, 0.2
  float lin_cut, inv_1292, add, inv_1055, gamma;
};

struct FinalizeArgs {
  const float *rgba_in, *depth_in;
  float *rgba, *depth;
};

namespace {

// torch.minimum / maximum / amin / amax: a NaN operand gives NaN.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
// torch.clamp(x, min=lo) keeping NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x > hi ? hi : x;
}

// row r of m (3 x k, row-major, stride s) times x: an FMA chain from the
// first term, the order a GEMM takes its k steps
__device__ __forceinline__ float row3(const float* m, int s, int r,
                                      const float x[3]) {
  return fmaf(m[s * r + 2], x[2], fmaf(m[s * r + 1], x[1], m[s * r] * x[0]));
}

// A sum over a contiguous dim of 3 as aten's reduction runs it on the
// card: two threads, the first with elements 0 and 2 in two accumulators,
// combined, then the second's element 1.
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}

// vector_norm over 3: the squares summed so, then sqrt
__device__ __forceinline__ float norm3(const float x[3]) {
  return sqrtf(sum3(x[0] * x[0], x[1] * x[1], x[2] * x[2]));
}

// This thread's place among the block's flags that are set and their
// total (a ballot a warp, the warps' counts scanned by warp 0). Every
// thread of the block calls it; s holds 2 * WARPS + 1 ints.
__device__ __forceinline__ int block_scan(bool flag, int* s, int& total) {
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int c = lane < WARPS ? s[lane] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane < WARPS) s[WARPS + lane] = incl - c;
    if (lane == 31) s[2 * WARPS] = incl;
  }
  __syncthreads();
  total = s[2 * WARPS];
  const int pos = s[WARPS + warp] + __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();
  return pos;
}

// ---------------------------------------------------------------------------
// nmr_mesh_plan
// ---------------------------------------------------------------------------

// triangle i in world space (world_triangles: rot @ x, + the translation
// for v0)
__device__ __forceinline__ void world_tri(const PlanArgs& a, const float* xf,
                                          int i, float w[9]) {
  const float* m = xf + 12 * a.inst[i];
  float x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* src = k == 0 ? a.v0 : (k == 1 ? a.e1 : a.e2);
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = src[3 * i + c];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float p = row3(m, 4, r, x);
      w[3 * k + r] = k == 0 ? p + m[4 * r + 3] : p;
    }
  }
}

// _bin_triangles' screen bbox of world triangle w, padded by a pixel, or
// the whole screen where a vertex lies at or behind the eye plane ->
// (xmin, xmax, ymin, ymax)
__device__ __forceinline__ float4 tri_bbox(const PlanParams& P,
                                           const float w[9]) {
  bool behind = false;
  float xmin = 0.0f, xmax = 0.0f, ymin = 0.0f, ymax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float q[3], ndc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = k == 0 ? w[c] : w[c] + w[3 * k + c];
      q[c] = v - P.cam[4 * c + 3];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) ndc[r] = row3(P.cam_inv, 3, r, q);
    const float z = ndc[2];
    behind = behind || z <= 1e-6f;
    const float zs = z <= 1e-6f ? 1.0f : z;
    const float px = (ndc[0] / zs * 0.5f + 0.5f) * P.width_f;
    const float py = (ndc[1] / zs * 0.5f + 0.5f) * P.height_f;
    xmin = k == 0 ? px : nmin(xmin, px);
    xmax = k == 0 ? px : nmax(xmax, px);
    ymin = k == 0 ? py : nmin(ymin, py);
    ymax = k == 0 ? py : nmax(ymax, py);
  }
  if (behind) return make_float4(0.0f, P.wp_f, 0.0f, P.hp_f);
  return make_float4(xmin - 1.0f, xmax + 1.0f, ymin - 1.0f, ymax + 1.0f);
}

// the bbox test against the tile at (tx0, ty0)
__device__ __forceinline__ bool overlaps(const float4 b, float tx0, float ty0) {
  return b.y >= tx0 && b.x <= tx0 + (float)TILE_W && b.w >= ty0 &&
         b.z <= ty0 + (float)TILE_H;
}

// A block a tile (blocks past the last tile only help their cluster
// project): its list (the overlapping ids ascending) and count, then,
// where the count is above 0, its rays (ray p of the tile is pixel (p /
// 128, p % 128) of it). Round r's chunk k (triangles (8r + k) * 256 on)
// is projected by block k of every cluster and written out in world
// space by cluster r mod the clusters.
__global__ void __cluster_dims__(PLAN_CLUSTER, 1, 1) __launch_bounds__(THREADS)
mesh_plan_kernel(PlanParams P, PlanArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  __shared__ float s_xf[MAX_INSTANCES * 12];
  __shared__ float4 s_box[THREADS];
  __shared__ int s_cnt[PLAN_CLUSTER * WARPS];   // a (chunk, warp)'s ids
  __shared__ int s_total;
  if (a.xf == nullptr) {
    for (int k = threadIdx.x; k < 12 * P.n_inst; k += THREADS) s_xf[k] = P.xf[k];
  }
  __syncthreads();
  const float* xf = a.xf != nullptr ? a.xf : s_xf;
  const int tile = blockIdx.x;
  const bool has_tile = tile < P.n_tiles;        // uniform in the block
  const int ty = tile / P.ntx, tx = tile - ty * P.ntx;
  const float tx0 = (float)(tx * TILE_W), ty0 = (float)(ty * TILE_H);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_clusters = gridDim.x / PLAN_CLUSTER;
  const int cl = blockIdx.x / PLAN_CLUSTER;
  int* list = a.lists + (long long)tile * P.n_tris;
  int count = 0;
  for (int r = 0, base0 = 0; base0 < P.n_tris;
       ++r, base0 += PLAN_CLUSTER * THREADS) {
    // this block's chunk of the round, into its boxes
    const int i = base0 + rank * THREADS + threadIdx.x;
    if (i < P.n_tris) {
      float w[9];
      world_tri(a, xf, i, w);
      s_box[threadIdx.x] = tri_bbox(P, w);
      if (r % n_clusters == cl) {
#pragma unroll
        for (int c = 0; c < 9; ++c) a.tri[9LL * i + c] = w[c];
      }
    }
    cluster.sync();
    // the tile against the round's boxes, chunk c from block c
    unsigned bits = 0;
    if (has_tile) {
#pragma unroll
      for (int c = 0; c < PLAN_CLUSTER; ++c) {
        const int id = base0 + c * THREADS + threadIdx.x;
        const bool ov = id < P.n_tris &&
            overlaps(cluster.map_shared_rank(s_box, c)[threadIdx.x], tx0, ty0);
        bits |= (unsigned)ov << c;
        const unsigned ballot = __ballot_sync(0xffffffffu, ov);
        if (lane == 0) s_cnt[c * WARPS + warp] = __popc(ballot);
      }
    }
    cluster.sync();       // (no block writes boxes before all are read)
    if (has_tile) {
      // the (chunk, warp) counts scanned in id order, two a lane
      if (warp == 0) {
        const int v0 = s_cnt[2 * lane], v1 = s_cnt[2 * lane + 1];
        int incl = v0 + v1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        s_cnt[2 * lane] = incl - v0 - v1;
        s_cnt[2 * lane + 1] = incl - v1;
        if (lane == 31) s_total = incl;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < PLAN_CLUSTER; ++c) {
        const bool ov = bits >> c & 1u;
        const unsigned ballot = __ballot_sync(0xffffffffu, ov);
        if (ov)
          list[count + s_cnt[c * WARPS + warp] +
               __popc(ballot & ((1u << lane) - 1u))] =
              base0 + c * THREADS + threadIdx.x;
      }
      count += s_total;
    }
  }
  if (!has_tile) return;
  if (threadIdx.x == 0) a.counts[tile] = count;
  if (count == 0) return;              // (the block's total: uniform)
  // four rays a thread at a time: 48 B of o and of d, three 16 B stores
  // each (the tile's rays start 16 B aligned)
  const long long r0 = (long long)tile * TILE_RAYS;
  float4* const o4 = reinterpret_cast<float4*>(a.o + 3 * r0);
  float4* const d4 = reinterpret_cast<float4*>(a.d + 3 * r0);
  const float e0 = P.cam[3], e1 = P.cam[7], e2 = P.cam[11];
  for (int g = threadIdx.x; g < TILE_RAYS / 4; g += THREADS) {
    float v[12];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * g + k;
      const float px = (float)(tx * TILE_W + p % TILE_W) + 0.5f;
      const float py = (float)(ty * TILE_H + p / TILE_W) + 0.5f;
      const float ndc[3] = {px * P.inv_w * 2.0f - 1.0f,
                            py * P.inv_h * 2.0f - 1.0f, 1.0f};
      float d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = row3(P.cam, 4, c, ndc);
      const float len = norm3(d);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 * k + c] = d[c] / len;
    }
    d4[3 * g] = make_float4(v[0], v[1], v[2], v[3]);
    d4[3 * g + 1] = make_float4(v[4], v[5], v[6], v[7]);
    d4[3 * g + 2] = make_float4(v[8], v[9], v[10], v[11]);
    o4[3 * g] = make_float4(e0, e1, e2, e0);
    o4[3 * g + 1] = make_float4(e1, e2, e0, e1);
    o4[3 * g + 2] = make_float4(e2, e0, e1, e2);
  }
}

// ---------------------------------------------------------------------------
// nmr_surface_shade
// ---------------------------------------------------------------------------

// torch.sum(a * b, -1)
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// _normalize: x / clamp(|x|, min=1e-9)
__device__ __forceinline__ void normalize3(float x[3]) {
  const float len = nmax(norm3(x), 1e-9f);
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = x[c] / len;
}

// torch.remainder(x, 1.0)
__device__ __forceinline__ float wrap1(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

__device__ __forceinline__ long long pymod(long long x, long long n) {
  const long long m = x % n;
  return m < 0 ? m + n : m;
}

// _sample_texture: bilinear, repeat wrap, texel centres at +0.5; a
// texture of c < 4 channels broadcasts its last one, as the plain
// version's products do
__device__ void sample_texture(const float* texels, const int* te, float uvx,
                               float uvy, float out[4]) {
  const int h = te[1], w = te[2], c = te[3];
  const float* tex = texels + te[0];
  const float su = wrap1(uvx) * (float)w - 0.5f;
  const float sv = wrap1(uvy) * (float)h - 0.5f;
  const float fx0 = floorf(su), fy0 = floorf(sv);
  const long long x0 = (long long)fx0, y0 = (long long)fy0;
  const float fx = su - fx0, fy = sv - fy0;
  const long long xa = pymod(x0, w), xb = pymod(x0 + 1, w);
  const long long ya = pymod(y0, h), yb = pymod(y0 + 1, h);
  const float* t00 = tex + (ya * w + xa) * c;
  const float* t10 = tex + (ya * w + xb) * c;
  const float* t01 = tex + (yb * w + xa) * c;
  const float* t11 = tex + (yb * w + xb) * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ch = k < c ? k : c - 1;
    out[k] = t00[ch] * (1.0f - fx) * (1.0f - fy) + t10[ch] * fx * (1.0f - fy) +
             t01[ch] * (1.0f - fx) * fy + t11[ch] * fx * fy;
  }
}

__device__ __forceinline__ float linear_to_srgb(float x) {
  return x < 0.0031308f ? 12.92f * x
                        : 1.055f * powf(nmax(x, 1e-12f), 0.41666f) - 0.055f;
}

// shade_hits for one hit: PBR metallic-roughness -> linear rgb
__device__ void shade_hit(const ShadeParams& P, const ShadeArgs& a,
                          const float* nrm_mats, int tri, float u, float v,
                          float t, const float d[3], float rgb[3]) {
  const float w0 = 1.0f - u - v;
  const float* nv = a.n + 9LL * tri;
  const float* tv = a.tan + 12LL * tri;
  const float* uvv = a.uv + 6LL * tri;
  const float* nm = nrm_mats + 9 * a.inst_id[tri];
  float n_obj[3], tan4[4], uv[2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    n_obj[c] = w0 * nv[c] + u * nv[3 + c] + v * nv[6 + c];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    tan4[c] = w0 * tv[c] + u * tv[4 + c] + v * tv[8 + c];
#pragma unroll
  for (int c = 0; c < 2; ++c)
    uv[c] = w0 * uvv[c] + u * uvv[2 + c] + v * uvv[4 + c];
  float nrm[3], tan_w[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    nrm[r] = row3(nm, 3, r, n_obj);
    tan_w[r] = row3(nm, 3, r, tan4);
  }
  const long long mid = a.mat_id[tri];
  const float* mat = a.mat + MAT_STRIDE * mid;
  float base[4] = {mat[0], mat[1], mat[2], mat[3]};
  float metallic = mat[4], roughness = mat[5];
  float emissive[3] = {mat[6], mat[7], mat[8]};
  const float normal_scale = mat[9], occ_strength = mat[10];
  float occlusion = 1.0f;

  // TBN (Gram-Schmidt)
  normalize3(nrm);
  const float tn = dot3(tan_w, nrm);
  float tng[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) tng[c] = tan_w[c] - nrm[c] * tn;
  normalize3(tng);
  const float btn[3] = {(nrm[1] * tng[2] - nrm[2] * tng[1]) * tan4[3],
                        (nrm[2] * tng[0] - nrm[0] * tng[2]) * tan4[3],
                        (nrm[0] * tng[1] - nrm[1] * tng[0]) * tan4[3]};
  float normal[3] = {nrm[0], nrm[1], nrm[2]};

  const int* tex = a.tex + (long long)TEX_SLOTS * 4 * mid;
  float s[4];
  if (tex[0 * 4 + 1] > 0) {             // base colour
    sample_texture(a.texels, tex, uv[0], uv[1], s);
#pragma unroll
    for (int c = 0; c < 4; ++c) base[c] = base[c] * s[c];
  }
  if (tex[1 * 4 + 1] > 0) {             // metallic-roughness
    sample_texture(a.texels, tex + 4, uv[0], uv[1], s);
    metallic = metallic * s[2];
    roughness = roughness * s[1];
  }
  if (tex[2 * 4 + 1] > 0) {             // emissive
    sample_texture(a.texels, tex + 8, uv[0], uv[1], s);
#pragma unroll
    for (int c = 0; c < 3; ++c) emissive[c] = emissive[c] * s[c];
  }
  if (tex[3 * 4 + 1] > 0) {             // normal map
    sample_texture(a.texels, tex + 12, uv[0], uv[1], s);
    const float nx = (s[0] * 2.0f - 1.0f) * normal_scale;
    const float ny = (s[1] * 2.0f - 1.0f) * normal_scale;
    const float nz = (s[2] * 2.0f - 1.0f) * 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      normal[c] = tng[c] * nx + btn[c] * ny + nrm[c] * nz;
  }
  if (tex[4 * 4 + 1] > 0) {             // occlusion
    sample_texture(a.texels, tex + 16, uv[0], uv[1], s);
    occlusion = 1.0f + occ_strength * (s[0] - 1.0f);
  }

  float N[3] = {normal[0], normal[1], normal[2]};
  normalize3(N);
  float V[3], L[3], H[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float hit = P.eye[c] + t * d[c];
    V[c] = P.eye[c] - hit;
    L[c] = P.light[c] - hit;
  }
  normalize3(V);
  normalize3(L);
#pragma unroll
  for (int c = 0; c < 3; ++c) H[c] = V[c] + L[c];
  normalize3(H);
  const float dot_nl = dot3(N, L), dot_nv = dot3(N, V);
  const float dot_nh = clamp_hi(clamp_lo(dot3(N, H), 0.0f), 1.0f);
  const float dot_lh = clamp_hi(clamp_lo(dot3(L, H), 0.0f), 1.0f);
  const float alpha = roughness * roughness;
  const float a2 = alpha * alpha;
  const float f = (dot_nh * a2 - dot_nh) * dot_nh + 1.0f;
  const float D = a2 / (f * f);
  const float lv = clamp_lo(dot_nl, 0.0f) /
                   sqrtf(a2 + (1.0f - a2) * dot_nv * dot_nv);
  const float ll = clamp_lo(dot_nv, 0.0f) /
                   sqrtf(a2 + (1.0f - a2) * dot_nl * dot_nl);
  const float G = 0.5f / (lv + ll + 1e-4f);
  const float schlick = powf(1.0f - dot_lh, 5.0f);
  const bool lit = dot_nv > 0.0f && dot_nl > 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ambient = base[c] * 0.2f * occlusion;
    const float fd = (1.0f - metallic) * base[c] * clamp_lo(dot_nl, 0.0f);
    const float f0 = (0.5f * alpha) * (1.0f - metallic) + base[c] * metallic;
    const float F = f0 + (1.0f - f0) * schlick;
    const float fr = lit ? fabsf(D * G * F / 3.14159265358979f) : 0.0f;
    rgb[c] = ambient + fd + fr + emissive[c];
  }
}

// The surface shade's work, in units of a block: first each busy tile's
// rays, units_tile units a tile (shade_unit), then the frame's pixels,
// FILL_PIXELS a unit (fill_unit).
constexpr int FILL_PIXELS = 4 * THREADS;

// Whether NeRF pixel p (row-major) lies in a busy tile.
__device__ __forceinline__ bool busy_pixel(const ShadeParams& P,
                                           const unsigned char* s_busy,
                                           unsigned p) {
  const unsigned oy = p / (unsigned)P.out_w, ox = p - oy * (unsigned)P.out_w;
  return s_busy[(oy * P.factor / TILE_H) * P.ntx + ox * P.factor / TILE_W];
}

// One unit of a busy tile: a thread a supersampled ray, a pixel's F x F
// rays in G = min(F x F, 32) adjacent lanes, each lane taking F x F / G
// of them in turns. The pixel's first lane adds the terms of its rays in
// a thread-per-pixel loop's order (fy outer, fx inner, from 0, a miss
// skipped), taking each from its lane by shuffle: the sums are that
// loop's bit for bit.
__device__ __forceinline__ void shade_unit(const ShadeParams& P,
                                           const ShadeArgs& a,
                                           const float* nrm_mats, int tile,
                                           int unit) {
  const int F = P.factor, FF = F * F;
  const int G = FF < 32 ? FF : 32;
  const int tw = TILE_W / F, th = TILE_H / F;
  const int q = unit * (THREADS / G) + threadIdx.x / G;   // pixel in tile
  const int j = threadIdx.x & (G - 1);
  const int lane = threadIdx.x & 31, first = lane & ~(G - 1);
  const int ty = tile / P.ntx, tx = tile - ty * P.ntx;
  const int qy = q / tw, qx = q - qy * tw;
  const int oy = ty * th + qy, ox = tx * tw + qx;
  const bool on = q < tw * th && ox < P.out_w && oy < P.out_h;
  const long long tile_base = (long long)tile * TILE_RAYS;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float depth = 0.0f;
  for (int i0 = 0; i0 < FF; i0 += G) {
    const int i = i0 + j, fy = i / F, fx = i - fy * F;
    float c[3] = {0.0f, 0.0f, 0.0f};
    float t = 0.0f;
    bool hit = false;
    if (on) {
      const long long r = tile_base + (qy * F + fy) * TILE_W + qx * F + fx;
      const int id = a.tri[r];
      if (id >= 0) {
        hit = true;
        t = a.t[r];
        const float d[3] = {a.d[3 * r], a.d[3 * r + 1], a.d[3 * r + 2]};
        float rgb[3];
        shade_hit(P, a, nrm_mats, id, a.u[r], a.v[r], t, d, rgb);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          c[k] = linear_to_srgb(clamp_hi(clamp_lo(rgb[k], 0.0f), 1.0f)) *
                 P.inv_ff;
      }
    }
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (hits == 0u) continue;             // (warp-uniform)
    for (int k = 0; k < G; ++k) {
      const float c0 = __shfl_sync(0xffffffffu, c[0], first + k);
      const float c1 = __shfl_sync(0xffffffffu, c[1], first + k);
      const float c2 = __shfl_sync(0xffffffffu, c[2], first + k);
      const float tk = __shfl_sync(0xffffffffu, t, first + k);
      if (hits >> (first + k) & 1u) {
        acc[0] += c0;
        acc[1] += c1;
        acc[2] += c2;
        acc[3] += P.inv_ff;
        depth = nmax(depth, tk);
      }
    }
  }
  if (on && j == 0) {
    const long long p = (long long)oy * P.out_w + ox;
    reinterpret_cast<float4*>(a.rgba)[p] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    a.depth[p] = depth;
  }
}

// One unit of the fill: FILL_PIXELS pixels from p0, those of idle tiles
// written as zeros: a 16-byte store of rgba a pixel (consecutive threads
// on consecutive pixels), then a 16-byte store of four depths a thread.
__device__ __forceinline__ void fill_unit(const ShadeParams& P,
                                          const ShadeArgs& a,
                                          const unsigned char* s_busy,
                                          unsigned p0, unsigned n_out) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned p = p0 + k * THREADS + threadIdx.x;
    if (p < n_out && !busy_pixel(P, s_busy, p))
      reinterpret_cast<float4*>(a.rgba)[p] = zero;
  }
  const unsigned pd = p0 + 4 * threadIdx.x;
  bool idle[4], all = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    idle[k] = pd + k < n_out && !busy_pixel(P, s_busy, pd + k);
    all = all && idle[k];
  }
  if (all) {
    reinterpret_cast<float4*>(a.depth)[pd / 4] = zero;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (idle[k]) a.depth[pd + k] = 0.0f;
  }
}

// Persistent blocks, each walking the units from blockIdx.x by the grid:
// the busy tiles' units first, so their shading starts ahead of the
// fill. Each block lists the busy tiles itself from the counts (a block
// scan into dynamic shared memory: n_tiles ints of list, n_tiles flags).
__global__ void __launch_bounds__(THREADS) surface_shade_kernel(ShadeParams P,
                                                                ShadeArgs a) {
  extern __shared__ int s_list[];
  unsigned char* const s_busy =
      reinterpret_cast<unsigned char*>(s_list + P.n_tiles);
  __shared__ float s_nrm[MAX_INSTANCES * 9];
  __shared__ int s_scan[2 * WARPS + 1];
  if (a.nrm == nullptr) {
    for (int k = threadIdx.x; k < 9 * P.n_inst; k += THREADS) s_nrm[k] = P.nrm[k];
  }
  int n_busy = 0;
  for (int t0 = 0; t0 < P.n_tiles; t0 += THREADS) {
    const int tile = t0 + threadIdx.x;
    const bool busy = tile < P.n_tiles && a.counts[tile] > 0;
    int total;
    const int pos = block_scan(busy, s_scan, total);
    if (tile < P.n_tiles) s_busy[tile] = busy;
    if (busy) s_list[n_busy + pos] = tile;
    n_busy += total;
  }
  __syncthreads();
  const float* nrm_mats = a.nrm != nullptr ? a.nrm : s_nrm;
  const int FF = P.factor * P.factor;
  const int px_unit = THREADS / (FF < 32 ? FF : 32);
  const int units_tile =
      (TILE_RAYS / FF + px_unit - 1) / px_unit;
  const long long n_shade = (long long)n_busy * units_tile;
  const unsigned n_out = (unsigned)P.out_w * (unsigned)P.out_h;
  const long long n_units = n_shade + (n_out + FILL_PIXELS - 1) / FILL_PIXELS;
  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    if (u < n_shade)
      shade_unit(P, a, nrm_mats, s_list[u / units_tile], (int)(u % units_tile));
    else
      fill_unit(P, a, s_busy, (unsigned)(u - n_shade) * FILL_PIXELS, n_out);
  }
}

// ---------------------------------------------------------------------------
// nmr_ray_init
// ---------------------------------------------------------------------------

// _hash_u32 of a uint32 -> [0, 1)
__device__ __forceinline__ float hash01(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return __uint2float_rn(x) * 2.3283064365386963e-10f;   // 2^-32
}

__device__ __forceinline__ int frexp_e(float x) {
  const int field = (__float_as_int(x) >> 23) & 0xff;
  if (field != 0 && field != 0xff) return field - 126;
  int e = 0;
  frexpf(x, &e);
  return e;
}

// occupancy.mip_from_pos
__device__ __forceinline__ int mip_from_pos(const float p[3], int max_cascade) {
  const float m = nmax(nmax(fabsf(p[0] - 0.5f), fabsf(p[1] - 0.5f)),
                       fabsf(p[2] - 0.5f));
  return min(max(frexp_e(m) + 1, 0), max_cascade);
}

__device__ __forceinline__ float calc_dt(float t, const InitParams& P) {
  if (P.cone == 0.0f) return P.dt_min;
  return clamp_hi(clamp_lo(t * P.cone, P.dt_min), P.dt_max);
}

__global__ void __launch_bounds__(THREADS) ray_init_kernel(InitParams P,
                                                           InitArgs a) {
  const long long n = (long long)P.width * P.height;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool on = i < n;
  bool alive = false;
  if (on) {
    float o[3], d[3], t;
    const float t_surf = a.t_surf_in != nullptr ? a.t_surf_in[i] : 0.0f;
    const bool has_surface = t_surf > 0.0f;
    if ((P.stage & STAGE_GIVEN) || !(P.stage & STAGE_RAYS)) {
      // the caller's rays, or those the first stage wrote
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = a.o[3 * i + c];
        d[c] = a.d[3 * i + c];
      }
    } else {
      const int row = (int)(i / P.width), col = (int)(i - (long long)row * P.width);
      const float uu = ((float)col + P.ox) * P.inv_w;
      const float vv = ((float)row + P.oy) * P.inv_h;
      const float dc[3] = {uu * 2.0f - 1.0f, vv * 2.0f - 1.0f, 1.0f};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d[c] = row3(P.cam, 4, c, dc);
        o[c] = P.eye[c];
      }
      const float len = norm3(d);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d[c] = d[c] / len;
        a.o[3 * i + c] = o[c];
        a.d[3 * i + c] = d[c];
      }
    }
    if (P.stage & STAGE_RAYS) {
      if (a.t_surf_in == nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) a.surf[4 * i + c] = 0.0f;
        a.t_surf[i] = 0.0f;
      } else if (a.surf != a.surf_in) {   // the caller's state: a copy
#pragma unroll
        for (int c = 0; c < 4; ++c) a.surf[4 * i + c] = a.surf_in[4 * i + c];
        a.t_surf[i] = t_surf;
      }
      // the render aabb's entry (ray_intersect_aabb), nudged inside
      float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float inv = 1.0f / d[c];
        const float t0 = (a.box_lo[c] - o[c]) * inv;
        const float t1 = (a.box_hi[c] - o[c]) * inv;
        const float lo = nmin(t0, t1), hi = nmax(t0, t1);
        tmin = c == 0 ? lo : nmax(tmin, lo);
        tmax = c == 0 ? hi : nmin(tmax, hi);
      }
      if (tmin > tmax) tmin = F32_MAX;
      t = clamp_lo(tmin, 0.0f) + 1e-6f;
      bool inside = true;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float p = o[c] + d[c] * t;
        inside = inside && p >= a.box_lo[c] && p <= a.box_hi[c];
      }
      alive = inside;
      if (!alive && has_surface) t = t_surf;
      alive = alive || has_surface;
      if (P.jitter) {
        const float j = hash01((uint32_t)i * 786433u + P.seed);
        t = t + j * calc_dt(t, P);
      }
      if (!(P.stage & STAGE_STATE)) {
        a.t_pre[i] = t;
        a.alive_pre[i] = alive;
      }
    } else {
      t = a.t_walk[i];
      alive = a.alive_walk[i] != 0;
    }
    if (P.stage & STAGE_STATE) {
      float p[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) p[c] = o[c] + d[c] * t;
      const float t_start = mip_from_pos(p, P.max_cascade) == 0 ? t : 0.0f;
      if (a.t_floor != nullptr) {
        // the flash floor: start at the coarse first-hit floor; a ray the
        // coarse pass found empty lives on through its surface alone
        const int row = (int)(i / P.width), col = (int)(i - (long long)row * P.width);
        const long long cell = (long long)(row / P.lowres_f) * P.coarse_w +
                               col / P.lowres_f;
        const bool lit = a.alive_img[cell] != 0;
        t = nmax(t, lit ? a.t_floor[cell] : (has_surface ? t_surf : t));
        alive = alive && (lit || has_surface);
      }
      const float surf_alpha = a.t_surf_in != nullptr ? a.surf_in[4 * i + 3] : 0.0f;
      a.t[i] = t;
      a.alive[i] = alive;
      a.t_start[i] = t_start;
#pragma unroll
      for (int c = 0; c < 4; ++c) a.rgba[4 * i + c] = 0.0f;
      a.depth[i] = 0.0f;
      a.max_weight[i] = 0.0f;
      a.wn[i] = 0.0f;
      a.surf_a[i] = alive ? surf_alpha : 0.0f;
    }
  }
  if (!(P.stage & STAGE_STATE) || !P.make_list) return;
  __shared__ int s_scan[2 * WARPS + 1];
  __shared__ int s_base;
  int total;
  const int pos = block_scan(on && alive, s_scan, total);
  if (threadIdx.x == 0) s_base = total > 0 ? atomicAdd(a.n_ids, total) : 0;
  __syncthreads();
  if (on && alive) a.ids[s_base + pos] = (int)i;
}

// ---------------------------------------------------------------------------
// nmr_frame_finalize
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) finalize_kernel(FinalizeParams P,
                                                           FinalizeArgs a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= P.n) return;
  float c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = a.rgba_in[4 * i + k];
  const bool keep = c[3] > P.keep_a;
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = keep ? c[k] : 0.0f;
  a.depth[i] = c[3] > P.depth_a ? a.depth_in[i] : 0.0f;
  if (!P.linear) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = c[k];
      c[k] = x <= P.lin_cut ? x * P.inv_1292
                            : powf(clamp_lo((x + P.add) * P.inv_1055, 0.0f), P.gamma);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) a.rgba[4 * i + k] = c[k];
}

inline unsigned blocks(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each copies its parameters,
// launches one kernel on `stream` (nmr_ray_init, on the list route, zeroes
// the list's count first) and returns cudaGetLastError() (0 on success);
// none synchronises or allocates.
extern "C" int nmr_frame_max_instances() { return MAX_INSTANCES; }

extern "C" int nmr_mesh_plan(const PlanParams* p, const PlanArgs* a,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a multiple of the cluster's blocks: the last cluster's spare blocks
  // project and bin nothing
  const int grid = (p->n_tiles + PLAN_CLUSTER - 1) / PLAN_CLUSTER * PLAN_CLUSTER;
  mesh_plan_kernel<<<grid, THREADS, 0, s>>>(*p, *a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nmr_surface_shade(const ShadeParams* p, const ShadeArgs* a,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 5 * p->n_tiles;
  cudaError_t err = cudaFuncSetAttribute(
      surface_shade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as fit the card at once, no more than units
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, surface_shade_kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int FF = p->factor * p->factor;
  const int px_unit = THREADS / (FF < 32 ? FF : 32);
  const long long units =
      (long long)p->n_tiles * ((TILE_RAYS / FF + px_unit - 1) / px_unit) +
      ((long long)p->out_w * p->out_h + FILL_PIXELS - 1) / FILL_PIXELS;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (grid > units) grid = units;
  surface_shade_kernel<<<(unsigned)grid, THREADS, smem, s>>>(*p, *a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nmr_ray_init(const InitParams* p, const InitArgs* a,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((p->stage & STAGE_STATE) && p->make_list) {
    const cudaError_t err = cudaMemsetAsync(a->n_ids, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ray_init_kernel<<<blocks((long long)p->width * p->height), THREADS, 0, s>>>(
      *p, *a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nmr_frame_finalize(const FinalizeParams* p,
                                  const FinalizeArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  finalize_kernel<<<blocks(p->n), THREADS, 0, s>>>(*p, *a);
  return static_cast<int>(cudaGetLastError());
}
