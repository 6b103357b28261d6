// Mesh ray-casts (Moller-Trumbore, back faces culled) for Hopper: two
// kernels that share one intersection routine.
//
// raycast_tiled_kernel (nmr_raycast_tiled) replaces
// nerf_glasses_tpu/ops/mesh_pallas.py::raycast_pallas_tiled (kernel
// _tiled_kernel). Rays arrive grouped by screen tile (tile_rays
// consecutive rays per tile); each tile carries a front-packed list of
// candidate triangle ids (ops/triangles.py::_bin_triangles) and a count.
// For each ray the kernel finds the nearest hit among its tile's
// candidates only:
//   det > 1e-9 (back faces culled), u >= -1e-5, v >= -1e-5,
//   u + v <= 1 + 1e-5, 1e-4 < t < best,
// walking the list in order with a strict `<`, so the earliest candidate
// wins a tie. A miss gives t = 1e16, id -1, u = v = 0.
//
// What bounds it: arithmetic, about 50 flops per ray x candidate, with
// one 36-byte triangle read per candidate per block and 16 bytes of
// output per ray. The design keeps the triangle reads off the critical
// path: one thread per ray, one block per (256-ray slice, tile); the
// block stages its tile's candidates into shared memory in batches of
// BATCH (ids, then 9 floats each, 20 KB), and every thread then reads
// the same triangle at the same time (a shared-memory broadcast), so the
// inner loop is register arithmetic only. The loop runs to the tile's own
// count: tiles the mesh does not touch cost one load of their count.
//
// raycast_kernel (nmr_raycast) replaces mesh_pallas.py::raycast_pallas
// (kernel _kernel): every ray against all n_tris triangles, ids implicit.
// Same design without lists: the block stages triangles [0, n_tris) in
// batches of BATCH (18 KB) and every thread walks them in ascending id
// order. Its cost grows as rays x triangles (about 12e9 tests for a
// 2560x1440 pass against 3,280 triangles); it needs no padding, so any
// ray count is taken.
//
// Numerics: built with -fmad=false (see ops/mesh_cuda.py), so every
// product is rounded before it is added, exactly as the separate tensor
// operations of the plain versions (raycast_tiled_reference,
// raycast_reference) round it, and the operation order below is theirs
// and the TPU kernels'. Division is IEEE (no fast math). The kernel and the plain
// version therefore agree bit for bit on the card: ids exactly, and t,
// u, v to 0 (the smoke check holds t to 1e-6 absolute).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BATCH = 512;
constexpr float BIG = 1e16f;

// One ray against one triangle s = [v0 | e1 | e2]: true on a front-facing
// hit with u, v >= -1e-5, u + v <= 1 + 1e-5 and t > 1e-4 (the caller adds
// the running t < best test). Operation order as in the plain version.
__device__ __forceinline__ bool intersect(const float* s, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& t, float& u,
                                          float& v) {
  const float v0x = s[0], v0y = s[1], v0z = s[2];
  const float e1x = s[3], e1y = s[4], e1z = s[5];
  const float e2x = s[6], e2y = s[7], e2z = s[8];
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool valid = det > 1e-9f;
  const float inv = 1.0f / (valid ? det : 1.0f);
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return valid && u >= -1e-5f && v >= -1e-5f && u + v <= 1.00001f &&
         t > 1e-4f;
}

__global__ void __launch_bounds__(THREADS)
raycast_tiled_kernel(const float* __restrict__ tri,
                     const float* __restrict__ o,
                     const float* __restrict__ d,
                     const int* __restrict__ lists,
                     const int* __restrict__ counts,
                     int list_len, int tile_rays,
                     float* __restrict__ t_out, int* __restrict__ idx_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float s_tri[BATCH * 9];
  __shared__ int s_id[BATCH];

  const int tile = blockIdx.y;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const bool active = r < tile_rays;
  const long long ray = (long long)tile * tile_rays + r;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (active) {
    ox = o[ray * 3 + 0]; oy = o[ray * 3 + 1]; oz = o[ray * 3 + 2];
    dx = d[ray * 3 + 0]; dy = d[ray * 3 + 1]; dz = d[ray * 3 + 2];
  }
  float best_t = BIG, best_u = 0.f, best_v = 0.f;
  int best_i = -1;

  const int count = counts[tile];
  const int* list = lists + (long long)tile * list_len;
  for (int base = 0; base < count; base += BATCH) {
    const int nb = min(BATCH, count - base);
    __syncthreads();  // the previous batch is no longer read
    for (int k = threadIdx.x; k < nb; k += THREADS) s_id[k] = list[base + k];
    __syncthreads();
    for (int k = threadIdx.x; k < nb * 9; k += THREADS) {
      const int j = k / 9;
      s_tri[k] = tri[(long long)s_id[j] * 9 + (k - j * 9)];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nb; ++j) {
      float t, u, v;
      if (intersect(s_tri + j * 9, ox, oy, oz, dx, dy, dz, t, u, v) &&
          t < best_t) {
        best_t = t; best_i = s_id[j]; best_u = u; best_v = v;
      }
    }
  }
  if (active) {
    t_out[ray] = best_t;
    idx_out[ray] = best_i;
    u_out[ray] = best_u;
    v_out[ray] = best_v;
  }
}

__global__ void __launch_bounds__(THREADS)
raycast_kernel(const float* __restrict__ tri, const float* __restrict__ o,
               const float* __restrict__ d, int n_tris, long long n_rays,
               float* __restrict__ t_out, int* __restrict__ idx_out,
               float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float s_tri[BATCH * 9];

  const long long ray = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool active = ray < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (active) {
    ox = o[ray * 3 + 0]; oy = o[ray * 3 + 1]; oz = o[ray * 3 + 2];
    dx = d[ray * 3 + 0]; dy = d[ray * 3 + 1]; dz = d[ray * 3 + 2];
  }
  float best_t = BIG, best_u = 0.f, best_v = 0.f;
  int best_i = -1;

  for (int base = 0; base < n_tris; base += BATCH) {
    const int nb = min(BATCH, n_tris - base);
    __syncthreads();  // the previous batch is no longer read
    for (int k = threadIdx.x; k < nb * 9; k += THREADS)
      s_tri[k] = tri[(long long)base * 9 + k];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nb; ++j) {
      float t, u, v;
      if (intersect(s_tri + j * 9, ox, oy, oz, dx, dy, dz, t, u, v) &&
          t < best_t) {
        best_t = t; best_i = base + j; best_u = u; best_v = v;
      }
    }
  }
  if (active) {
    t_out[ray] = best_t;
    idx_out[ray] = best_i;
    u_out[ray] = best_u;
    v_out[ray] = best_v;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); it does not
// synchronise and allocates nothing.
extern "C" int nmr_raycast_tiled(const float* tri, const float* o,
                                 const float* d, const int* lists,
                                 const int* counts, int list_len,
                                 int n_tiles, int tile_rays, float* t,
                                 int* idx, float* u, float* v,
                                 void* stream) {
  if (n_tiles == 0 || tile_rays == 0) return 0;
  const dim3 grid((tile_rays + THREADS - 1) / THREADS, n_tiles);
  raycast_tiled_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      tri, o, d, lists, counts, list_len, tile_rays, t, idx, u, v);
  return (int)cudaGetLastError();
}

extern "C" int nmr_raycast(const float* tri, const float* o, const float* d,
                           int n_tris, long long n_rays, float* t, int* idx,
                           float* u, float* v, void* stream) {
  if (n_rays == 0) return 0;
  const long long blocks = (n_rays + THREADS - 1) / THREADS;
  raycast_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      tri, o, d, n_tris, n_rays, t, idx, u, v);
  return (int)cudaGetLastError();
}
