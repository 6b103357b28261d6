// The NeRF network's inference forward for Hopper: the hash-grid encode,
// the density MLP and the SH + rgb head, three kernels.
//
// None of them replaces a Pallas kernel. The JAX package leaves the
// network to XLA (its Pallas hash encode, ops/hashgrid_pallas.py, was
// deleted in df96e33 because Mosaic cannot gather from VMEM; ops/mlp.py:
// 6-7 points to a fused network kernel that never existed); the port ran
// it as ~400 small aten ops a call (~690 at the reference config). In
// the reference these are tiny-cuda-nn's GridEncoding and FullyFusedMLP.
//
//   hash_encode_kernel (nmr_hash_encode)  ops/network_cuda.py::
//       hash_encode; JAX nerf_glasses_tpu/ops/hashgrid.py:143 hash_encode
//       -> :105 hash_encode_soa -> :59 corner_indices_and_weights.
//       Bound: bytes. Each (sample, level) gathers 8 table rows of F
//       floats from a 4 MiB (native_fast) or 64 MiB (16 x 2^19 x 2) table
//       at hashed, scattered rows, for ~30 + 16F flops. Design: one
//       thread per (sample, level), the level's constants in shared
//       memory, rows loaded as one float2 / float4, the 8 corners summed
//       in registers: the (N, 8, F) intermediate the plain version writes
//       per level is never written. The coarse levels' rows stay in L2.
//   mlp_kernel (nmr_mlp)                   ::mlp; JAX ops/mlp.py:17
//       mlp_apply (the density MLP of ops/network.py:44-71).
//   rgb_head_kernel (nmr_rgb_head)         ::rgb_head; JAX ops/network.py:
//       89 _rgb_head + ops/sh.py:13 sh_encode (rgb_from_features, :111).
//       Bound: at bf16 operands, bytes (a 32-wide input row and a 16-wide
//       output row against 3-7k multiply-adds, under the card's 295
//       flops a byte); at f32, operations outside the tensor cores.
//       Design: one thread per sample, a grid-stride loop over 128-sample
//       tiles; all layers' weights rounded to the compute dtype once per
//       block into shared memory (read straight from the parameters: the
//       trainer updates them in place), each thread's activations in its
//       own shared-memory column (conflict-free), the layer's sums in
//       registers (HID of them) over 16-wide input chunks; the weights
//       are read as float4 broadcasts. The rgb head builds its input row
//       (density output, SH(dir), latent codes, zeros) in registers and
//       runs the same layer loop (mlp_rows, one template for both). No
//       tensor cores in this first version. HID is 64 (141-144 registers,
//       no spills on sm_90a) or 128 (255 registers and ~150 bytes of
//       spills: no configuration of the main path is that wide).
//
// Numerics: the plain versions' rounding points. The build takes
// -fmad=false; the encode spells its roundings out with __fmul_rn /
// __fadd_rn (p = pos * scale + 0.5 two roundings; the weight (w0 w1) w2),
// floor -> int32 -> uint32 as the JAX package casts, the CoherentPrime
// hash and the dense index in uint32 wraparound, `& (size - 1)` for
// power-of-two sizes and `%` otherwise. bf16 rounding is round to
// nearest even (__float2bfloat16_rn): at a bf16 encode each product is
// rounded to bf16 and the f32 sum rounded to bf16; the MLPs round inputs
// and weights to the compute dtype, take products and sums in f32 (fmaf),
// ReLU (NaN kept, as torch.relu), then re-round hidden activations; the
// last layer stays f32. The SH terms repeat the plain version's float32
// operations one by one, Python constants rounded to float32. The
// 8-corner sum and the MLP sums run in another order than aten's: the
// one source of difference (ops/network_cuda.py::compare_with_plain).
// Rows are 64-bit indices in a grid-stride loop: the bake calls on
// millions of points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int MAX_LEVELS = 32;
constexpr int MAX_LAYERS = 8;

// Layout shared with ops/network_cuda.py::EncodeParams.
struct EncodeParams {
  int n_levels;        // L
  int n_features;      // F
  long long rows;      // S: each level's rows in the padded table
  int encode_bf16;     // 1: bf16 products and output; 0: f32
  float scale[MAX_LEVELS];
  unsigned int res[MAX_LEVELS];
  unsigned int size[MAX_LEVELS];
  int dense[MAX_LEVELS];
};

// Layout shared with ops/network_cuda.py::MlpParams.
struct MlpParams {
  int n_layers;                 // weight matrices
  int width[MAX_LAYERS + 1];    // width[0] inputs; width[l + 1] outputs of l
  int w_off[MAX_LAYERS];        // set by the launcher (layout): each
  int w_total;                  // layer's offset in the shared weights,
  int act_rows;                 // their floats, a thread's activation rows
  int round_bf16;               // compute dtype bf16 (else f32)
  int x_bf16;                   // nmr_mlp: the input rows are bf16
  int n_store;                  // output columns written
  int n_feat;                   // rgb head: density-output features
  int sh_degree;                // rgb head: SH degree (1-4)
  int n_extra;                  // rgb head: latent-code dims E
  int extra_rows;               // rgb head: 1: codes (N, E); 0: (E,)
  const float* w[MAX_LAYERS];   // (width[l + 1], width[l]) row-major f32
};

namespace {

constexpr int ENCODE_THREADS = 256;
constexpr int MLP_THREADS = 128;
constexpr int SH_WIDTH = 16;                  // sh_out_padded, degree <= 4

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int F>
__device__ __forceinline__ void load_row(const float* row, float* v) {
  if constexpr (F == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (F == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(row));
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(row + f);
  }
}

// One thread per (sample, level); i = sample * L + level, so a warp's
// output rows are contiguous.
template <int F, bool BF16>
__global__ void __launch_bounds__(ENCODE_THREADS) hash_encode_kernel(
    EncodeParams P, long long n, const float* __restrict__ table,
    const float* __restrict__ pos, void* __restrict__ out) {
  __shared__ float s_scale[MAX_LEVELS];
  __shared__ uint32_t s_res[MAX_LEVELS], s_res2[MAX_LEVELS],
      s_size[MAX_LEVELS];
  __shared__ int s_dense[MAX_LEVELS], s_pow2[MAX_LEVELS];
  const int L = P.n_levels;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    s_scale[l] = P.scale[l];
    s_res[l] = P.res[l];
    s_res2[l] = P.res[l] * P.res[l];          // (res * res) & U32
    s_size[l] = P.size[l];
    s_dense[l] = P.dense[l];
    s_pow2[l] = (P.size[l] & (P.size[l] - 1u)) == 0u;
  }
  __syncthreads();
  const long long total = n * L;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long s = i / L;
    const int l = (int)(i - s * L);
    const float scale = s_scale[l];
    float w[3][2];
    uint32_t c0[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float p = __fadd_rn(__fmul_rn(__ldg(pos + s * 3 + d), scale),
                                0.5f);
      const float g = floorf(p);
      const float frac = __fsub_rn(p, g);
      w[d][0] = __fsub_rn(1.0f, frac);
      w[d][1] = frac;
      c0[d] = (uint32_t)(int)g;               // floor -> int32 -> uint32
    }
    const uint32_t res = s_res[l], res2 = s_res2[l], size = s_size[l];
    const bool dense = s_dense[l], pow2 = s_pow2[l];
    const float* lvl = table + (long long)l * P.rows * F;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
      const float wc = __fmul_rn(__fmul_rn(w[0][bx], w[1][by]), w[2][bz]);
      const uint32_t cx = c0[0] + bx, cy = c0[1] + by, cz = c0[2] + bz;
      uint32_t idx = dense ? cx + cy * res + cz * res2
                           : cx ^ (cy * 2654435761u) ^ (cz * 805459861u);
      idx = pow2 ? idx & (size - 1u) : idx % size;
      float v[F];
      load_row<F>(lvl + (long long)idx * F, v);
      if (BF16) {
        const float wb = bf16r(wc);
#pragma unroll
        for (int f = 0; f < F; ++f)
          acc[f] = __fadd_rn(acc[f], bf16r(__fmul_rn(bf16r(v[f]), wb)));
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f)
          acc[f] = __fadd_rn(acc[f], __fmul_rn(v[f], wc));
      }
    }
    const long long o = i * F;                // (s * L + l) * F
    if (BF16) {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out) + o;
#pragma unroll
      for (int f = 0; f < F; ++f) ob[f] = __float2bfloat16_rn(acc[f]);
    } else {
      float* of = static_cast<float*>(out) + o;
      if constexpr (F == 4) {
        *reinterpret_cast<float4*>(of) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else if constexpr (F == 2) {
        *reinterpret_cast<float2*>(of) = make_float2(acc[0], acc[1]);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) of[f] = acc[f];
      }
    }
  }
}

__device__ __forceinline__ float round_c(float x, bool bf16) {
  return bf16 ? bf16r(x) : x;
}

// torch.relu: NaN stays NaN.
__device__ __forceinline__ float relu(float x) {
  return (x != x || x > 0.0f) ? x : 0.0f;
}

__host__ __device__ __forceinline__ int pad16(int w) { return (w + 15) & ~15; }

// ops/sh.py::sh_encode on one direction warped to [0, 1], the plain
// version's float32 operations in its order; padding features are ONE.
__device__ __forceinline__ void sh_encode(float d0, float d1, float d2,
                                          int degree, float* sh) {
  const float x = __fsub_rn(__fmul_rn(d0, 2.0f), 1.0f);
  const float y = __fsub_rn(__fmul_rn(d1, 2.0f), 1.0f);
  const float z = __fsub_rn(__fmul_rn(d2, 2.0f), 1.0f);
  const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z),
              yz = __fmul_rn(y, z);
  const float x2 = __fmul_rn(x, x), y2 = __fmul_rn(y, y),
              z2 = __fmul_rn(z, z);
#pragma unroll
  for (int k = 0; k < SH_WIDTH; ++k) sh[k] = 1.0f;
  sh[0] = (float)0.28209479177387814;
  if (degree >= 2) {
    const float c1 = (float)0.48860251190291987;
    sh[1] = __fmul_rn(y, -c1);
    sh[2] = __fmul_rn(z, c1);
    sh[3] = __fmul_rn(x, -c1);
  }
  if (degree >= 3) {
    const float c4 = (float)1.0925484305920792;
    sh[4] = __fmul_rn(xy, c4);
    sh[5] = __fmul_rn(yz, -c4);
    sh[6] = __fsub_rn(__fmul_rn(z2, (float)0.94617469575755997),
                      (float)0.31539156525251999);
    sh[7] = __fmul_rn(xz, -c4);
    const float c8 = (float)0.54627421529603959;
    sh[8] = __fsub_rn(__fmul_rn(x2, c8), __fmul_rn(y2, c8));
  }
  if (degree >= 4) {
    const float c9 = (float)0.59004358992664352;
    const float c11 = (float)0.45704579946446572;
    const float one_5z2 = __fsub_rn(1.0f, __fmul_rn(z2, 5.0f));
    sh[9] = __fmul_rn(__fmul_rn(y, c9),
                      __fadd_rn(__fmul_rn(x2, -3.0f), y2));
    sh[10] = __fmul_rn(__fmul_rn(xy, (float)2.8906114426405538), z);
    sh[11] = __fmul_rn(__fmul_rn(y, c11), one_5z2);
    sh[12] = __fmul_rn(__fmul_rn(z, (float)0.3731763325901154),
                       __fsub_rn(__fmul_rn(z2, 5.0f), 3.0f));
    sh[13] = __fmul_rn(__fmul_rn(x, c11), one_5z2);
    sh[14] = __fmul_rn(__fmul_rn(z, (float)1.4453057213202769),
                       __fsub_rn(x2, y2));
    sh[15] = __fmul_rn(__fmul_rn(x, c9),
                       __fadd_rn(-x2, __fmul_rn(y2, 3.0f)));
  }
}

// The body of both MLP kernels, one thread per sample. KIND 0: the rows
// of x are the input (f32 or bf16); KIND 1: the rgb head's row [feat,
// SH(dir), codes, zeros].
// Shared memory: the weights, layer l as width[l + 1] rows of
// pad16(width[l]) (zero-padded), then act_rows x blockDim.x activations
// (thread t's value i at i * blockDim.x + t).
template <int HID, int KIND>
__device__ __forceinline__ void mlp_rows(
    const MlpParams& P, long long n, const void* __restrict__ x,
    const float* __restrict__ dirs, const float* __restrict__ extra,
    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  const bool bf = P.round_bf16;
  for (int l = 0; l < P.n_layers; ++l) {
    const int n_in = P.width[l], in_pad = pad16(n_in);
    const int cnt = P.width[l + 1] * in_pad;
    const float* W = P.w[l];
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int j = e / in_pad, i = e - j * in_pad;
      s_w[P.w_off[l] + e] =
          i < n_in ? round_c(__ldg(W + (long long)j * n_in + i), bf) : 0.0f;
    }
  }
  __syncthreads();
  const int T = blockDim.x;
  float* a = s_w + P.w_total + threadIdx.x;
  const long long stride = (long long)gridDim.x * T;
  for (long long s = (long long)blockIdx.x * T + threadIdx.x; s < n;
       s += stride) {
    // the input row
    int w0 = 0;
    if (KIND == 0) {
      const int n_in = P.width[0];
      if (P.x_bf16) {
        const __nv_bfloat16* xr =
            static_cast<const __nv_bfloat16*>(x) + s * n_in;
        for (int i = 0; i < n_in; ++i)
          a[i * T] = round_c(__bfloat162float(xr[i]), bf);
      } else {
        const float* xr = static_cast<const float*>(x) + s * n_in;
        for (int i = 0; i < n_in; ++i) a[i * T] = round_c(__ldg(xr + i), bf);
      }
      w0 = n_in;
    } else {
      const float* fr = static_cast<const float*>(x) + s * P.n_feat;
      for (int i = 0; i < P.n_feat; ++i) a[i * T] = round_c(__ldg(fr + i), bf);
      w0 = P.n_feat;
      float sh[SH_WIDTH];
      sh_encode(__ldg(dirs + s * 3), __ldg(dirs + s * 3 + 1),
                __ldg(dirs + s * 3 + 2), P.sh_degree, sh);
#pragma unroll
      for (int k = 0; k < SH_WIDTH; ++k) a[(w0 + k) * T] = round_c(sh[k], bf);
      w0 += SH_WIDTH;
      const float* er = extra + (P.extra_rows ? s * P.n_extra : 0);
      for (int e = 0; e < P.n_extra; ++e)
        a[(w0 + e) * T] = round_c(__ldg(er + e), bf);
      w0 += P.n_extra;
    }
    for (int i = w0; i < pad16(P.width[0]); ++i) a[i * T] = 0.0f;

    for (int l = 0; l < P.n_layers; ++l) {
      const int in_pad = pad16(P.width[l]);
      const int n_out = P.width[l + 1];
      const float* W = s_w + P.w_off[l];
      float acc[HID];
#pragma unroll
      for (int j = 0; j < HID; ++j) acc[j] = 0.0f;
      for (int c = 0; c < in_pad; c += 16) {
        float xin[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) xin[k] = a[(c + k) * T];
#pragma unroll
        for (int j = 0; j < HID; ++j) {
          if (j < n_out) {
            const float4* wr =
                reinterpret_cast<const float4*>(W + j * in_pad + c);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 w4 = wr[q];
              acc[j] = fmaf(xin[4 * q], w4.x, acc[j]);
              acc[j] = fmaf(xin[4 * q + 1], w4.y, acc[j]);
              acc[j] = fmaf(xin[4 * q + 2], w4.z, acc[j]);
              acc[j] = fmaf(xin[4 * q + 3], w4.w, acc[j]);
            }
          }
        }
      }
      if (l + 1 < P.n_layers) {
#pragma unroll
        for (int j = 0; j < HID; ++j)
          if (j < n_out) a[j * T] = round_c(relu(acc[j]), bf);
        for (int j = n_out; j < pad16(n_out); ++j) a[j * T] = 0.0f;
      } else {
        float* orow = out + s * P.n_store;
#pragma unroll
        for (int j = 0; j < HID; ++j)
          if (j < P.n_store) orow[j] = acc[j];
      }
    }
  }
}

template <int HID>
__global__ void __launch_bounds__(MLP_THREADS) mlp_kernel(
    MlpParams P, long long n, const void* __restrict__ x,
    const float* __restrict__ dirs, const float* __restrict__ extra,
    float* __restrict__ out) {
  mlp_rows<HID, 0>(P, n, x, dirs, extra, out);
}

template <int HID>
__global__ void __launch_bounds__(MLP_THREADS) rgb_head_kernel(
    MlpParams P, long long n, const void* __restrict__ x,
    const float* __restrict__ dirs, const float* __restrict__ extra,
    float* __restrict__ out) {
  mlp_rows<HID, 1>(P, n, x, dirs, extra, out);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int F, bool BF16>
int launch_encode(const EncodeParams& P, long long n, const float* table,
                  const float* pos, void* out, cudaStream_t s) {
  const long long total = n * P.n_levels;
  long long blocks = (total + ENCODE_THREADS - 1) / ENCODE_THREADS;
  const long long cap = 32LL * sm_count();
  if (blocks > cap) blocks = cap;
  hash_encode_kernel<F, BF16><<<(int)blocks, ENCODE_THREADS, 0, s>>>(
      P, n, table, pos, out);
  return static_cast<int>(cudaGetLastError());
}

template <int HID, int KIND>
int launch_mlp(const MlpParams& P, long long n, const void* x,
               const float* dirs, const float* extra, float* out,
               cudaStream_t s) {
  auto kernel = KIND == 0 ? mlp_kernel<HID> : rgb_head_kernel<HID>;
  const size_t smem =
      sizeof(float) * ((size_t)P.w_total + (size_t)P.act_rows * MLP_THREADS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      MLP_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = (n + MLP_THREADS - 1) / MLP_THREADS;
  const long long cap = (long long)per_sm * sm_count();
  if (blocks > cap) blocks = cap;
  kernel<<<(int)blocks, MLP_THREADS, smem, s>>>(P, n, x, dirs, extra, out);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_mlp_width(const MlpParams& P, long long n, const void* x,
                     const float* dirs, const float* extra, float* out,
                     cudaStream_t s) {
  int widest = P.n_store;
  for (int l = 1; l <= P.n_layers; ++l)
    if (P.width[l] > widest) widest = P.width[l];
  if (widest <= 64) return launch_mlp<64, KIND>(P, n, x, dirs, extra, out, s);
  if (widest <= 128) return launch_mlp<128, KIND>(P, n, x, dirs, extra, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared-memory layout of P's layers (w_off, w_total, act_rows);
// false for widths the kernels do not take.
bool layout(MlpParams& P) {
  if (P.n_layers < 1 || P.n_layers > MAX_LAYERS) return false;
  int off = 0, rows = 0;
  for (int l = 0; l < P.n_layers; ++l) {
    if (P.width[l] < 1 || P.width[l + 1] < 1) return false;
    P.w_off[l] = off;
    off += P.width[l + 1] * pad16(P.width[l]);
    if (pad16(P.width[l]) > rows) rows = pad16(P.width[l]);
  }
  P.w_total = off;
  P.act_rows = rows;
  return P.n_store >= 1 && P.n_store <= P.width[P.n_layers];
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each copies the parameters,
// launches on the given stream, and returns cudaGetLastError() (0 on
// success, cudaErrorInvalidValue for shapes the kernels do not take).

extern "C" int nmr_hash_encode(const EncodeParams* p, long long n,
                               const float* table, const float* pos,
                               void* out, void* stream) {
  const EncodeParams P = *p;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.n_levels < 1 || P.n_levels > MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
#define NMR_ENCODE(F)                                                        \
  return P.encode_bf16 ? launch_encode<F, true>(P, n, table, pos, out, s)    \
                       : launch_encode<F, false>(P, n, table, pos, out, s)
  switch (P.n_features) {
    case 1: NMR_ENCODE(1);
    case 2: NMR_ENCODE(2);
    case 4: NMR_ENCODE(4);
    case 8: NMR_ENCODE(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NMR_ENCODE
}

extern "C" int nmr_mlp(const MlpParams* p, long long n, const void* x,
                       float* out, void* stream) {
  MlpParams P = *p;
  if (!layout(P)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mlp_width<0>(P, n, x, nullptr, nullptr, out,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int nmr_rgb_head(const MlpParams* p, long long n,
                            const float* feat, const float* dirs,
                            const float* extra, float* out, void* stream) {
  MlpParams P = *p;
  if (!layout(P) || P.sh_degree < 1 || P.sh_degree > 4 ||
      P.n_feat + SH_WIDTH + P.n_extra > P.width[0])
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mlp_width<1>(P, n, feat, dirs, extra, out,
                             static_cast<cudaStream_t>(stream));
}
