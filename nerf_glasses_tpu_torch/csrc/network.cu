// The NeRF network's inference forward for Hopper: the hash-grid encode,
// the density MLP and the SH + rgb head.
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
//       at hashed, scattered rows, for ~30 + 16F flops. The gathers'
//       loads through L1, not device memory, set its time (PERF.md
//       section 6; tools/port_cost_split.py encode). Design: a block a
//       tile of up to 64 samples x L levels; the tile's positions once
//       into shared memory; a warp 32
//       consecutive samples on one level (samples along a ray share rows
//       at the coarse levels: fewer L2 sectors a warp's load than a warp
//       of (sample, level) items), index arithmetic 32-bit; a lane's 8
//       corner indices first, then its 8 rows loaded as one float2 /
//       float4 each before the first add, summed in registers (the (N, 8,
//       F) intermediate the plain version writes per level is never
//       written); its F features into the tile's rows in shared memory,
//       which go out whole, contiguous, in 16-byte stores (from
//       registers, a lane's 16 bytes at a row's stride, they took half
//       as long again). Small tiles leave L1 the room its hits need.
//   nmr_mlp                                ::mlp; JAX ops/mlp.py:17
//       mlp_apply (the density MLP of ops/network.py:44-71).
//   nmr_rgb_head                           ::rgb_head; JAX ops/network.py:
//       89 _rgb_head + ops/sh.py:13 sh_encode (rgb_from_features, :111).
//   encode_mlp_kernel (nmr_encode_mlp)     ::encode_mlp; JAX ops/network.py:
//       62 density_raw -> :44 density_raw_soa (hash_encode_soa, then
//       mlp_apply): the encode and the density MLP at the bf16 compute
//       dtype in one launch, every bf16 no-grad density call of the port.
//       Bound: bytes, the positions and the table rows they touch read
//       once and the (N, 16) f32 output written once; the (N, L F)
//       encode, 128 bytes a sample that nmr_hash_encode writes and nmr_mlp
//       reads back, never leaves the SM. It runs at about a tenth of that
//       bound; the cause is open (the gathers' L2 request rate, or their
//       latency at 20 warps an SM: PERF.md section 7). Design: mlp_tc
//       with the encode as its A build (KIND 2): the tile's 64 positions
//       come through the cp.async ring, each thread takes one row and
//       levels t >> 6, + 2, ... (a warp is 32 consecutive samples on one
//       level, so samples along a ray share rows at the coarse levels),
//       sums its 8 corners in the standalone kernel's order and stores
//       the bf16 row into the kmajor A tile; then nmr_mlp's wgmma chain.
//       Chosen on an H100 over a warp-specialised form (producer
//       warpgroups filling a ring of A tiles for a consumer warpgroup,
//       mbarriers, setmaxnreg) and over loading x-neighbours as one
//       aligned pair: both were slower (PERF.md section 6).
//       Its output is nmr_hash_encode's then nmr_mlp's, bit for bit: the
//       same corner sums, the same bf16 A tile, the same wgmma chain.
//
// The two MLP kernels at the bf16 compute dtype: mlp_kernel_bf16 and
// rgb_head_kernel_bf16, one body (mlp_tc). The rgb head's is the main
// path's; no path of the port launches mlp_kernel_bf16 since the fused
// kernel serves every bf16 density call: it stays as nmr_mlp's bf16 body,
// the fused kernel's bit-for-bit reference (the cuda tests, chip_smoke.py).
//   Bound: bytes. The density MLP reads a 128-byte f32 encode row (64 at
//   a bf16 encode) and writes 64 bytes for 3k multiply-adds; the rgb
//   head reads 76 bytes and writes 12 for 7k (9k with 8 latent dims). To
//   stream those bytes at 3.35 TB/s the MLP has to run at ~107 TFLOP/s
//   and the head at ~550: above the CUDA cores' 67 TFLOP/s f32 peak, well
//   under the tensor cores' 989 bf16. So every layer is a wgmma.
//   Design: persistent blocks of one warpgroup (128 threads), at most
//   TC_BLOCKS_PER_SM (4) a multiprocessor, each walking 64-row tiles
//   (wgmma's M): a block's tile is a chain of dependent steps (ring wait,
//   A build, one wgmma group a layer), so four blocks keep the SM busy
//   where one or two leave it waiting (PERF.md section 6). Each
//   block rounds every layer's weights to bf16 once, from the live
//   parameters (the trainer updates them in place while the viewer
//   renders: nothing is cached between launches), into shared memory in
//   the layout wgmma reads B from: K-major, no swizzle, 8 x 16-byte core
//   matrices, each one contiguous 128-byte line that wgmma reads without
//   bank conflicts (kmajor below). Input rows come through a TC_STAGES-deep
//   ring filled by cp.async, the next tiles' loads in flight while this
//   tile computes. The first layer's A is the tile rounded to bf16 into
//   shared memory (the rgb head builds its row there: [feat, SH(dir)
//   from the plain version's float32 operations, codes, zeros]); each
//   later layer's A is the previous accumulator after ReLU (NaN kept)
//   rounded to bf16 and packed in registers: wgmma's accumulator layout
//   is its register A layout, as FlashAttention-3 reuses P for P.V. No
//   activation leaves the SM. The last layer runs in 16-column blocks
//   (the rgb head computes only the 16 holding rgb) and is written in
//   f32. Tails of fewer than 64 rows are zero rows, masked at the store;
//   rows and tiles are 64-bit (the bake calls on millions of points).
//   Hidden widths up to 64 or 128 are the two instances (zero-padded; 90
//   and 138 registers, no spills). The bound is not reached: the A build
//   and the three dependent wgmma groups of the rgb head's tile leave the
//   memory idle between tiles (PERF.md section 6).
//   The tensor cores sum each k16 chunk at their own internal precision
//   and in their own order: rows may differ from aten's f32 product of
//   the rounded operands by a bf16 step of a hidden activation
//   (ops/network_cuda.py::compare_with_plain's bf16 contract).
// At the f32 compute dtype (the parity runs; the f32 frame) both MLPs run
// on the CUDA cores in f32 fmaf: TF32 or bf16 operands would break that
// dtype's 1e-4 contract. Bound: operations (the density MLP's 3k
// multiply-adds a sample against 192 bytes, the rgb head's 6.3k stored
// ones against 88: 67 TFLOP/s f32 peak). Both are one register-tiled
// body (mlp_tiles; mlp_kernel its KIND 0, rgb_head_kernel its KIND 1):
// persistent blocks of 256 threads, 2 an SM at HID 64, each an even
// share of the samples in 256-sample tiles (128 at HID 128), the
// activations in shared memory k-major with the samples contiguous; a
// thread computes 4 samples x 16 outputs of a hidden layer, a 16-byte
// load of activations and four of weights a k for 64 fmaf, and writes
// them back over the layer's input after a barrier. The last layer: where
// every one of its columns is stored and its 4 x 4 items are no more than
// the threads (the density MLP's 16: all 256 busy; up to 32 at HID 128)
// the same way, each sample's 4 columns one 16-byte store; else only the
// stored columns (3 of the rgb head's 16), a sample and two a thread. The weights and the next tile's inputs arrive by cp.async
// while a tile computes: the density MLP's rows of x (128 bytes at f32,
// 64 at bf16) in 16-byte pieces, row-major at an odd number of them (36
// floats for 32), widened from bf16 in the row build; the rgb head's
// features and directions in 4-byte pieces. Each output is an fmaf chain
// over k = 0 .. K-1 from 0, the order of a thread-per-sample loop (the
// first design's): the rows are its rows bit for bit. The head reaches
// about half of its operations bound (PERF.md section 6 rows 8-9).
// The launcher picks the body by compute dtype; each raises what it does
// not take.
//
// Numerics: the plain versions' rounding points. The build takes
// -fmad=false; the encode spells its roundings out with __fmul_rn /
// __fadd_rn (p = pos * scale + 0.5 two roundings; the weight (w0 w1) w2),
// floor -> int32 -> uint32 as the JAX package casts, the CoherentPrime
// hash and the dense index in uint32 wraparound, `& (size - 1)` for
// power-of-two sizes and `%` otherwise. bf16 rounding is round to
// nearest even (__float2bfloat16_rn): at a bf16 encode each product is
// rounded to bf16 and the f32 sum rounded to bf16; the MLPs round inputs
// and weights to the compute dtype, take products and sums in f32,
// ReLU (NaN kept, as torch.relu), then re-round hidden activations; the
// last layer stays f32. The SH terms repeat the plain version's float32
// operations one by one, Python constants rounded to float32. The
// 8-corner sum and the MLP sums run in another order than aten's: the
// one source of difference (ops/network_cuda.py::compare_with_plain).

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

// An encode's level constants in shared memory.
struct Levels {
  float scale[MAX_LEVELS];
  uint32_t res[MAX_LEVELS], res2[MAX_LEVELS], size[MAX_LEVELS];
  int dense[MAX_LEVELS], pow2[MAX_LEVELS];
};

// P's levels into S by the block's threads (seen after a __syncthreads).
// The rows a launch serves: n, the launch's bound, or where the caller
// gives a row count in device memory (another kernel's, read when the
// kernel starts) the rows below it. The grid depends on the bound alone,
// so a captured launch serves whatever count the replay finds.
__device__ __forceinline__ long long live_rows(long long n,
                                               const int* count) {
  return count ? min(n, (long long)max(*count, 0)) : n;
}

__device__ __forceinline__ void load_levels(const EncodeParams& P,
                                            Levels& S) {
  for (int l = threadIdx.x; l < P.n_levels; l += blockDim.x) {
    S.scale[l] = P.scale[l];
    S.res[l] = P.res[l];
    S.res2[l] = P.res[l] * P.res[l];          // (res * res) & U32
    S.size[l] = P.size[l];
    S.dense[l] = P.dense[l];
    S.pow2[l] = (P.size[l] & (P.size[l] - 1u)) == 0u;
  }
}

// The index code of every encode kernel, forward and backward: position
// (x, y, z) on level l -> the rows idx[c] of its 8 corners (bit d of c
// selects dimension d) and each dimension's weight factors w[d][bit], as
// hashgrid.corner_indices_and_weights makes them.
__device__ __forceinline__ void corner_rows(const Levels& S, int l, float x,
                                            float y, float z, float w[3][2],
                                            uint32_t idx[8]) {
  const float scale = S.scale[l];
  const float p3[3] = {x, y, z};
  uint32_t c0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float p = __fadd_rn(__fmul_rn(p3[d], scale), 0.5f);
    const float g = floorf(p);
    const float frac = __fsub_rn(p, g);
    w[d][0] = __fsub_rn(1.0f, frac);
    w[d][1] = frac;
    c0[d] = (uint32_t)(int)g;                 // floor -> int32 -> uint32
  }
  const uint32_t res = S.res[l], res2 = S.res2[l], size = S.size[l];
  // the level's kind as branches, not selects: where a warp's lanes share
  // the level (every kernel's map) one path runs, and no modulo where the
  // size is a power of two
  if (S.dense[l]) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      idx[c] = c0[0] + (c & 1) + (c0[1] + ((c >> 1) & 1)) * res +
               (c0[2] + (c >> 2)) * res2;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      idx[c] = (c0[0] + (c & 1)) ^ ((c0[1] + ((c >> 1) & 1)) * 2654435761u) ^
               ((c0[2] + (c >> 2)) * 805459861u);
  }
  if (S.pow2[l]) {
#pragma unroll
    for (int c = 0; c < 8; ++c) idx[c] &= size - 1u;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) idx[c] %= size;
  }
}

// One (sample, level) of the encode, the corner routine of both forward
// encode kernels: position (x, y, z) on level l of the table `lvl` -> acc,
// the F features in f32 (the output rounds them), summed c = 0..7 in the
// plain version's order and rounding. The 8 corner rows are loaded before
// the first add, so that their loads are in flight together.
template <int F, bool BF16>
__device__ __forceinline__ void encode_point(const Levels& S, int l,
                                             const float* __restrict__ lvl,
                                             float x, float y, float z,
                                             float* acc) {
  float w[3][2];
  uint32_t idx[8];
  corner_rows(S, l, x, y, z, w, idx);
  float v[8][F];
#pragma unroll
  for (int c = 0; c < 8; ++c) load_row<F>(lvl + (long long)idx[c] * F, v[c]);
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
    const float wc = __fmul_rn(__fmul_rn(w[0][bx], w[1][by]), w[2][bz]);
    if (BF16) {
      const float wb = bf16r(wc);
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[f] = __fadd_rn(acc[f], bf16r(__fmul_rn(bf16r(v[c][f]), wb)));
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[f] = __fadd_rn(acc[f], __fmul_rn(v[c][f], wc));
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// F features at dst in the output dtype (f32, or bf16 rounded to nearest
// even), one store of 4F or 2F bytes (two 16-byte stores for 8 f32); also
// the fused kernel's bf16 A-tile row (dst in kmajor).
template <int F, bool BF16>
__device__ __forceinline__ void store_features(unsigned char* dst,
                                               const float* acc) {
  if constexpr (BF16 && F == 1) {
    *reinterpret_cast<unsigned short*>(dst) = (unsigned short)bf16_bits(acc[0]);
  } else if constexpr (BF16) {
    uint32_t w[F / 2];
#pragma unroll
    for (int q = 0; q < F / 2; ++q)
      w[q] = bf16_bits(acc[2 * q]) | bf16_bits(acc[2 * q + 1]) << 16;
    if constexpr (F == 2) *reinterpret_cast<uint32_t*>(dst) = w[0];
    if constexpr (F == 4) *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    if constexpr (F == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (F == 1) {
    *reinterpret_cast<float*>(dst) = acc[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
  } else {
#pragma unroll
    for (int q = 0; q < F; q += 4)
      reinterpret_cast<float4*>(dst)[q / 4] =
          make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
  }
}

// The standalone encode's tiles: at most ENCODE_TILE samples (a multiple
// of 32), their output rows at most ENCODE_TILE_BYTES of shared memory
// (64 beat 32, 128 and 256 on an H100, PERF.md section 6: the rest of the
// SM's 256 KB is L1, which the gathers hit).
constexpr int ENCODE_TILE = 64;
constexpr int ENCODE_TILE_BYTES = 24576;

// An output row of `row` bytes in the tile: a row that is a whole number
// of 16-byte pieces takes one piece more where its count of them is even,
// so that 8 lanes' 16-byte accesses to 8 rows fall in distinct banks;
// other rows lie contiguous.
int encode_stride(int row) {
  return row % 16 ? row : row + (row / 16 % 2 ? 0 : 16);
}

// The tile's samples for rows `stride` bytes apart: 64 or 32.
int encode_tile(int stride) {
  int t = ENCODE_TILE;
  while (t > 32 && t * stride > ENCODE_TILE_BYTES) t /= 2;
  return t;
}

// A block a tile of `tile` samples (the last one short) x L levels. The
// tile's positions go once into shared memory; warp w takes items w, w +
// 8, ...: item it is level it >> gshift and the 32 consecutive samples of
// group it & (tile / 32 - 1), a lane a sample (samples along a ray share
// rows at the coarse levels). Each lane's F features go into the tile's
// row of its sample (`stride` bytes, encode_stride); then the block
// writes the tile's rows, contiguous in `out`, in 16-byte stores (the
// bytes past the last whole piece of an unpadded tile in 2-byte stores).
// Index arithmetic within the tile is 32-bit. A block takes tiles
// blockIdx.x, + gridDim.x, ...: one each where the grid covers the rows,
// several where a row count in device memory caps the grid (launch_encode).
template <int F, bool BF16>
__global__ void __launch_bounds__(ENCODE_THREADS) hash_encode_kernel(
    EncodeParams P, long long n, int tile, int gshift, int stride,
    const float* __restrict__ table, const float* __restrict__ pos,
    void* __restrict__ out, const int* __restrict__ count) {
  n = live_rows(n, count);
  if ((long long)blockIdx.x * tile >= n) return;     // uniform: the block
  __shared__ Levels S;
  extern __shared__ float4 smem4[];
  float* const s_pos = reinterpret_cast<float*>(smem4);
  unsigned char* const s_out =
      reinterpret_cast<unsigned char*>(smem4) + ((tile * 12 + 15) & ~15);
  load_levels(P, S);
  const int L = P.n_levels;
  const int row = L * F * (BF16 ? 2 : 4);
  const int lane = threadIdx.x & 31;
  for (long long s0 = (long long)blockIdx.x * tile; s0 < n;
       s0 += (long long)gridDim.x * tile) {
    const int rows = (int)min((long long)tile, n - s0);
    const float* p = pos + s0 * 3;
    for (int e = threadIdx.x; e < rows * 3; e += ENCODE_THREADS)
      s_pos[e] = __ldg(p + e);
    __syncthreads();
    for (int it = threadIdx.x >> 5; it < L << gshift;
         it += ENCODE_THREADS / 32) {
      const int l = it >> gshift;
      const int r = ((it & ((1 << gshift) - 1)) << 5) + lane;
      if (r < rows) {
        float acc[F];
        encode_point<F, BF16>(S, l, table + (long long)l * P.rows * F,
                              s_pos[3 * r], s_pos[3 * r + 1],
                              s_pos[3 * r + 2], acc);
        store_features<F, BF16>(s_out + r * stride + l * F * (BF16 ? 2 : 4),
                                acc);
      }
    }
    __syncthreads();
    unsigned char* const o = static_cast<unsigned char*>(out) + s0 * row;
    const int bytes = rows * row;
    for (int b = 16 * threadIdx.x; b < (bytes & ~15); b += 16 * ENCODE_THREADS)
      *reinterpret_cast<uint4*>(o + b) = *reinterpret_cast<const uint4*>(
          s_out + (stride == row ? b : b / row * stride + b % row));
    for (int b = (bytes & ~15) + 2 * threadIdx.x; b < bytes;
         b += 2 * ENCODE_THREADS)
      *reinterpret_cast<unsigned short*>(o + b) =
          *reinterpret_cast<const unsigned short*>(s_out + b);
    __syncthreads();          // the tile's shared memory is free again
  }
}

// F floats added to the f32 row at `row` with atomic adds: on Hopper one
// vector atomic for F = 2 and 4 (rows 8 and 16 bytes aligned), each
// element added on its own as a float atomic would add it.
template <int F>
__device__ __forceinline__ void atomic_add_row(float* row, const float* v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 ||                       \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(row), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(row), make_float2(v[0], v[1]));
  } else
#endif
  {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(row + f, v[f]);
  }
}

// The encode's backward (ops/network_cuda.py::hash_encode_backward, the
// backward of HashEncode; plain version hash_encode_backward_reference,
// the autograd of hashgrid.hash_encode: its row gathers' gradient an
// index_add_ into the table): for each (sample, level) the 8 corner rows
// and weights again (corner_rows), and w_c * g added into the level's
// rows of grad_table with atomic adds; at the bf16 encode dtype g is the
// bf16 gradient of the bf16 output and each w_c * g is rounded to bf16
// before the f32 add (the plain version's bf16 product's gradient is a
// bf16 product). With POS also the positions' gradient, summed over the
// levels in their order without atomics: the tile's (sample, level)
// terms wait in shared memory. A level's term is d(weights)/d(frac)
// (weights = (w_x w_y) w_z, w = frac or 1 - frac a dimension) times the
// weights' gradient, sum_f g_f v_cf over the corner rows v (the bf16
// rounding points of the plain version's product and sum where BF16),
// times the level's scale.
//
// What bounds it: the atomic adds, 8 rows of F floats a (sample, level)
// (with POS also the forward's 8 row loads), at the rows' addresses, the
// coarse levels' rows shared by many samples of a step. Measured on the
// settled training step (PERF.md section 6, tools/port_cost_split.py
// backward): the adds take ~0.24 of its ~0.29 ms where plain 16-byte
// stores to the same rows took 0.048 and the index and weight work
// 0.006; float-by-float atomics took 1.23 ms, so F = 4 rows take one
// 16-byte vector atomic each (F = 2 one 8-byte). A block is a tile of 64
// samples x L levels and a warp 32 consecutive (sample, level) items,
// the L levels of a few samples: a warp of 32 samples on one level (the
// forward's map) sent the whole grid's adds for a coarse level, a few
// hundred rows, to the same L2 slices at once, and took 0.29 ms to this
// map's 0.20.
template <int F, bool BF16, bool POS>
__global__ void __launch_bounds__(ENCODE_THREADS) hash_encode_backward_kernel(
    EncodeParams P, long long n, const float* __restrict__ table,
    const float* __restrict__ pos, const void* __restrict__ grad,
    float* __restrict__ grad_table, float* __restrict__ grad_pos) {
  __shared__ Levels S;
  extern __shared__ float4 smem4[];
  float* const s_pos = reinterpret_cast<float*>(smem4);
  float* const s_gp = s_pos + ENCODE_TILE * 3;   // POS: (tile, L, 3)
  load_levels(P, S);
  const int L = P.n_levels;
  const long long s0 = (long long)blockIdx.x * ENCODE_TILE;
  const int rows = (int)min((long long)ENCODE_TILE, n - s0);
  const float* p = pos + s0 * 3;
  for (int e = threadIdx.x; e < rows * 3; e += ENCODE_THREADS)
    s_pos[e] = __ldg(p + e);
  __syncthreads();
  constexpr int GROUPS = ENCODE_TILE / 32;
  const int lane = threadIdx.x & 31;
  for (int it = threadIdx.x >> 5; it < L * GROUPS;
       it += ENCODE_THREADS / 32) {
    const int l = (it * 32 + lane) % L;
    const int r = (it * 32 + lane) / L;
    if (r >= rows) continue;
    float w[3][2];
    uint32_t idx[8];
    corner_rows(S, l, s_pos[3 * r], s_pos[3 * r + 1], s_pos[3 * r + 2], w,
                idx);
    const long long go = (s0 + r) * (long long)(L * F) + l * F;
    float g[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      g[f] = BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(grad)[go + f])
                  : static_cast<const float*>(grad)[go + f];
    float* const lvl = grad_table + (long long)l * P.rows * F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
      const float wc = __fmul_rn(__fmul_rn(w[0][bx], w[1][by]), w[2][bz]);
      const float wb = BF16 ? bf16r(wc) : wc;
      float v[F];
#pragma unroll
      for (int f = 0; f < F; ++f)
        v[f] = BF16 ? bf16r(__fmul_rn(g[f], wb)) : __fmul_rn(g[f], wb);
      atomic_add_row<F>(lvl + (long long)idx[c] * F, v);
    }
    if (POS) {
      const float* const tab = table + (long long)l * P.rows * F;
      float v[8][F];
#pragma unroll
      for (int c = 0; c < 8; ++c) load_row<F>(tab + (long long)idx[c] * F, v[c]);
      float gf[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int b[3] = {c & 1, (c >> 1) & 1, (c >> 2) & 1};
        float gw = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f)
          gw = __fadd_rn(gw, BF16 ? bf16r(__fmul_rn(g[f], bf16r(v[c][f])))
                                  : __fmul_rn(g[f], v[c][f]));
        if (BF16) gw = bf16r(gw);
        // weights = a w_z, a = w_x w_y
        const float a = __fmul_rn(w[0][b[0]], w[1][b[1]]);
        const float ga = __fmul_rn(gw, w[2][b[2]]);
        const float gd[3] = {__fmul_rn(ga, w[1][b[1]]),
                             __fmul_rn(ga, w[0][b[0]]), __fmul_rn(gw, a)};
#pragma unroll
        for (int d = 0; d < 3; ++d)
          gf[d] = __fadd_rn(gf[d], b[d] ? gd[d] : -gd[d]);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s_gp[(r * L + l) * 3 + d] = __fmul_rn(gf[d], S.scale[l]);
    }
  }
  if (POS) {
    __syncthreads();
    for (int e = threadIdx.x; e < rows * 3; e += ENCODE_THREADS) {
      const int r = e / 3, d = e % 3;
      float acc = 0.0f;
      for (int l = 0; l < L; ++l) acc = __fadd_rn(acc, s_gp[(r * L + l) * 3 + d]);
      grad_pos[s0 * 3 + e] = acc;
    }
  }
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The rgb head's input row of sample s into a[i * stride], i <
// pad16(width[0]): its features fr[0 .. n_feat), SH(d0, d1, d2), its
// codes, zeros.
__device__ __forceinline__ void rgb_row(const MlpParams& P, long long s,
                                        const float* fr, float d0, float d1,
                                        float d2,
                                        const float* __restrict__ extra,
                                        float* a, int stride) {
  for (int i = 0; i < P.n_feat; ++i) a[i * stride] = fr[i];
  int w0 = P.n_feat;
  float sh[SH_WIDTH];
  sh_encode(d0, d1, d2, P.sh_degree, sh);
#pragma unroll
  for (int k = 0; k < SH_WIDTH; ++k) a[(w0 + k) * stride] = sh[k];
  w0 += SH_WIDTH;
  const float* er = extra + (P.extra_rows ? s * P.n_extra : 0);
  for (int e = 0; e < P.n_extra; ++e) a[(w0 + e) * stride] = __ldg(er + e);
  w0 += P.n_extra;
  for (int i = w0; i < pad16(P.width[0]); ++i) a[i * stride] = 0.0f;
}

// ---------------------------------------------------------------------------
// The register-tiled f32 body (mlp_kernel, rgb_head_kernel)
// ---------------------------------------------------------------------------

constexpr int RT_THREADS = 256;
constexpr int RT_BLOCKS_PER_SM = 2;   // at HID 64 (registers allow 2)
constexpr int RT_R = 4;           // a hidden layer: a thread's samples ...
constexpr int RT_C = 16;          // ... times its outputs
constexpr int RT_LANE_TS = 8;     // a warp's sample groups (of 32 lanes)
constexpr int RT_LAST_C = 2;      // the last layer, some columns stored: a
                                  // thread's outputs of one sample
constexpr int RT_LAST_TC = 4;     // the last layer, every column stored: a
                                  // thread's outputs of its RT_R samples

// A block's tile of samples at hidden width HID: a hidden layer's
// RT_R x RT_C items are then one a thread (at 128, 256 samples' 128
// activation rows would not leave room for the weights).
__host__ __device__ constexpr int rt_samples(int hid) {
  return hid <= 64 ? 256 : 128;
}

// mlp_kernel's last layer is register-tiled where it stores every one of
// its pad16 columns (the density MLP: 16 of 16) and its items, one a
// thread, fit the block (RT_R samples x RT_LAST_TC columns: 16 columns at
// HID 64, 32 at 128); else, as the rgb head's always (3 of 16), only the
// stored columns are computed, a sample a thread (rt_last).
__host__ __device__ __forceinline__ bool rt_last_tiled(const MlpParams& P,
                                                       int hid) {
  return P.n_store == pad16(P.width[P.n_layers]) &&
         rt_samples(hid) / RT_R * (P.n_store / RT_LAST_TC) <= RT_THREADS;
}

// Layer l's weight columns in the register-tiled body: pad16 of a hidden
// layer's outputs (the next layer's K); the last layer's stored columns,
// rounded up to RT_LAST_C where it is not tiled. Its weights lie k-major
// (k * cols + j) after those of the layers before it.
__host__ __device__ __forceinline__ int rt_cols(const MlpParams& P, int l,
                                                bool tiled) {
  return l + 1 < P.n_layers ? pad16(P.width[l + 1])
         : tiled            ? P.n_store
                            : (P.n_store + RT_LAST_C - 1) / RT_LAST_C * RT_LAST_C;
}

// A layer on a tile of S samples: sums[j][s] = sum_k act[k][s] W[k][j],
// each an fmaf chain over k = 0 .. K-1 from 0 for the tile's first
// `valid` samples. A thread computes an item of RT_R samples x C columns:
// for each k one 16-byte load of its activations and C / 4 of its weights
// for RT_R C fmaf. A warp holds RT_LANE_TS sample groups x (32 /
// RT_LANE_TS) column groups; each load is broadcast to the lanes that
// share it. A hidden layer (LAST false) keeps its sums in registers across
// the barrier after the last read of its input, then overwrites it with
// relu(sums) (NaN kept), the columns from n_out to N as zeros. The last
// layer writes its sums to `out` (rows of N floats from the tile's first
// sample), a 16-byte store for every 4 columns of a sample.
template <int S, int C, bool LAST>
__device__ __forceinline__ void rt_layer(const float* __restrict__ W, int K,
                                         int N, int n_out, int valid,
                                         float* act, float* __restrict__ out) {
  const int groups = N / C;
  const int it = threadIdx.x;             // S / RT_R * groups <= RT_THREADS
  const int tj = it / RT_LANE_TS % groups;
  const int ts = it % RT_LANE_TS + RT_LANE_TS * (it / RT_LANE_TS / groups);
  const bool mine = it < S / RT_R * groups && ts * RT_R < valid;
  float acc[RT_R][C];
#pragma unroll
  for (int r = 0; r < RT_R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
  if (mine) {
    const float* a = act + ts * RT_R;
    const float* w = W + tj * C;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      float xv[RT_R], wv[C];
#pragma unroll
      for (int q = 0; q < RT_R; q += 4)
        *reinterpret_cast<float4*>(xv + q) =
            *reinterpret_cast<const float4*>(a + k * S + q);
#pragma unroll
      for (int q = 0; q < C; q += 4)
        *reinterpret_cast<float4*>(wv + q) =
            *reinterpret_cast<const float4*>(w + k * N + q);
#pragma unroll
      for (int r = 0; r < RT_R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[r][c] = fmaf(xv[r], wv[c], acc[r][c]);
    }
  }
  if (LAST) {
    if (!mine) return;
#pragma unroll
    for (int r = 0; r < RT_R; ++r)
      if (ts * RT_R + r < valid) {
        float* o = out + (long long)(ts * RT_R + r) * N + tj * C;
#pragma unroll
        for (int q = 0; q < C; q += 4)
          *reinterpret_cast<float4*>(o + q) = make_float4(
              acc[r][q], acc[r][q + 1], acc[r][q + 2], acc[r][q + 3]);
      }
    return;
  }
  __syncthreads();                        // every read of the input done
  if (!mine) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool live = tj * C + c < n_out;
#pragma unroll
    for (int q = 0; q < RT_R; q += 4)
      *reinterpret_cast<float4*>(act + (tj * C + c) * S + ts * RT_R + q) =
          make_float4(live ? relu(acc[q][c]) : 0.0f,
                      live ? relu(acc[q + 1][c]) : 0.0f,
                      live ? relu(acc[q + 2][c]) : 0.0f,
                      live ? relu(acc[q + 3][c]) : 0.0f);
  }
}

// The last layer on a tile of S samples where only some columns are
// stored: a thread a sample and RT_LAST_C columns, only those that are
// stored; rows = the tile's samples.
template <int S>
__device__ __forceinline__ void rt_last(const float* __restrict__ W, int K,
                                        int N, int n_store,
                                        const float* __restrict__ in,
                                        float* __restrict__ out, int rows) {
  for (int it = threadIdx.x; it < S * (N / RT_LAST_C); it += RT_THREADS) {
    const int s = it % S, j0 = it / S * RT_LAST_C;
    if (s >= rows) continue;
    float acc[RT_LAST_C];
#pragma unroll
    for (int c = 0; c < RT_LAST_C; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x = in[k * S + s];
      const float2 w2 = *reinterpret_cast<const float2*>(W + k * N + j0);
      acc[0] = fmaf(x, w2.x, acc[0]);
      acc[1] = fmaf(x, w2.y, acc[1]);
    }
#pragma unroll
    for (int c = 0; c < RT_LAST_C; ++c)
      if (j0 + c < n_store) out[(long long)s * n_store + j0 + c] = acc[c];
  }
}

// A staged input row of `row` bytes (mlp_kernel's rows of x) lies at a
// stride of a whole number of 16-byte pieces, odd, so that the row
// build's 16-byte reads, a thread a row, fall in distinct banks for each
// quarter-warp: 128-byte f32 rows at 144 (36 floats), 64-byte bf16 rows
// at 80.
__host__ __device__ __forceinline__ int rt_row_stride(int row) {
  const int pieces = (row + 15) / 16;
  return 16 * (pieces % 2 ? pieces : pieces + 1);
}

// The staging area's bytes for a tile of S samples: KIND 0 S rows of x at
// rt_row_stride; KIND 1 the rgb head's features (n_feat + 1 floats a
// sample) and directions (3).
__host__ __device__ __forceinline__ int rt_stage_bytes(const MlpParams& P,
                                                       int kind, int S) {
  return kind == 0
             ? S * rt_row_stride(P.width[0] * (P.x_bf16 ? 2 : 4))
             : 4 * S * (P.n_feat + 4);
}

// The inputs of the `valid` samples from s0 into the staging area by
// cp.async (one commit group). KIND 0: the rows of x, row-major at
// rt_row_stride, in 16-byte pieces where the rows and x allow, else 4-
// or (bf16 rows of an odd width) 2-byte pieces, the last by plain loads,
// seen after the next __syncthreads. KIND 1: the rgb head's features at a
// row stride of n_feat + 1 floats (the row build's reads a thread a row
// then fall in distinct banks), then the directions, 3 a sample, at
// stage_d.
template <int KIND, int S>
__device__ __forceinline__ void rt_stage(const MlpParams& P,
                                         const void* __restrict__ x,
                                         const float* __restrict__ dirs,
                                         long long s0, int valid,
                                         unsigned char* stage,
                                         float* stage_d) {
  if (KIND == 0) {
    const int row = P.width[0] * (P.x_bf16 ? 2 : 4);
    const int stride = rt_row_stride(row);
    const unsigned char* src = static_cast<const unsigned char*>(x) + s0 * row;
    const uintptr_t al = reinterpret_cast<uintptr_t>(x) | row;
    const int piece = al % 16 == 0 ? 16 : al % 4 == 0 ? 4 : 2;
    const int per = row / piece;
    for (int e = threadIdx.x; e < valid * per; e += RT_THREADS) {
      const int s = e / per, o = (e - s * per) * piece;
      if (piece == 16)
        cp_async16(stage + s * stride + o, src + s * row + o);
      else if (piece == 4)
        cp_async4(stage + s * stride + o, src + s * row + o);
      else
        *reinterpret_cast<unsigned short*>(stage + s * stride + o) =
            *reinterpret_cast<const unsigned short*>(src + s * row + o);
    }
  } else {
    const int nf = P.n_feat;
    float* const sf = reinterpret_cast<float*>(stage);
    const float* f = static_cast<const float*>(x) + s0 * nf;
    for (int e = threadIdx.x; e < valid * nf; e += RT_THREADS) {
      const int s = e / nf;
      cp_async4(sf + s * (nf + 1) + (e - s * nf), f + e);
    }
    for (int e = threadIdx.x; e < valid * 3; e += RT_THREADS)
      cp_async4(stage_d + e, dirs + s0 * 3 + e);
  }
  cp_async_commit();
}

// Staged row t of x (KIND 0) into a[i * S], i < pad16(width[0]): 16 bytes
// a read, bf16 widened to f32, zeros past width[0].
template <int S>
__device__ __forceinline__ void staged_row(const MlpParams& P,
                                           const unsigned char* stage, int t,
                                           float* a) {
  const int n_in = P.width[0];
  const unsigned char* sr =
      stage + t * rt_row_stride(n_in * (P.x_bf16 ? 2 : 4));
  if (P.x_bf16) {
    for (int i = 0; i < pad16(n_in); i += 8) {
      const uint4 q = i < n_in ? *reinterpret_cast<const uint4*>(sr + 2 * i)
                               : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[(i + u) * S] = i + u < n_in
                             ? __uint_as_float(u % 2 ? w[u / 2] & 0xFFFF0000u
                                                     : w[u / 2] << 16)
                             : 0.0f;
    }
  } else {
    for (int i = 0; i < pad16(n_in); i += 4) {
      const float4 q = i < n_in ? *reinterpret_cast<const float4*>(sr + 4 * i)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) a[(i + u) * S] = i + u < n_in ? v[u] : 0.0f;
    }
  }
}

// The register-tiled f32 body: persistent blocks, each an even share of
// the samples in tiles of S = rt_samples(HID). The block's weights go
// once into shared memory by cp.async, k-major and zero-padded
// (rt_cols); then one activation buffer of pad16 rows x S, k-major with
// the samples contiguous, then the staging area, which cp.async fills with
// the next tile's inputs while a tile computes (rt_stage). A tile's input
// rows go into the activations (a thread a sample; KIND 0 the rows of x,
// KIND 1 the rgb head's rows); each hidden layer overwrites them with its
// outputs (rt_layer, two barriers a layer: one buffer, where two would
// leave room for fewer blocks an SM); the last layer writes the stored
// columns to `out` (rt_layer's last form where it stores them all, else
// rt_last). Each output is the same fmaf chain over k = 0 .. K-1 from 0 as
// a thread-per-sample loop's. Layer l's K, columns and weight offset are
// counted up as l runs (a struct indexed by l would go to local memory).
template <int KIND, int HID>
__device__ __forceinline__ void mlp_tiles(
    const MlpParams& P, long long n, const void* __restrict__ x,
    const float* __restrict__ dirs, const float* __restrict__ extra,
    float* __restrict__ out, const int* __restrict__ count) {
  constexpr int S = rt_samples(HID);
  // the block's samples: an even share, in tiles (a short last tile does
  // its share of the work, so the blocks end together); a block with no
  // share stages nothing
  n = live_rows(n, count);
  const long long s_begin = n * blockIdx.x / gridDim.x;
  const long long s_end = n * (blockIdx.x + 1) / gridDim.x;
  if (s_begin >= s_end) return;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  const bool tiled = KIND == 0 && rt_last_tiled(P, HID);
  int off = 0, rows = 0;
  for (int l = 0; l < P.n_layers; ++l) {
    const int n_in = P.width[l], n_out = P.width[l + 1];
    const int K = pad16(n_in), N = rt_cols(P, l, tiled);
    const float* W = P.w[l];
    for (int e = threadIdx.x; e < K * N; e += RT_THREADS) {
      const int k = e / N, j = e - k * N;
      if (k < n_in && j < n_out)
        cp_async4(s_w + off + e, W + (long long)j * n_in + k);
      else
        s_w[off + e] = 0.0f;
    }
    off += K * N;
    rows = max(rows, K);
  }
  cp_async_commit();      // the weights, in flight with the first inputs
  float* const act = s_w + off;             // off: a multiple of 16 floats
  float* const stage_f = act + rows * S;    // KIND 1: S x (n_feat + 1)
  float* const stage_d = stage_f + S * (P.n_feat + 1);   // and S x 3
  unsigned char* const stage = reinterpret_cast<unsigned char*>(stage_f);
  rt_stage<KIND, S>(P, x, dirs, s_begin,
                    (int)min((long long)S, s_end - s_begin), stage, stage_d);
  for (long long s0 = s_begin; s0 < s_end; s0 += S) {
    const int valid = (int)min((long long)S, s_end - s0);
    cp_async_wait<0>();
    __syncthreads();      // the staged inputs (the first tile: the weights)
    for (int t = threadIdx.x; t < S; t += RT_THREADS) {
      float* a = act + t;
      if (t >= valid)
        for (int i = 0; i < pad16(P.width[0]); ++i) a[i * S] = 0.0f;
      else if (KIND == 1)
        rgb_row(P, s0 + t, stage_f + t * (P.n_feat + 1), stage_d[3 * t],
                stage_d[3 * t + 1], stage_d[3 * t + 2], extra, a, S);
      else
        staged_row<S>(P, stage, t, a);
    }
    __syncthreads();
    if (s0 + S < s_end)
      rt_stage<KIND, S>(P, x, dirs, s0 + S,
                        (int)min((long long)S, s_end - s0 - S), stage, stage_d);
    int w_off = 0;
    for (int l = 0; l < P.n_layers; ++l) {
      const int K = pad16(P.width[l]), N = rt_cols(P, l, tiled);
      if (l + 1 < P.n_layers)
        rt_layer<S, RT_C, false>(s_w + w_off, K, N, P.width[l + 1], valid,
                                 act, nullptr);
      else if (tiled)
        rt_layer<S, RT_LAST_TC, true>(s_w + w_off, K, N, N, valid, act,
                                      out + s0 * N);
      else
        rt_last<S>(s_w + w_off, K, N, P.n_store, act, out + s0 * P.n_store,
                   valid);
      w_off += K * N;
      __syncthreads();
    }
  }
}

// HID: 64 or 128, the widest layer: the tile (rt_samples) and the
// registers a thread may take (RT_BLOCKS_PER_SM blocks an SM at 64, one
// at 128, where the weights and activations take most of shared memory).
template <int HID>
__global__ void __launch_bounds__(RT_THREADS, HID <= 64 ? RT_BLOCKS_PER_SM : 1)
    mlp_kernel(MlpParams P, long long n, const void* __restrict__ x,
               float* __restrict__ out, const int* __restrict__ count) {
  mlp_tiles<0, HID>(P, n, x, nullptr, nullptr, out, count);
}

template <int HID>
__global__ void __launch_bounds__(RT_THREADS, HID <= 64 ? RT_BLOCKS_PER_SM : 1)
    rgb_head_kernel(MlpParams P, long long n, const float* __restrict__ feat,
                    const float* __restrict__ dirs,
                    const float* __restrict__ extra, float* __restrict__ out,
                    const int* __restrict__ count) {
  mlp_tiles<1, HID>(P, n, feat, dirs, extra, out, count);
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 compute dtype)
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 64;           // a tile: wgmma's M
constexpr int TC_THREADS = 128;       // one warpgroup a block
constexpr int TC_STAGES = 3;          // the input ring's depth
constexpr int TC_BLOCKS_PER_SM = 4;   // 4 beat 1 and 2 and equal 8 (H100)
constexpr int SH_STRIDE = SH_WIDTH + 4;   // an f32 SH row in shared memory:
                                          // 16-byte rows, no bank conflict

// nmr_encode_mlp's blocks a multiprocessor (and its registers, through
// __launch_bounds__, at HID 64): 5 beat 4 at NGPConfig() widths and tie
// at native_fast (H100; PERF.md section 6).
constexpr int ENCODE_MLP_BLOCKS_PER_SM = 5;

// The shared-memory plan of one launch, in bytes (tc_plan).
struct TcPlan {
  int k[MAX_LAYERS];      // layer l's K, zero-padded to 16
  int rows[MAX_LAYERS];   // its weight rows kept (wgmma's N, zero-padded)
  int w_off[MAX_LAYERS];  // its bf16 weights in the kmajor layout
  int codes_off;          // rgb head: codes given once, (E,) f32
  int a0_off;             // the tile's first-layer A, TC_ROWS x k[0] bf16
  int ring_off, stage;    // the ring: TC_STAGES stages of `stage` bytes
  int seg[3], seg_row[3]; // in a stage: x (feat, or the fused kernel's
                          // positions) | dirs | code rows, and their bytes
                          // a row (0: no such segment)
  int sh_off;             // in a stage: the rows' SH, f32, SH_STRIDE
  int smem;
};

// wgmma's K-major layout without swizzle: 8 rows x 16 bytes (8 bf16) make
// a core matrix, stored contiguously (row r at 16 r); a row block's core
// matrices follow each other along K 128 bytes apart (the leading byte
// offset), the row blocks K / 8 x 128 bytes apart (the stride byte
// offset). -> the byte offset of element (r, k) of an R x K matrix.
__device__ __forceinline__ int kmajor(int r, int k, int K) {
  return (((r >> 3) * (K >> 3) + (k >> 3)) << 7) + ((r & 7) << 4) +
         ((k & 7) << 1);
}

// The matrix descriptor of a kmajor matrix of K columns at p: the address,
// leading byte offset 128 and stride byte offset 16 K, each in 16-byte
// units; layout type 0 (no swizzle). Advance it by 16 a k16 step and by
// 2 K a block of 16 rows.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, int K) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)K << 32);
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void keep(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64 f32, 32 a thread) (+)= A (kmajor in shared memory) . B^T.
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A in registers (4 x bf16x2 a thread).
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 16 columns (8 a thread), A in shared memory.
__device__ __forceinline__ void mma_ss_n16(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// 16 columns, A in registers.
__device__ __forceinline__ void mma_rs_n16(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint2 pack_bf16x4(const float* v) {
  return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// A hidden layer's accumulator (N = 16 KS columns) -> the next layer's A:
// ReLU, bf16, packed. Thread (warp w, lane g * 4 + t) holds, per 8-column
// block j, (row 16 w + g, columns 8 j + 2 t, + 1) in d[4 j], d[4 j + 1]
// and row + 8 in d[4 j + 2], d[4 j + 3]; A's k16 step kk wants (row,
// 16 kk + 2 t, + 1), (row + 8, same), (row, + 8), (row + 8, + 8): blocks
// 2 kk and 2 kk + 1, in that order.
template <int KS>
__device__ __forceinline__ void to_a(const float* d, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[kk][q] = pack_bf16(relu(d[8 * kk + 2 * q]), relu(d[8 * kk + 2 * q + 1]));
}

// Layer with A in shared memory over nk k16 steps, NB blocks of 64 columns.
template <int NB>
__device__ __forceinline__ void layer_ss(float* d, uint64_t da, uint64_t db,
                                         int nk, int K) {
  keep<32 * NB>(d);
  wgmma_fence();
  for (int kk = 0; kk < nk; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mma_ss_n64(d + 32 * nb, da + 16 * kk, db + 16 * kk + (uint64_t)8 * K * nb,
                 kk > 0);
  wgmma_commit();
  wgmma_wait();
  keep<32 * NB>(d);
}

// Layer with A in registers, KS k16 steps (K = 16 KS), NB blocks of 64.
template <int KS, int NB>
__device__ __forceinline__ void layer_rs(float* d, const uint32_t (*a)[4],
                                         uint64_t db) {
  keep<32 * NB>(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mma_rs_n64(d + 32 * nb, a[kk], db + 16 * kk + (uint64_t)128 * KS * nb,
                 kk > 0);
  wgmma_commit();
  wgmma_wait();
  keep<32 * NB>(d);
}

// One 16-column block of the last layer, A in registers.
template <int KS>
__device__ __forceinline__ void block_rs16(float* d, const uint32_t (*a)[4],
                                           uint64_t db) {
  keep<8>(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs_n16(d, a[kk], db + 16 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait();
  keep<8>(d);
}

// One 16-column block of a single-layer MLP, A in shared memory.
__device__ __forceinline__ void block_ss16(float* d, uint64_t da, uint64_t db,
                                           int nk) {
  keep<8>(d);
  wgmma_fence();
  for (int kk = 0; kk < nk; ++kk)
    mma_ss_n16(d, da + 16 * kk, db + 16 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait();
  keep<8>(d);
}

// Writes a 16-column block (columns c..c + 15 of the tile's rows, this
// thread's 8) as f32, the columns past n_store and the rows past `rows`
// left out.
__device__ __forceinline__ void store_block(const float* d, float* out,
                                            int n_store, long long row0,
                                            int rows, int c) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = c + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      if (rr < rows) {
        float* o = out + (row0 + rr) * n_store + col;
        if (col < n_store) o[0] = d[4 * j + 2 * h];
        if (col + 1 < n_store) o[1] = d[4 * j + 2 * h + 1];
      }
    }
  }
}

// bytes (even) from src to dst (16-byte aligned) as the block's cp.async
// pieces: 16 bytes where src is 16-byte aligned, else 4 where it is
// 4-byte aligned; the rest (a bf16 tail, or a 2-byte aligned src) by
// plain loads, seen after the next __syncthreads.
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const unsigned char* src,
                                          int bytes) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(src);
  int body = 0;
  if ((al & 15) == 0) {
    body = bytes & ~15;
    for (int o = threadIdx.x * 16; o < body; o += TC_THREADS * 16)
      cp_async16(dst + o, src + o);
  } else if ((al & 3) == 0) {
    body = bytes & ~3;
    for (int o = threadIdx.x * 4; o < body; o += TC_THREADS * 4)
      cp_async4(dst + o, src + o);
  }
  for (int o = body + 2 * threadIdx.x; o < bytes; o += 2 * TC_THREADS)
    *reinterpret_cast<uint16_t*>(dst + o) =
        *reinterpret_cast<const uint16_t*>(src + o);
}

// Tile `tile`'s input rows into ring stage st (not committed).
template <int KIND>
__device__ __forceinline__ void load_tile(const MlpParams& P, const TcPlan& Q,
                                          long long n, long long tile,
                                          const void* x, const float* dirs,
                                          const float* extra,
                                          unsigned char* st) {
  const long long row0 = tile * TC_ROWS;
  const int rows = (int)min((long long)TC_ROWS, n - row0);
  const void* src[3] = {x, dirs, extra};
#pragma unroll
  for (int i = 0; i < (KIND == 1 ? 3 : 1); ++i)
    if (Q.seg_row[i] > 0)
      copy_rows(st + Q.seg[i],
                static_cast<const unsigned char*>(src[i]) + row0 * Q.seg_row[i],
                rows * Q.seg_row[i]);
}

// Every layer's weights rounded to bf16 into its kmajor block, zero-padded
// to rows[l] x k[l]; four columns a thread-step (a float4 where the rows
// allow it).
__device__ __forceinline__ void stage_weights(const MlpParams& P,
                                              const TcPlan& Q,
                                              unsigned char* smem) {
  for (int l = 0; l < P.n_layers; ++l) {
    const int n_in = P.width[l], n_out = P.width[l + 1], K = Q.k[l];
    const int q = K >> 2, cnt = Q.rows[l] * q;
    const float* W = P.w[l];
    const bool vec =
        (n_in & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
    unsigned char* ws = smem + Q.w_off[l];
#pragma unroll 4
    for (int e = threadIdx.x; e < cnt; e += TC_THREADS) {
      const int j = e / q, i = (e - j * q) << 2;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < n_out) {
        const float* wr = W + (long long)j * n_in + i;
        if (vec) {
          if (i < n_in) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(wr));
            v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
          }
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i + u < n_in) v[u] = __ldg(wr + u);
        }
      }
      *reinterpret_cast<uint2*>(ws + kmajor(j, i, K)) = pack_bf16x4(v);
    }
  }
}

// The tile's first-layer A (TC_ROWS x k[0], kmajor, bf16) from ring stage
// st: the input rows (KIND 0), or [feat, SH(dir), codes, zeros] (KIND 1,
// after the SH pass); rows past `rows` are zeros. Four columns a
// thread-step, read along the rows.
template <int KIND>
__device__ __forceinline__ void build_a(const MlpParams& P, const TcPlan& Q,
                                        unsigned char* smem,
                                        const unsigned char* st, int rows) {
  const int K0 = Q.k[0], q = K0 >> 2;
  unsigned char* a = smem + Q.a0_off;
  for (int e = threadIdx.x; e < TC_ROWS * q; e += TC_THREADS) {
    const int r = e / q, k = (e - r * q) << 2;
    uint2 packed = make_uint2(0u, 0u);
    if (r < rows) {
      if (KIND == 0) {
        const int n_in = P.width[0];
        if (P.x_bf16) {
          const __nv_bfloat16* xr =
              reinterpret_cast<const __nv_bfloat16*>(st + Q.seg[0]) + r * n_in;
          if ((n_in & 3) == 0) {
            if (k < n_in) packed = *reinterpret_cast<const uint2*>(xr + k);
          } else {
            float v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              v[u] = k + u < n_in ? __bfloat162float(xr[k + u]) : 0.0f;
            packed = pack_bf16x4(v);
          }
        } else {
          const float* xr =
              reinterpret_cast<const float*>(st + Q.seg[0]) + r * n_in;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if ((n_in & 3) == 0) {
            if (k < n_in) {
              const float4 t = *reinterpret_cast<const float4*>(xr + k);
              v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (k + u < n_in) v[u] = xr[k + u];
          }
          packed = pack_bf16x4(v);
        }
      } else {
        const int nf = P.n_feat, ne = P.n_extra;
        const float* fr = reinterpret_cast<const float*>(st + Q.seg[0]) + r * nf;
        const float* sr =
            reinterpret_cast<const float*>(st + Q.sh_off) + r * SH_STRIDE;
        const float* cr =
            P.extra_rows
                ? reinterpret_cast<const float*>(st + Q.seg[2]) + r * ne
                : reinterpret_cast<const float*>(smem + Q.codes_off);
        float v[4];
        if (((nf | ne) & 3) == 0) {   // the chunk lies in one part, aligned
          const float* src = k < nf                  ? fr + k
                             : k < nf + SH_WIDTH      ? sr + (k - nf)
                             : k < nf + SH_WIDTH + ne ? cr + (k - nf - SH_WIDTH)
                                                      : nullptr;
          const float4 t = src ? *reinterpret_cast<const float4*>(src)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = k + u;
            v[u] = c < nf                  ? fr[c]
                   : c < nf + SH_WIDTH      ? sr[c - nf]
                   : c < nf + SH_WIDTH + ne ? cr[c - nf - SH_WIDTH]
                                            : 0.0f;
          }
        }
        packed = pack_bf16x4(v);
      }
    }
    *reinterpret_cast<uint2*>(a + kmajor(r, k, K0)) = packed;
  }
}

// What the fused kernel's encode reads: the table (L, rows, F) f32, its
// level constants in shared memory, and the encode dtype.
struct EncodeSrc {
  const float* table;
  const Levels* lv;
  int n_levels;
  long long rows;
  bool bf16;
};

// A tile's first-layer A from the encode (nmr_encode_mlp): thread t
// takes row t & 63 of the tile, at (x, y, z), and levels t >> 6, + 2,
// ..., so a warp is 32 consecutive rows on one level (samples along a ray
// share rows at the coarse levels); level l's F features go to columns
// l F.. of the row, rounded to bf16 as the density MLP rounds its input
// rows (the same value whether the f32 or the bf16 encode rounds the
// sum); rows that are not `live` get zeros. Columns past L F stay as they
// are (zeroed once a launch).
template <int F>
__device__ __forceinline__ void encode_a(const EncodeSrc& E, unsigned char* a,
                                         int K0, int t, bool live, float x,
                                         float y, float z) {
  const int r = t & 63;
  for (int l = t >> 6; l < E.n_levels; l += TC_THREADS / 64) {
    float acc[F];
    if (!live) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    } else {
      const float* lvl = E.table + (long long)l * E.rows * F;
      if (E.bf16)
        encode_point<F, true>(*E.lv, l, lvl, x, y, z, acc);
      else
        encode_point<F, false>(*E.lv, l, lvl, x, y, z, acc);
    }
    store_features<F, true>(a + kmajor(r, l * F, K0), acc);
  }
}

// mlp_kernel_bf16 / rgb_head_kernel_bf16 / encode_mlp_kernel, one
// warpgroup a block. KIND 0: the rows of x (f32 or bf16) are the input;
// KIND 1: the rgb head's row; KIND 2: x holds positions (N, 3) and the
// input row is their encode (E, F features a level).
template <int HID, int KIND, int F = 1>
__device__ __forceinline__ void mlp_tc(const MlpParams& P, const TcPlan& Q,
                                       long long n, const void* __restrict__ x,
                                       const float* __restrict__ dirs,
                                       const float* __restrict__ extra,
                                       float* __restrict__ out,
                                       const int* __restrict__ count,
                                       const EncodeSrc& E = EncodeSrc{}) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KS = HID / 16, NB = HID / 64;
  n = live_rows(n, count);
  const long long n_tiles = (n + TC_ROWS - 1) / TC_ROWS;
  const long long step = gridDim.x;
  if (blockIdx.x >= n_tiles) return;     // a block with no tile stages nothing
  unsigned char* ring = smem + Q.ring_off;
  // the first tiles' loads fly while the weights are staged
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    const long long tile = blockIdx.x + s * step;
    if (tile < n_tiles)
      load_tile<KIND>(P, Q, n, tile, x, dirs, extra, ring + s * Q.stage);
    cp_async_commit();
  }
  stage_weights(P, Q, smem);
  if (KIND == 1 && !P.extra_rows)
    for (int e = threadIdx.x; e < P.n_extra; e += TC_THREADS)
      reinterpret_cast<float*>(smem + Q.codes_off)[e] = __ldg(extra + e);
  if (KIND == 2)              // A's padding columns, never written again
    for (int e = 16 * threadIdx.x; e < TC_ROWS * Q.k[0] * 2;
         e += 16 * TC_THREADS)
      *reinterpret_cast<uint4*>(smem + Q.a0_off + e) = make_uint4(0, 0, 0, 0);
  fence_async_shared();
  __syncthreads();

  const int L = P.n_layers;
  const uint64_t da = kmajor_desc(smem + Q.a0_off, Q.k[0]);
  int it = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += step, ++it) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();          // this tile's stage is in; the last one's
    {                         // stage and A are free
      const long long next = tile + (TC_STAGES - 1) * step;
      if (next < n_tiles)
        load_tile<KIND>(P, Q, n, next, x, dirs, extra,
                        ring + ((it + TC_STAGES - 1) % TC_STAGES) * Q.stage);
      cp_async_commit();
    }
    const long long row0 = tile * TC_ROWS;
    const int rows = (int)min((long long)TC_ROWS, n - row0);
    unsigned char* st = ring + (it % TC_STAGES) * Q.stage;
    if (KIND == 1) {          // SH of each row: the two halves of the
      const int r = threadIdx.x & 63, half = threadIdx.x >> 6;   // block
      if (r < rows) {         // each write half of it
        const float* d = reinterpret_cast<const float*>(st + Q.seg[1]) + r * 3;
        float sh[SH_WIDTH];
        sh_encode(d[0], d[1], d[2], P.sh_degree, sh);
        float4* s = reinterpret_cast<float4*>(
            st + Q.sh_off + 4 * (r * SH_STRIDE + 8 * half));
        s[0] = half ? make_float4(sh[8], sh[9], sh[10], sh[11])
                    : make_float4(sh[0], sh[1], sh[2], sh[3]);
        s[1] = half ? make_float4(sh[12], sh[13], sh[14], sh[15])
                    : make_float4(sh[4], sh[5], sh[6], sh[7]);
      }
      __syncthreads();
    }
    if constexpr (KIND == 2) {
      const int r = threadIdx.x & 63;
      const float* p = reinterpret_cast<const float*>(st + Q.seg[0]) + 3 * r;
      const bool live = r < rows;
      encode_a<F>(E, smem + Q.a0_off, Q.k[0], threadIdx.x, live,
                  live ? p[0] : 0.0f, live ? p[1] : 0.0f, live ? p[2] : 0.0f);
    } else {
      build_a<KIND>(P, Q, smem, st, rows);
    }
    fence_async_shared();     // A, written by the threads, for wgmma
    __syncthreads();

    if (L == 1) {
      const uint64_t db = kmajor_desc(smem + Q.w_off[0], Q.k[0]);
      for (int c = 0; c < P.n_store; c += 16) {
        float o[8];
        block_ss16(o, da, db + (uint64_t)2 * Q.k[0] * (c >> 4), Q.k[0] >> 4);
        store_block(o, out, P.n_store, row0, rows, c);
      }
      continue;
    }
    float h[HID / 2];
    uint32_t a[KS][4];
    layer_ss<NB>(h, da, kmajor_desc(smem + Q.w_off[0], Q.k[0]), Q.k[0] >> 4,
                 Q.k[0]);
    to_a<KS>(h, a);
    for (int l = 1; l + 1 < L; ++l) {
      layer_rs<KS, NB>(h, a, kmajor_desc(smem + Q.w_off[l], HID));
      to_a<KS>(h, a);
    }
    const uint64_t db = kmajor_desc(smem + Q.w_off[L - 1], HID);
    for (int c = 0; c < P.n_store; c += 16) {
      float o[8];
      block_rs16<KS>(o, a, db + (uint64_t)2 * HID * (c >> 4));
      store_block(o, out, P.n_store, row0, rows, c);
    }
  }
  cp_async_wait<0>();
}

template <int HID>
__global__ void __launch_bounds__(TC_THREADS) mlp_kernel_bf16(
    MlpParams P, TcPlan Q, long long n, const void* __restrict__ x,
    float* __restrict__ out, const int* __restrict__ count) {
  mlp_tc<HID, 0>(P, Q, n, x, nullptr, nullptr, out, count);
}

template <int HID>
__global__ void __launch_bounds__(TC_THREADS) rgb_head_kernel_bf16(
    MlpParams P, TcPlan Q, long long n, const float* __restrict__ feat,
    const float* __restrict__ dirs, const float* __restrict__ extra,
    float* __restrict__ out, const int* __restrict__ count) {
  mlp_tc<HID, 1>(P, Q, n, feat, dirs, extra, out, count);
}

// nmr_encode_mlp, one warpgroup a block: the encode builds each tile's A
// from the positions the cp.async ring brought.
template <int HID, int F>
__global__ void __launch_bounds__(TC_THREADS,
                                  HID == 64 ? ENCODE_MLP_BLOCKS_PER_SM : 1)
    encode_mlp_kernel(EncodeParams EP, MlpParams P, TcPlan Q, long long n,
                      const float* __restrict__ table,
                      const float* __restrict__ pos, float* __restrict__ out,
                      const int* __restrict__ count) {
  __shared__ Levels lv;
  load_levels(EP, lv);        // seen after mlp_tc's first __syncthreads
  mlp_tc<HID, 2, F>(P, Q, n, pos, nullptr, nullptr, out, count,
                    EncodeSrc{table, &lv, EP.n_levels, EP.rows,
                              EP.encode_bf16 != 0});
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int F, bool BF16>
int launch_encode(const EncodeParams& P, long long n, const float* table,
                  const float* pos, void* out, const int* count,
                  cudaStream_t s) {
  const int stride = encode_stride(P.n_levels * F * (BF16 ? 2 : 4));
  const int tile = encode_tile(stride);
  long long blocks = (n + tile - 1) / tile;
  const int smem = ((tile * 12 + 15) & ~15) + tile * stride;
  if (count) {                // a grid the card holds at once, whatever
    int per_sm = 0;           // the count turns out to be
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hash_encode_kernel<F, BF16>, ENCODE_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = (long long)(per_sm > 1 ? per_sm : 1) * sm_count();
    if (blocks > cap) blocks = cap;
  }
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  hash_encode_kernel<F, BF16><<<(int)blocks, ENCODE_THREADS, smem, s>>>(
      P, n, tile, __builtin_ctz(tile / 32), stride, table, pos, out, count);
  return static_cast<int>(cudaGetLastError());
}

template <int F, bool BF16, bool POS>
int launch_encode_backward(const EncodeParams& P, long long n,
                           const float* table, const float* pos,
                           const void* grad, float* grad_table,
                           float* grad_pos, cudaStream_t s) {
  const long long blocks = (n + ENCODE_TILE - 1) / ENCODE_TILE;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ENCODE_TILE * 3 * (int)sizeof(float) +
                   (POS ? ENCODE_TILE * P.n_levels * 3 * (int)sizeof(float) : 0);
  hash_encode_backward_kernel<F, BF16, POS>
      <<<(int)blocks, ENCODE_THREADS, smem, s>>>(P, n, table, pos, grad,
                                                 grad_table, grad_pos);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_encode_backward_f(const EncodeParams& P, long long n,
                             const float* table, const float* pos,
                             const void* grad, float* grad_table,
                             float* grad_pos, cudaStream_t s) {
  const bool bf16 = P.encode_bf16 != 0;
  if (grad_pos)
    return bf16 ? launch_encode_backward<F, true, true>(P, n, table, pos, grad,
                                                        grad_table, grad_pos, s)
                : launch_encode_backward<F, false, true>(P, n, table, pos, grad,
                                                         grad_table, grad_pos, s);
  return bf16 ? launch_encode_backward<F, true, false>(P, n, table, pos, grad,
                                                       grad_table, nullptr, s)
              : launch_encode_backward<F, false, false>(P, n, table, pos, grad,
                                                        grad_table, nullptr, s);
}

// The register-tiled launch's shared memory in bytes at hidden width
// HID, kind as mlp_tiles' KIND: the weights (each layer's pad16 K x
// rt_cols), the activations (the widest K x rt_samples), the staging area
// (rt_stage_bytes).
int rt_smem(const MlpParams& P, int hid, int kind) {
  const bool tiled = kind == 0 && rt_last_tiled(P, hid);
  int w = 0, rows = 0;
  for (int l = 0; l < P.n_layers; ++l) {
    w += pad16(P.width[l]) * rt_cols(P, l, tiled);
    if (pad16(P.width[l]) > rows) rows = pad16(P.width[l]);
  }
  return (int)sizeof(float) * (w + rows * rt_samples(hid)) +
         rt_stage_bytes(P, kind, rt_samples(hid));
}

// The f32 instance for P's widest layer (or stored width): 64 or 128.
int f32_width(const MlpParams& P) {
  int widest = P.n_store;
  for (int l = 1; l <= P.n_layers; ++l)
    if (P.width[l] > widest) widest = P.width[l];
  return widest <= 64 ? 64 : widest <= 128 ? 128 : 0;
}

// The tensor-core launch's shared-memory plan for hidden width HID; the
// rows of each stage in the order load_tile reads them; kind as mlp_tc's
// KIND (2: a stage holds the tile's positions).
TcPlan tc_plan(const MlpParams& P, int hid, int kind) {
  TcPlan Q = {};
  int off = 0;
  auto take = [&off](int bytes) {
    const int o = off;
    off += (bytes + 127) & ~127;
    return o;
  };
  const int L = P.n_layers;
  for (int l = 0; l < L; ++l) {
    Q.k[l] = l == 0 ? pad16(P.width[0]) : hid;
    Q.rows[l] = l + 1 == L ? pad16(P.n_store) : hid;
    Q.w_off[l] = take(Q.rows[l] * Q.k[l] * 2);
  }
  Q.codes_off = take(kind == 1 ? 4 * P.n_extra : 0);
  Q.a0_off = take(TC_ROWS * Q.k[0] * 2);
  const int row_bytes[3] = {
      kind == 0   ? P.width[0] * (P.x_bf16 ? 2 : 4)
      : kind == 2 ? 12
                  : 4 * P.n_feat,
      kind == 1 ? 12 : 0,
      kind == 1 && P.extra_rows ? 4 * P.n_extra : 0};
  int s = 0;
  for (int i = 0; i < 3; ++i) {
    Q.seg[i] = s;
    Q.seg_row[i] = row_bytes[i];
    s += (TC_ROWS * row_bytes[i] + 15) & ~15;
  }
  Q.sh_off = s;
  if (kind == 1) s += TC_ROWS * SH_STRIDE * 4;
  Q.stage = (s + 127) & ~127;
  Q.ring_off = take(TC_STAGES * Q.stage);
  Q.smem = off;
  return Q;
}

// Persistent blocks of `threads` over n rows in tiles of tile_rows: at
// most max_per_sm a multiprocessor (fewer where shared memory or
// registers allow fewer), no more blocks than tiles.
template <typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), int threads, int smem,
                 int max_per_sm, long long n, int tile_rows, cudaStream_t s,
                 Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (per_sm > max_per_sm) per_sm = max_per_sm;
  long long blocks = (n + tile_rows - 1) / tile_rows;
  const long long cap = (long long)per_sm * sm_count();
  if (blocks > cap) blocks = cap;
  kernel<<<(int)blocks, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int HID>
int launch_mlp(const MlpParams& P, long long n, const void* x, float* out,
               const int* count, cudaStream_t s) {
  return launch_tiles(mlp_kernel<HID>, RT_THREADS, rt_smem(P, HID, 0),
                      RT_BLOCKS_PER_SM, n, rt_samples(HID), s, P, n, x, out,
                      count);
}

template <int HID>
int launch_rgb_head(const MlpParams& P, long long n, const float* feat,
                    const float* dirs, const float* extra, float* out,
                    const int* count, cudaStream_t s) {
  return launch_tiles(rgb_head_kernel<HID>, RT_THREADS, rt_smem(P, HID, 1),
                      RT_BLOCKS_PER_SM, n, rt_samples(HID), s, P, n, feat,
                      dirs, extra, out, count);
}

template <int HID, int KIND>
int launch_tc(const MlpParams& P, long long n, const void* x,
              const float* dirs, const float* extra, float* out,
              const int* count, cudaStream_t s) {
  const TcPlan Q = tc_plan(P, HID, KIND);
  if (KIND == 0)
    return launch_tiles(mlp_kernel_bf16<HID>, TC_THREADS, Q.smem,
                        TC_BLOCKS_PER_SM, n, TC_ROWS, s, P, Q, n, x, out,
                        count);
  return launch_tiles(rgb_head_kernel_bf16<HID>, TC_THREADS, Q.smem,
                      TC_BLOCKS_PER_SM, n, TC_ROWS, s, P, Q, n,
                      static_cast<const float*>(x), dirs, extra, out, count);
}

// The tensor-core instance that takes P: hidden width 64 or 128 (the
// widest hidden layer; a single-layer MLP has none), 0 for none.
int hidden_width(const MlpParams& P) {
  int widest = 0;
  for (int l = 1; l < P.n_layers; ++l)
    if (P.width[l] > widest) widest = P.width[l];
  return widest <= 64 ? 64 : widest <= 128 ? 128 : 0;
}

template <int KIND>
int launch_tc_width(const MlpParams& P, long long n, const void* x,
                    const float* dirs, const float* extra, float* out,
                    const int* count, cudaStream_t s) {
  switch (hidden_width(P)) {
    case 64: return launch_tc<64, KIND>(P, n, x, dirs, extra, out, count, s);
    case 128: return launch_tc<128, KIND>(P, n, x, dirs, extra, out, count, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HID, int F>
int launch_encode_mlp(const EncodeParams& E, const MlpParams& P, long long n,
                      const float* table, const float* pos, float* out,
                      const int* count, cudaStream_t s) {
  const TcPlan Q = tc_plan(P, HID, 2);
  return launch_tiles(encode_mlp_kernel<HID, F>, TC_THREADS, Q.smem,
                      ENCODE_MLP_BLOCKS_PER_SM, n, TC_ROWS, s, E, P, Q, n,
                      table, pos, out, count);
}

template <int F>
int launch_encode_mlp_width(const EncodeParams& E, const MlpParams& P,
                            long long n, const float* table,
                            const float* pos, float* out, const int* count,
                            cudaStream_t s) {
  switch (hidden_width(P)) {
    case 64:
      return launch_encode_mlp<64, F>(E, P, n, table, pos, out, count, s);
    case 128:
      return launch_encode_mlp<128, F>(E, P, n, table, pos, out, count, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// False for layer widths the kernels do not take.
bool valid_widths(const MlpParams& P) {
  if (P.n_layers < 1 || P.n_layers > MAX_LAYERS) return false;
  for (int l = 0; l < P.n_layers; ++l)
    if (P.width[l] < 1 || P.width[l + 1] < 1) return false;
  return P.n_store >= 1 && P.n_store <= P.width[P.n_layers];
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each copies the parameters,
// launches on the given stream, and returns cudaGetLastError() (0 on
// success, cudaErrorInvalidValue for shapes the kernels do not take, the
// runtime's error for a launch it refuses). The MLPs take the tensor-core
// body at the bf16 compute dtype and the CUDA-core body at f32. The
// forward's entries take `count`: null, or one int32 in device memory
// whose value, read when the kernel runs, bounds the rows the launch
// reads and writes (live_rows); the grid follows n alone.

extern "C" int nmr_hash_encode(const EncodeParams* p, long long n,
                               const float* table, const float* pos,
                               void* out, const int* count, void* stream) {
  const EncodeParams P = *p;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.n_levels < 1 || P.n_levels > MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
#define NMR_ENCODE(F)                                                        \
  return P.encode_bf16                                                       \
             ? launch_encode<F, true>(P, n, table, pos, out, count, s)      \
             : launch_encode<F, false>(P, n, table, pos, out, count, s)
  switch (P.n_features) {
    case 1: NMR_ENCODE(1);
    case 2: NMR_ENCODE(2);
    case 4: NMR_ENCODE(4);
    case 8: NMR_ENCODE(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NMR_ENCODE
}

// The encode's backward: grad (n, L F) in the encode dtype -> grad_table
// (L, rows, F) f32 added to (the caller zeroes it) and, where grad_pos is
// not null, grad_pos (n, 3) f32 written.
extern "C" int nmr_hash_encode_backward(const EncodeParams* p, long long n,
                                        const float* table, const float* pos,
                                        const void* grad, float* grad_table,
                                        float* grad_pos, void* stream) {
  const EncodeParams P = *p;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.n_levels < 1 || P.n_levels > MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (P.n_features) {
    case 1: return launch_encode_backward_f<1>(P, n, table, pos, grad,
                                               grad_table, grad_pos, s);
    case 2: return launch_encode_backward_f<2>(P, n, table, pos, grad,
                                               grad_table, grad_pos, s);
    case 4: return launch_encode_backward_f<4>(P, n, table, pos, grad,
                                               grad_table, grad_pos, s);
    case 8: return launch_encode_backward_f<8>(P, n, table, pos, grad,
                                               grad_table, grad_pos, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int nmr_mlp(const MlpParams* p, long long n, const void* x,
                       float* out, const int* count, void* stream) {
  const MlpParams P = *p;
  if (!valid_widths(P)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.round_bf16)
    return launch_tc_width<0>(P, n, x, nullptr, nullptr, out, count, s);
  switch (f32_width(P)) {
    case 64: return launch_mlp<64>(P, n, x, out, count, s);
    case 128: return launch_mlp<128>(P, n, x, out, count, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int nmr_rgb_head(const MlpParams* p, long long n,
                            const float* feat, const float* dirs,
                            const float* extra, float* out, const int* count,
                            void* stream) {
  const MlpParams P = *p;
  if (!valid_widths(P) || P.sh_degree < 1 || P.sh_degree > 4 ||
      P.n_feat + SH_WIDTH + P.n_extra > P.width[0])
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.round_bf16)
    return launch_tc_width<1>(P, n, feat, dirs, extra, out, count, s);
  switch (f32_width(P)) {
    case 64:
      return launch_rgb_head<64>(P, n, feat, dirs, extra, out, count, s);
    case 128:
      return launch_rgb_head<128>(P, n, feat, dirs, extra, out, count, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The encode of `pos` over `table` (E) through the density MLP (P, bf16
// compute dtype, input width L F) in one launch: nmr_hash_encode followed
// by nmr_mlp at bf16 compute, bit for bit, without the (N, L F)
// intermediate.
extern "C" int nmr_encode_mlp(const EncodeParams* e, const MlpParams* p,
                              long long n, const float* table,
                              const float* pos, float* out, const int* count,
                              void* stream) {
  const EncodeParams E = *e;
  const MlpParams P = *p;
  if (!valid_widths(P) || !P.round_bf16 || E.n_levels < 1 ||
      E.n_levels > MAX_LEVELS || P.width[0] != E.n_levels * E.n_features)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E.n_features) {
    case 1:
      return launch_encode_mlp_width<1>(E, P, n, table, pos, out, count,
                                        s);
    case 2:
      return launch_encode_mlp_width<2>(E, P, n, table, pos, out, count,
                                        s);
    case 4:
      return launch_encode_mlp_width<4>(E, P, n, table, pos, out, count,
                                        s);
    case 8:
      return launch_encode_mlp_width<8>(E, P, n, table, pos, out, count,
                                        s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
