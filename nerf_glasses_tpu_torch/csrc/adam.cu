// The trainer's Adam update of the network's parameters for Hopper: one
// launch for every parameter (the hash table and the MLPs' matrices).
//
//   adam_kernel (nmr_adam)   ops/adam_cuda.py::adam; JAX
//       nerf_glasses_tpu/train/trainer.py:665 adam_update (XLA's
//       elementwise fusion there; no Pallas kernel). The port's plain
//       version is ops/adam_cuda.py::adam_reference, the trainer's former
//       aten update (94 operations a step on the card's host).
//
// Bound: bytes. Each element reads p, g, m, v and writes p, m, v: 28 bytes
// for ~12 flops. native_fast's 1.06M elements move 29.6 MB, 0.0088 ms at
// 3.35 TB/s. Design: a grid-stride loop over the parameters laid end to
// end (up to ADAM_MAX_ENTRIES of them), a thread an element, its entry
// found from the entries' first elements (a short scan of at most 8);
// every load and store coalesced.
//
// Numerics: the plain version's elementwise order, each operation rounded
// on its own as aten rounds it (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn: nvcc contracts none into an FMA), its f32
// constants as aten casts the Python scalars:
//   g' = g + l2 p   (where l2 != 0; the table takes none)
//   m  = b1 m + (1 - b1) g'
//   v  = b2 v + ((1 - b2) g') g'
//   p  = p - (lr_corr m) / (sqrt(v) + eps)
// so the kernel is the card's plain version bit for bit (aten's kernels on
// the card round each operation correctly; the CPU's sqrt is MKL's, off by
// an ulp on some values, so the CPU's parameters differ there).
// lr_corr (the learning rate times the bias correction, which changes
// every step) is read from device memory when the kernel runs: a launch
// captured in a CUDA graph serves every step.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int ADAM_MAX_ENTRIES = 8;

// Layout shared with ops/adam_cuda.py::AdamParams.
struct AdamParams {
  int n_entries;
  float b1, c1, b2, c2, eps;               // c1 = 1 - b1, c2 = 1 - b2 (f32)
  float l2[ADAM_MAX_ENTRIES];
  long long start[ADAM_MAX_ENTRIES + 1];  // each entry's first element
  float* p[ADAM_MAX_ENTRIES];
  const float* g[ADAM_MAX_ENTRIES];
  float* m[ADAM_MAX_ENTRIES];
  float* v[ADAM_MAX_ENTRIES];
};

namespace {

constexpr int ADAM_THREADS = 256;

__global__ void __launch_bounds__(ADAM_THREADS)
    adam_kernel(AdamParams P, const float* __restrict__ lr_corr) {
  const float a = *lr_corr;
  const long long total = P.start[P.n_entries];
  for (long long i = blockIdx.x * (long long)ADAM_THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * ADAM_THREADS) {
    int e = 0;
    while (i >= P.start[e + 1]) ++e;
    const long long j = i - P.start[e];
    const float p = P.p[e][j];
    float g = P.g[e][j];
    if (P.l2[e] != 0.0f) g = __fadd_rn(g, __fmul_rn(p, P.l2[e]));
    const float m = __fadd_rn(__fmul_rn(P.m[e][j], P.b1), __fmul_rn(g, P.c1));
    const float v = __fadd_rn(__fmul_rn(P.v[e][j], P.b2),
                              __fmul_rn(__fmul_rn(g, P.c2), g));
    P.m[e][j] = m;
    P.v[e][j] = v;
    P.p[e][j] = __fsub_rn(
        p, __fdiv_rn(__fmul_rn(m, a), __fadd_rn(__fsqrt_rn(v), P.eps)));
  }
}

}  // namespace

// One Adam step of P's entries in place, lr_corr one f32 in device
// memory, on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an entry count the kernel does not take).
extern "C" int nmr_adam(const AdamParams* p, const float* lr_corr,
                        int sms, void* stream) {
  const AdamParams P = *p;
  if (P.n_entries < 1 || P.n_entries > ADAM_MAX_ENTRIES)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = P.start[P.n_entries];
  if (total <= 0) return 0;
  long long blocks = (total + ADAM_THREADS - 1) / ADAM_THREADS;
  const long long cap = (long long)(sms > 0 ? sms : 1) * 8;
  if (blocks > cap) blocks = cap;
  adam_kernel<<<(int)blocks, ADAM_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(P, lr_corr);
  return static_cast<int>(cudaGetLastError());
}
