// Fused negacyclic NTT / inverse NTT over a batch of RNS limb planes.
//
// Replaces the TPU kernel dacapo_tpu/crypto/pallas/ntt_kernel.py:
// `_ntt_kernel`, launched by `ntt_pallas` (forward, inverse=False, and
// inverse, inverse=True). Same contract: x is [B, N] residues (uint32 bits,
// every value < q < 2^31); plane b uses prime rows[b]. Forward is
// Cooley-Tukey from natural to bit-reversed order with psi folded into the
// twiddles; inverse runs Gentleman-Sande stages in reverse with the inverse
// twiddles, then multiplies by N^-1. Every modular product is a Shoup
// multiply, so every output is the canonical residue, bit-equal to the plain
// version (crypto/ntt.py) and to the reference.
//
// What bounds it on an H100 (per call of B planes, logN stages):
//   bytes:      read B*N*4 + write B*N*4, plus 2*N*4 of twiddles (value and
//               Shoup companion) per distinct prime in `rows`;
//   operations: logN * N/2 butterflies per plane, each 1 mul.hi + 2 mul.lo
//               + about 4 add/compare (the inverse adds N Shoup multiplies
//               by N^-1).
// At N=2^15 that is 7 * 15 / 2 / 8 ~ 6.6 operations per byte of plane,
// under the card's ~20 (67 T 32-bit op/s over 3.35 TB/s): the bound is the
// bytes through device memory.
//
// Design: one thread block per plane (grid = B). The block loads the plane
// once into dynamic shared memory (128 KB at N=2^15, under the 227 KB a
// block may use), runs all logN stages there with __syncthreads() between
// stages, and writes it once: one pass through device memory per plane.
// N is a template parameter, so each thread's N/2/1024 butterflies of a
// stage are unrolled in groups of 8 whose operands and twiddles are loaded
// together before any is computed, so their L2 latencies overlap.
// Twiddles are read from the compact per-prime tables [P, N] (18 MB at the
// tpu_n15 profile, resident in the 50 MB L2) at index m + j, not from the
// TPU kernel's per-stage [P, logN, N] planes. N ranges over 2^10..2^15; an
// N=2^16 plane (256 KB) does not fit one block's shared memory.
//
// Plain C interface, loaded with ctypes; returns the cudaError_t of launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t ws, uint32_t q) {
  const uint32_t hi = __umulhi(a, ws);
  const uint32_t r = a * w - hi * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;  // a, b < q < 2^31: no wrap
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : (a + q) - b;
}

constexpr int kMaxThreads = 1024;

// One stage of this thread's butterflies, GROUP at a time: a group's
// operands and twiddles are all loaded before any is computed, so the L2
// latencies of the twiddle reads overlap. GROUP = 8 keeps a 1024-thread
// block inside its 64 registers a thread without spilling.
template <int LOGN, bool INVERSE>
__device__ __forceinline__ void stage(uint32_t* s, const uint32_t* w_row,
                                      const uint32_t* ws_row, uint32_t q,
                                      int m, int lt) {
  constexpr int HALF = 1 << (LOGN - 1);
  constexpr int THREADS = HALF < kMaxThreads ? HALF : kMaxThreads;
  constexpr int ITER = HALF / THREADS;
  constexpr int GROUP = ITER < 8 ? ITER : 8;
  const int tmask = (1 << lt) - 1;
#pragma unroll 1
  for (int g = 0; g < ITER; g += GROUP) {
    int i0[GROUP];
    uint32_t a[GROUP], b[GROUP], w[GROUP], ws[GROUP];
#pragma unroll
    for (int it = 0; it < GROUP; ++it) {
      const int k = threadIdx.x + (g + it) * THREADS;
      const int j = k >> lt;
      i0[it] = (j << (lt + 1)) + (k & tmask);
      w[it] = __ldg(w_row + m + j);
      ws[it] = __ldg(ws_row + m + j);
      a[it] = s[i0[it]];
      b[it] = s[i0[it] + (1 << lt)];
    }
#pragma unroll
    for (int it = 0; it < GROUP; ++it) {
      if (!INVERSE) {  // Cooley-Tukey: (u + wv, u - wv)
        const uint32_t v = mul_shoup(b[it], w[it], ws[it], q);
        s[i0[it]] = add_mod(a[it], v, q);
        s[i0[it] + (1 << lt)] = sub_mod(a[it], v, q);
      } else {         // Gentleman-Sande: (u + v, w (u - v))
        s[i0[it]] = add_mod(a[it], b[it], q);
        s[i0[it] + (1 << lt)] = mul_shoup(sub_mod(a[it], b[it], q), w[it], ws[it], q);
      }
    }
  }
}

template <int LOGN, bool INVERSE>
__global__ void __launch_bounds__(kMaxThreads)
ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
           const int32_t* __restrict__ rows, const uint32_t* __restrict__ tw,
           const uint32_t* __restrict__ tws, const uint32_t* __restrict__ qv,
           const uint32_t* __restrict__ ninv,
           const uint32_t* __restrict__ ninvs) {
  constexpr int N = 1 << LOGN;
  extern __shared__ uint4 smem4[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem4);
  const int r = rows[blockIdx.x];
  const uint32_t q = qv[r];
  const uint32_t* w_row = tw + (size_t)r * N;
  const uint32_t* ws_row = tws + (size_t)r * N;
  const size_t base = (size_t)blockIdx.x * N;

  const uint4* x4 = reinterpret_cast<const uint4*>(x + base);
  for (int i = threadIdx.x; i < N / 4; i += blockDim.x) smem4[i] = x4[i];
  __syncthreads();

  if (!INVERSE) {
    // stage m = 1, 2, ..., N/2 with half-width t = N / 2m = 2^lt
    for (int m = 1, lt = LOGN - 1; m < N; m <<= 1, --lt) {
      stage<LOGN, false>(s, w_row, ws_row, q, m, lt);
      __syncthreads();
    }
    uint4* y4 = reinterpret_cast<uint4*>(y + base);
    for (int i = threadIdx.x; i < N / 4; i += blockDim.x) y4[i] = smem4[i];
  } else {
    // stage m = N/2, ..., 2, 1, then the multiply by N^-1
    for (int m = N / 2, lt = 0; m >= 1; m >>= 1, ++lt) {
      stage<LOGN, true>(s, w_row, ws_row, q, m, lt);
      __syncthreads();
    }
    const uint32_t ni = ninv[r];
    const uint32_t nis = ninvs[r];
    uint4* y4 = reinterpret_cast<uint4*>(y + base);
    for (int i = threadIdx.x; i < N / 4; i += blockDim.x) {
      uint4 v = smem4[i];
      v.x = mul_shoup(v.x, ni, nis, q);
      v.y = mul_shoup(v.y, ni, nis, q);
      v.z = mul_shoup(v.z, ni, nis, q);
      v.w = mul_shoup(v.w, ni, nis, q);
      y4[i] = v;
    }
  }
}

template <int LOGN, bool INVERSE>
cudaError_t launch(const void* x, void* y, const void* rows, int batch,
                   const void* tw, const void* tws, const void* q,
                   const void* ninv, const void* ninvs, cudaStream_t stream) {
  constexpr int SMEM = (int)sizeof(uint32_t) << LOGN;
  constexpr int HALF = 1 << (LOGN - 1);
  constexpr int THREADS = HALF < kMaxThreads ? HALF : kMaxThreads;
  static bool smem_set = false;  // dynamic shared bytes allowed once
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ntt_kernel<LOGN, INVERSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  ntt_kernel<LOGN, INVERSE><<<batch, THREADS, SMEM, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const int32_t*>(rows), static_cast<const uint32_t*>(tw),
      static_cast<const uint32_t*>(tws), static_cast<const uint32_t*>(q),
      static_cast<const uint32_t*>(ninv), static_cast<const uint32_t*>(ninvs));
  return cudaGetLastError();
}

template <bool INVERSE>
cudaError_t launch_n(int logn, const void* x, void* y, const void* rows,
                     int batch, const void* tw, const void* tws, const void* q,
                     const void* ninv, const void* ninvs, cudaStream_t st) {
  switch (logn) {
    case 10: return launch<10, INVERSE>(x, y, rows, batch, tw, tws, q, ninv, ninvs, st);
    case 11: return launch<11, INVERSE>(x, y, rows, batch, tw, tws, q, ninv, ninvs, st);
    case 12: return launch<12, INVERSE>(x, y, rows, batch, tw, tws, q, ninv, ninvs, st);
    case 13: return launch<13, INVERSE>(x, y, rows, batch, tw, tws, q, ninv, ninvs, st);
    case 14: return launch<14, INVERSE>(x, y, rows, batch, tw, tws, q, ninv, ninvs, st);
    case 15: return launch<15, INVERSE>(x, y, rows, batch, tw, tws, q, ninv, ninvs, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dacapo_ntt(const void* x, void* y, const void* rows, int batch,
                          int logn, int inverse, const void* tw,
                          const void* tws, const void* q, const void* ninv,
                          const void* ninvs, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      inverse ? launch_n<true>(logn, x, y, rows, batch, tw, tws, q, ninv, ninvs, st)
              : launch_n<false>(logn, x, y, rows, batch, tw, tws, q, ninv, ninvs, st);
  return (int)e;
}

extern "C" const char* dacapo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
