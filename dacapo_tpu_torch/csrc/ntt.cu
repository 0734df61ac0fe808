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
// version (crypto/ntt.py) and to the reference. N = 2^8 .. 2^16.
//
// What bounds it on an H100 (per call of B planes, n = logN stages):
//   bytes:      read B*N*4 + write B*N*4, plus 2*N*4 of twiddles (value and
//               Shoup companion) per distinct prime in `rows`;
//   operations: n * N/2 butterflies per plane, each 1 mul.hi + 2 mul.lo
//               + about 4 add/compare (the inverse adds N Shoup multiplies
//               by N^-1), at ~16.7e12 32-bit integer instructions a second
//               (64 INT32 lanes per SM x 132 SMs x 1.98 GHz).
// At N=2^15 that is 7 * 15 / 2 / 8 ~ 6.6 operations per byte of plane
// against the card's ~5 (16.7 T/s over 3.35 TB/s): operations bound it,
// with bytes close behind (equal at B=112 with 35 distinct primes).
//
// Design: two passes, each a grid of small tiles spread over all SMs.
// Forward stage s (0..n-1) has m = 2^s, distance t = 2^(n-1-s), and its
// butterfly at i uses tw[m + (i >> (n-s))]. Split at k = n/2, L = 2^(n-k):
//   pass A, stages s < k (t >= L), on COLUMNS c in [0, L): column c is
//     x[c + r*L], r in [0, 2^k); stage s pairs r with r + 2^(k-1-s) and
//     uses tw[2^s + (r >> (k-s))], the same for every column. A block takes
//     2^k rows x SEQS adjacent columns (SEQS >= 8: a 32-byte sector a row).
//   pass B, stages s >= k (t < L), on SEGMENTS g in [0, 2^k): segment g is
//     x[g*L .. g*L + L); the element at offset u uses
//     tw[2^s + g*2^(s-k) + (u >> (n-s))]. A block takes SEQS whole segments.
// Forward runs A (x -> y) then B (y -> y in place: a block owns its
// segments); inverse runs B (x -> y) then A (y -> y) with N^-1 fused into
// A's store. No scratch: between the passes the planes stay in the 50 MB L2
// at the MLP path's shapes (B <= 112 at N=2^15: at most 14.7 MB); the load
// shape B=2240 (294 MB) goes through device memory twice.
// Blocks per pass at N=2^15: B*32 in A (128 x 8 tiles, 256 threads) and
// B*32 in B (4 segments of 256, 256 threads), so B=2 launches 64 blocks per
// pass and B >= 5 fills all 132 SMs; at N=2^16, B*32 (A, 256 x 8, 512
// threads) and B*64 (B, 4 x 256).
// Each thread holds 4 elements and runs two stages on them in registers
// (radix 4: 3 twiddle pairs for 4 butterflies) between shared-memory
// exchanges; an odd leftover stage runs as radix 2 at distance 1. The first
// step of a pass loads from device memory and its last step stores there,
// so a pass of l stages costs ceil(l/2) - 1 exchanges and __syncthreads().
// At the contiguous end of pass B (distance <= 2) a thread's 4 elements are
// adjacent and move as one 16-byte access.
// Measured (PERF.md): ~3.4x the bound at B=112, N=2^15. An XOR swizzle that
// removed the exchanges' 2- and 4-way bank conflicts, at the cost of more
// integer instructions, made it slower, and fewer instructions per
// reduction (umin below) made it faster: issuing integer instructions and,
// at small B, latency limit it, not shared memory.
//
// Plain C interface, loaded with ctypes; returns the cudaError_t of launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Each reduction below takes v in [0, 2q), or a difference that wrapped,
// to [0, q) as umin(v, v - q) (umin(d, d + q) for a difference): where
// v < q, v - q wraps above 2^31 > v. An add and a min, where a compare, a
// subtract and a select would do the same.
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t ws, uint32_t q) {
  const uint32_t hi = __umulhi(a, ws);
  const uint32_t r = a * w - hi * q;  // in [0, 2q)
  return umin(r, r - q);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;  // a, b < q < 2^31: no wrap
  return umin(s, s - q);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t d = a - b;  // wraps above 2^31 where a < b
  return umin(d, d + q);
}

// Cooley-Tukey: (u + wv, u - wv)
__device__ __forceinline__ void ct(uint32_t& u, uint32_t& v, uint32_t w,
                                   uint32_t ws, uint32_t q) {
  const uint32_t t = mul_shoup(v, w, ws, q);
  v = sub_mod(u, t, q);
  u = add_mod(u, t, q);
}

// Gentleman-Sande: (u + v, w (u - v))
__device__ __forceinline__ void gs(uint32_t& u, uint32_t& v, uint32_t w,
                                   uint32_t ws, uint32_t q) {
  const uint32_t d = sub_mod(u, v, q);
  u = add_mod(u, v, q);
  v = mul_shoup(d, w, ws, q);
}

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// One pass of an N = 2^LOGN transform: its sequences, tiles and threads.
template <int LOGN, bool PASS_B>
struct Pass {
  static constexpr int K = LOGN / 2;                     // stages in pass A
  static constexpr int LOGL = LOGN - K;                  // stages in pass B
  static constexpr int L = 1 << LOGL;                    // columns / segment length
  static constexpr int R = 1 << K;                       // column length / segments
  static constexpr int LEN_LOG = PASS_B ? LOGL : K;      // log2 of one sequence
  static constexpr int LEN = 1 << LEN_LOG;
  // sequences per tile: pass A >= 8 adjacent columns, pass B whole segments
  static constexpr int SEQS = PASS_B ? cmin(R, cmax(1, 1024 >> LOGL))
                                     : cmin(L, cmax(8, 1024 >> K));
  static constexpr int TILES = (PASS_B ? R : L) / SEQS;  // tiles per plane
  static constexpr int GRPS = LEN / 4;                   // threads per sequence
  static constexpr int THREADS = GRPS * SEQS;
  static constexpr int STEPS = (LEN_LOG + 1) / 2;        // radix-4 (+ radix-2)
};

template <int LOGN, bool PASS_B, bool INVERSE>
__global__ void __launch_bounds__(Pass<LOGN, PASS_B>::THREADS)
ntt_pass(const uint32_t* x, uint32_t* y, const int32_t* __restrict__ rows,
         const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws,
         const uint32_t* __restrict__ qv, const uint32_t* __restrict__ ninv,
         const uint32_t* __restrict__ ninvs) {
  using P = Pass<LOGN, PASS_B>;
  constexpr int N = 1 << LOGN;
  __shared__ __align__(16) uint32_t sm[P::LEN * P::SEQS];

  const int plane = blockIdx.x / P::TILES;
  const int tile = blockIdx.x % P::TILES;
  const int r = rows[plane];
  const uint32_t q = qv[r];
  const uint32_t* w_row = tw + (size_t)r * N;
  const uint32_t* ws_row = tws + (size_t)r * N;

  // This thread's sequence (seq) and radix-4 group (grp). Element `pos` of
  // the sequence lies at gbase + pos * GSTRIDE in the plane and at
  // sbase + pos * SSTRIDE in shared memory.
  //   pass A: column c = tile*SEQS + seq; neighbouring threads take
  //           neighbouring columns (coalesced rows); root 1.
  //   pass B: segment g = tile*SEQS + seq; neighbouring threads take
  //           neighbouring groups; root 2^k + g.
  const int tid = threadIdx.x;
  const int seq = PASS_B ? tid / P::GRPS : tid % P::SEQS;
  const int grp = PASS_B ? tid % P::GRPS : tid / P::SEQS;
  const int col = tile * P::SEQS + seq;
  constexpr int GSTRIDE = PASS_B ? 1 : P::L;
  constexpr int SSTRIDE = PASS_B ? 1 : P::SEQS;
  const size_t gbase = (size_t)plane * N + (PASS_B ? (size_t)col * P::L : col);
  const int sbase = PASS_B ? seq * P::LEN : seq;
  const uint32_t root = PASS_B ? (uint32_t)(P::R + col) : 1u;

#pragma unroll
  for (int i = 0; i < P::STEPS; ++i) {
    // step st covers stages s, s+1 (radix 4), or s alone (radix 2, the last
    // stage at distance 1); the inverse runs the steps in reverse.
    const int st = INVERSE ? P::STEPS - 1 - i : i;
    const int s = 2 * st;
    const bool r4 = s + 1 < P::LEN_LOG;
    const int lq = r4 ? P::LEN_LOG - 2 - s : 0;   // quarter distance 2^lq
    const int jj = grp >> lq;                       // stage-s butterfly block
    const int b = (jj << (lq + 2)) | (grp & ((1 << lq) - 1));
    const bool first = i == 0, last = i == P::STEPS - 1;
    // lq == 0 in pass B: 4 adjacent, 16-byte aligned elements
    const bool vec = PASS_B && lq == 0;

    uint32_t a[4];
    if (first) {
      if (vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(x + gbase + b);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = x[gbase + (size_t)(b + (e << lq)) * GSTRIDE];
      }
    } else {
      if (vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(sm + sbase + b);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = sm[sbase + (b + (e << lq)) * SSTRIDE];
      }
    }

    // twiddles: stage s block jj; stage s+1 (or s for radix 2) blocks 2jj, 2jj+1
    const int s2 = r4 ? s + 1 : s;
    const uint32_t i2 = (root << s2) + 2 * jj;
    const uint2 w2 = __ldg(reinterpret_cast<const uint2*>(w_row + i2));
    const uint2 ws2 = __ldg(reinterpret_cast<const uint2*>(ws_row + i2));
    uint32_t w1 = 0, ws1 = 0;
    if (r4) {
      const uint32_t i1 = (root << s) + jj;
      w1 = __ldg(w_row + i1);
      ws1 = __ldg(ws_row + i1);
    }
    if (!INVERSE) {
      if (r4) {
        ct(a[0], a[2], w1, ws1, q);
        ct(a[1], a[3], w1, ws1, q);
      }
      ct(a[0], a[1], w2.x, ws2.x, q);
      ct(a[2], a[3], w2.y, ws2.y, q);
    } else {
      gs(a[0], a[1], w2.x, ws2.x, q);
      gs(a[2], a[3], w2.y, ws2.y, q);
      if (r4) {
        gs(a[0], a[2], w1, ws1, q);
        gs(a[1], a[3], w1, ws1, q);
      }
    }

    if (last) {
      if (INVERSE && !PASS_B) {  // the inverse ends in pass A: times N^-1
        const uint32_t ni = ninv[r], nis = ninvs[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = mul_shoup(a[e], ni, nis, q);
      }
      if (vec) {
        *reinterpret_cast<uint4*>(y + gbase + b) = make_uint4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) y[gbase + (size_t)(b + (e << lq)) * GSTRIDE] = a[e];
      }
    } else {
      // each thread writes back the positions it read: no other thread
      // reads them until after the barrier
      if (vec) {
        *reinterpret_cast<uint4*>(sm + sbase + b) = make_uint4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) sm[sbase + (b + (e << lq)) * SSTRIDE] = a[e];
      }
      __syncthreads();
    }
  }
}

struct Args {
  const int32_t* rows;
  const uint32_t *tw, *tws, *q, *ninv, *ninvs;
  int batch;
  cudaStream_t stream;
};

template <int LOGN, bool PASS_B, bool INVERSE>
cudaError_t launch_pass(const uint32_t* x, uint32_t* y, const Args& a) {
  using P = Pass<LOGN, PASS_B>;
  static_assert(P::LEN >= 16 && P::THREADS <= 1024, "tile shape");
  ntt_pass<LOGN, PASS_B, INVERSE><<<a.batch * P::TILES, P::THREADS, 0, a.stream>>>(
      x, y, a.rows, a.tw, a.tws, a.q, a.ninv, a.ninvs);
  return cudaGetLastError();
}

template <int LOGN, bool INVERSE>
cudaError_t launch(const uint32_t* x, uint32_t* y, const Args& a) {
  // forward: A (x -> y), B (y -> y); inverse: B (x -> y), A (y -> y)
  cudaError_t e = launch_pass<LOGN, INVERSE, INVERSE>(x, y, a);
  if (e != cudaSuccess) return e;
  return launch_pass<LOGN, !INVERSE, INVERSE>(y, y, a);
}

template <bool INVERSE>
cudaError_t launch_n(int logn, const uint32_t* x, uint32_t* y, const Args& a) {
  switch (logn) {
    case 8: return launch<8, INVERSE>(x, y, a);
    case 9: return launch<9, INVERSE>(x, y, a);
    case 10: return launch<10, INVERSE>(x, y, a);
    case 11: return launch<11, INVERSE>(x, y, a);
    case 12: return launch<12, INVERSE>(x, y, a);
    case 13: return launch<13, INVERSE>(x, y, a);
    case 14: return launch<14, INVERSE>(x, y, a);
    case 15: return launch<15, INVERSE>(x, y, a);
    case 16: return launch<16, INVERSE>(x, y, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dacapo_ntt(const void* x, void* y, const void* rows, int batch,
                          int logn, int inverse, const void* tw,
                          const void* tws, const void* q, const void* ninv,
                          const void* ninvs, void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int32_t*>(rows), static_cast<const uint32_t*>(tw),
               static_cast<const uint32_t*>(tws), static_cast<const uint32_t*>(q),
               static_cast<const uint32_t*>(ninv), static_cast<const uint32_t*>(ninvs),
               batch, static_cast<cudaStream_t>(stream)};
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* yo = static_cast<uint32_t*>(y);
  cudaError_t e = inverse ? launch_n<true>(logn, xi, yo, a) : launch_n<false>(logn, xi, yo, a);
  return (int)e;
}

extern "C" const char* dacapo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
