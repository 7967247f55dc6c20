// The Metropolis drivers' random stream: rr sequential
// `key, k1, k2 = split(key, 3)` steps (`threefry_split_chain`) and, in the
// same launch, each round's draws (`chunk_draws`).
//
// Replaces the Pallas kernel `threefry_split_chain` / `_make_split_chain_kernel`
// (ccgp_tpu/ops/pallas_rng.py:71-166) and the draws that follow it in the
// JAX chunk body (ccgp_tpu/infer/metropolis.py:371-375). Semantics (jax
// 0.9, partitionable threefry): split(key, 3) = threefry_2x32((k0, k1),
// x0 = [0, 0, 0], x1 = [0, 1, 2]); child i = (bits1[i], bits2[i]); child 0
// is carried, children 1 and 2 are the round's (k1, k2). Round r's draws:
//   eps[r, k, j] = sqrt2 * erfinv(max(lo, f * (1 - lo) + lo)), lo =
//                  nextafter(-1, 0), f the unit float of threefry(k1_r,
//                  x0 = 0, x1 = k dim + j)                 (normal)
//   log_u[r, k]  = log(max(0, f * 1 + 0)), f from threefry(k2_r, 0, k)
//                                                         (log of uniform)
// where the unit float fills the mantissa under exponent 0 and subtracts
// 1: from bits1 ^ bits2 in f32, from (bits1 << 20) | (bits2 >> 12) in f64
// (`_unit_floats` in ops/rng.py).
//
// What bounds it on the card: serial latency. Each split depends on the
// previous one, and one threefry is ~47 dependent 32-bit integer
// operations on its critical path (per round an add and an xor, the
// rotate beside the add; the key injections). There is no parallelism
// across splits, so ONE thread walks the chain with the carry in
// registers; children 1 and 2 ride beside child 0 as independent
// instructions. The draws are independent of each other: after the chain
// the block's threads make them, an item per thread at a time. A chunk's
// keys wait in shared memory, SEG rounds at a time (one segment at the
// bench's rr = 120), so a chunk of any length runs in one block: the
// chain of a segment, a barrier, its draws, a barrier. A segment's draws
// are indexed in int while SEG K dim < 2^31 (every path's shape) and in 64
// bits beyond, where a round's counter may also reach its high word
// (JAX's threefry counter is a uint64 split into two uint32 words).
//
// Arithmetic of the draws, bit-equal to `chunk_draws_plain` on the card:
// every add and multiply explicitly rounded and in the plain version's
// order (no contracted multiply-add: `Ar` of csrc/chol_core.cuh), each
// constant rounded to the draw's type as the plain version's tensors are
// (1 - lo is 2 in f32), erfinv and log the CUDA math library's, as
// PyTorch's elementwise kernels call them.
//
// The lanes launch (`chunk_draws_lanes`) runs the same body for L keys at
// once, a block per lane: the lane-batched K = 1 sampler's stream, the
// counterpart of the vmapped split / normal / uniform of JAX's K = 1 body
// (ccgp_tpu/infer/metropolis.py:228-235).
//
// Keys travel as int64 words holding uint32 values, the port's key layout.

#include <stdint.h>

#include "chol_core.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The 20 rounds plus key schedule (jax._src.prng threefry2x32 lowering).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const int inj[5][3] = {{1, 2, 1}, {2, 0, 2}, {0, 1, 3}, {1, 2, 4},
                         {2, 0, 5}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[g % 2][i]) ^ x0;
    }
    x0 += ks[inj[g][0]];
    x1 += ks[inj[g][1]] + (uint32_t)inj[g][2];
  }
}

__global__ void split_chain_kernel(const int64_t* __restrict__ key,
                                   int64_t* __restrict__ new_key,
                                   int64_t* __restrict__ k1s,
                                   int64_t* __restrict__ k2s, int rr) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  uint32_t k0 = (uint32_t)key[0];
  uint32_t k1 = (uint32_t)key[1];
  for (int r = 0; r < rr; ++r) {
    uint32_t a0 = 0u, a1 = 0u;   // child 0
    uint32_t b0 = 0u, b1 = 1u;   // child 1
    uint32_t c0 = 0u, c1 = 2u;   // child 2
    threefry2x32(k0, k1, a0, a1);
    threefry2x32(k0, k1, b0, b1);
    threefry2x32(k0, k1, c0, c1);
    k1s[2 * r] = (int64_t)b0;
    k1s[2 * r + 1] = (int64_t)b1;
    k2s[2 * r] = (int64_t)c0;
    k2s[2 * r + 1] = (int64_t)c1;
    k0 = a0;
    k1 = a1;
  }
  new_key[0] = (int64_t)k0;
  new_key[1] = (int64_t)k1;
}

// rounds of keys per segment in shared memory, and the block's threads
constexpr int SEG = 128;
constexpr int DRAW_THREADS = 1024;

// The unit float in [0, 1) of one threefry block's two words
__device__ __forceinline__ float unit_float(uint32_t b1, uint32_t b2, float) {
  return __fsub_rn(__uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u), 1.0f);
}
__device__ __forceinline__ double unit_float(uint32_t b1, uint32_t b2,
                                             double) {
  const uint64_t m = ((uint64_t)b1 << 20) | (uint64_t)(b2 >> 12);
  return __dsub_rn(__longlong_as_double((long long)(m | 0x3FF0000000000000ull)),
                   1.0);
}

__device__ __forceinline__ float erfinv_(float a) { return erfinvf(a); }
__device__ __forceinline__ double erfinv_(double a) { return erfinv(a); }

// nextafter(-1, 0) in the type: the normal's uniform is on (lo, 1)
__device__ __forceinline__ float lo_of(float) { return -0x1.fffffep-1f; }
__device__ __forceinline__ double lo_of(double) {
  return -0x1.fffffffffffffp-1;
}

// The high counter word of a draw's index: 0 below 2^32
__device__ __forceinline__ uint32_t hi_word(int) { return 0u; }
__device__ __forceinline__ uint32_t hi_word(long long c) {
  return (uint32_t)((unsigned long long)c >> 32);
}

// One chain's rr rounds of keys and draws by the calling block's THREADS
// threads (`keys` the block's shared segment buffer), the draws of a
// segment indexed in I (int or long long). The single launch and the lanes
// launch both run this body, so a lane computes what a single launch on
// its key computes, in the same thread order.
template <typename T, int THREADS, typename I>
__device__ __forceinline__ void chunk_draws_body(
    const int64_t* __restrict__ key, int64_t* __restrict__ new_key,
    T* __restrict__ eps, T* __restrict__ log_u, int rr, int K, int dim,
    uint4* keys) {
  using A = Ar<T>;
  const int tid = threadIdx.x;
  const T lo = lo_of(T(0));
  const T span = A::sub(T(1), lo);           // hi - lo, rounded to T
  const T sqrt2 = T(1.4142135623730951);     // sqrt(2) rounded to T
  const I per = (I)K * dim;
  uint32_t k0 = 0u, k1 = 0u;
  if (tid == 0) {
    k0 = (uint32_t)key[0];
    k1 = (uint32_t)key[1];
  }
  for (int s0 = 0; s0 < rr; s0 += SEG) {
    const int m = min(SEG, rr - s0);
    if (tid == 0) {
      // one split per iteration (not unrolled: the chain is latency-bound,
      // and a one-split body is what chip_smoke.k2_serial_floor reads)
#pragma unroll 1
      for (int r = 0; r < m; ++r) {
        uint32_t a0 = 0u, a1 = 0u;   // child 0
        uint32_t b0 = 0u, b1 = 1u;   // child 1
        uint32_t c0 = 0u, c1 = 2u;   // child 2
        threefry2x32(k0, k1, a0, a1);
        threefry2x32(k0, k1, b0, b1);
        threefry2x32(k0, k1, c0, c1);
        keys[r] = make_uint4(b0, b1, c0, c1);
        k0 = a0;
        k1 = a1;
      }
    }
    __syncthreads();
    for (I e = tid; e < m * per; e += THREADS) {
      const I r = e / per, c = e - r * per;
      const uint4 kr = keys[r];
      uint32_t x0 = hi_word(c), x1 = (uint32_t)c;
      threefry2x32(kr.x, kr.y, x0, x1);
      T u = A::add(A::mul(unit_float(x0, x1, T(0)), span), lo);
      u = u < lo ? lo : u;   // torch.maximum(lo, u)
      eps[(size_t)s0 * per + e] = A::mul(sqrt2, erfinv_(u));
    }
    for (I e = tid; e < (I)m * K; e += THREADS) {
      const I r = e / K, c = e - r * K;
      const uint4 kr = keys[r];
      uint32_t x0 = 0u, x1 = (uint32_t)c;
      threefry2x32(kr.z, kr.w, x0, x1);
      T u = A::add(A::mul(unit_float(x0, x1, T(0)), T(1)), T(0));
      u = u < T(0) ? T(0) : u;
      log_u[(size_t)s0 * K + e] = A::log_(u);
    }
    __syncthreads();   // the next segment's keys overwrite these
  }
  if (tid == 0) {
    new_key[0] = (int64_t)k0;
    new_key[1] = (int64_t)k1;
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(DRAW_THREADS)
chunk_draws_kernel(const int64_t* __restrict__ key, int64_t* __restrict__ new_key,
                   T* __restrict__ eps, T* __restrict__ log_u, int rr, int K,
                   int dim) {
  __shared__ uint4 keys[SEG];   // round r of the segment: (k1, k2)
  chunk_draws_body<T, DRAW_THREADS, I>(key, new_key, eps, log_u, rr, K, dim,
                                       keys);
}

// The lanes launch: a block per lane, each walking its own key chain (its
// draws are a lane's few hundred values, so a block of LANE_THREADS; the
// lanes run side by side up to the blocks the card holds at once). Lane l
// reads keys[l] and writes new_keys[l], eps[l] (rr, K, dim) and log_u[l]
// (rr, K).
constexpr int LANE_THREADS = 256;

template <typename T, typename I>
__global__ void __launch_bounds__(LANE_THREADS)
chunk_draws_lanes_kernel(const int64_t* __restrict__ keys_in,
                         int64_t* __restrict__ new_keys, T* __restrict__ eps,
                         T* __restrict__ log_u, int rr, int K, int dim) {
  __shared__ uint4 keys[SEG];
  const size_t lane = blockIdx.x;
  chunk_draws_body<T, LANE_THREADS, I>(
      keys_in + 2 * lane, new_keys + 2 * lane,
      eps + lane * (size_t)rr * K * dim, log_u + lane * (size_t)rr * K, rr,
      K, dim, keys);
}

// int indices while a segment's draws fit in one
bool int_indexed(int K, int dim) {
  return (long long)SEG * K * dim < (1LL << 31);
}

template <typename T>
int launch_draws(const void* key, void* new_key, void* eps, void* log_u,
                 int rr, int K, int dim, void* stream) {
  if (rr < 1 || K < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  auto kernel = int_indexed(K, dim) ? chunk_draws_kernel<T, int>
                                    : chunk_draws_kernel<T, long long>;
  kernel<<<1, DRAW_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, (int64_t*)new_key, (T*)eps, (T*)log_u, rr, K, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_draws_lanes(const void* keys, void* new_keys, void* eps,
                       void* log_u, int lanes, int rr, int K, int dim,
                       void* stream) {
  if (lanes < 1 || rr < 1 || K < 1 || dim < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = int_indexed(K, dim) ? chunk_draws_lanes_kernel<T, int>
                                    : chunk_draws_lanes_kernel<T, long long>;
  kernel<<<lanes, LANE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (int64_t*)new_keys, (T*)eps, (T*)log_u, rr, K,
      dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ccgp_chunk_draws_f32(const void* key, void* new_key, void* eps,
                                    void* log_u, int rr, int K, int dim,
                                    void* stream) {
  return launch_draws<float>(key, new_key, eps, log_u, rr, K, dim, stream);
}

extern "C" int ccgp_chunk_draws_f64(const void* key, void* new_key, void* eps,
                                    void* log_u, int rr, int K, int dim,
                                    void* stream) {
  return launch_draws<double>(key, new_key, eps, log_u, rr, K, dim, stream);
}

extern "C" int ccgp_chunk_draws_lanes_f32(const void* keys, void* new_keys,
                                          void* eps, void* log_u, int lanes,
                                          int rr, int K, int dim,
                                          void* stream) {
  return launch_draws_lanes<float>(keys, new_keys, eps, log_u, lanes, rr, K,
                                   dim, stream);
}

extern "C" int ccgp_chunk_draws_lanes_f64(const void* keys, void* new_keys,
                                          void* eps, void* log_u, int lanes,
                                          int rr, int K, int dim,
                                          void* stream) {
  return launch_draws_lanes<double>(keys, new_keys, eps, log_u, lanes, rr, K,
                                    dim, stream);
}

extern "C" int ccgp_threefry_split_chain(const void* key, void* new_key,
                                         void* k1s, void* k2s, int rr,
                                         void* stream) {
  split_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, (int64_t*)new_key, (int64_t*)k1s, (int64_t*)k2s,
      rr);
  return (int)cudaGetLastError();
}
