// gram_chol: the fused mixture-Gram -> Cholesky -> quadratics kernel K8.
// For each lane b of a batch,
//   C_b = scale_b (w1 e^{-D1} + w2 e^{-D2}) / (w1 + w2) + shift_b J
//         + jitter I,
//   D1 = sum_k r1[b, k] (x_ik - x_jk)^2, D2 the same with r2[b],
//   w1 = p_b^2, w2 = (1 - p_b)^2,
// is built from x and factored, with the forward solve of [y, 1] fused
// in -> {logdet, y'C^-1 y, 1'C^-1 y, 1'C^-1 1} per lane. No Gram exists in
// device memory.
//
// Replaces the Pallas kernel `fused_mix_quadratics`
// (ccgp_tpu/ops/pallas_gram_chol.py:121, body `_kernel` :45-118), which
// puts 128 lanes across the TPU's vector lanes, pads n to 128 and the batch
// to a multiple of 128, and stages the per-axis squared differences d2
// (d, n, n) in VMEM. Here one small thread block owns one lane, with no
// padding: it stages the lane's rates, weights, scale and shift in shared
// memory and runs the register-tile core of csrc/tile_core.cuh
// (`factor_tiles` on `ScaledSeMixSource`: each thread builds one 4 x 4
// tile of [C | y | 1] from x and downdates it in registers, an mbarrier
// per row instead of a block barrier per pivot; `tile_quadratics` sums
// logdet and the quadratics in pivot order), as K5 and K6 run one Gram per
// block (csrc/chol_smallk.cu). The block has the fewest threads, a power
// of two from 32, that hold the tiles (`tile_block`).
//
// A non-PD C takes rsqrt and log of a negative pivot: NaN in that lane's
// outputs only. No clamp, no error.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32, 34
// TFLOP/s f64 outside the tensor cores): operations. Per lane it reads d
// rates twice and three scalars, and writes four numbers; x is shared. At
// an EB row (B = 1728, n = 14, d = 2, f64) the Gram build (2 exp and ~5 d
// + 8 operations per entry of the upper triangle) and the factorization
// (n^3 / 3 + 2 n^2) are ~4 MFLOP, ~0.12 us at the f64 peak; the bytes
// ~0.1 MB. The kernel is latency-bound: each lane is n dependent pivot
// steps. So the design keeps every lane resident at once: at n = 14 a
// block is one warp (10 tiles) with ~2.6 KB of shared memory, 13 or 14
// blocks per SM, and the 1728 lanes run as one wave of 14 pivot steps. At
// the MAP cloud (B = 128, n = 100, f32) a block is 512 threads (350
// tiles), one per SM.
//
// Arithmetic: explicitly rounded intrinsics in the order of the plain
// PyTorch version (`fused_mix_quadratics_plain` in ops/gram_chol.py; see
// csrc/chol_core.cuh and csrc/tile_core.cuh).

#include "tile_core.cuh"

namespace {

constexpr int GRAM_CHOL_MAX_N = TILE;  // the TPU tile, one register tile
constexpr int GRAM_CHOL_MAX_D = 16;    // the TPU kernel's _RATE_ROWS

template <typename T>
struct GramCholArgs {
  const T* x;       // (n, d)
  const T* y;       // (n,)
  const T* r1;      // (B, d)
  const T* r2;      // (B, d)
  const T* p;       // (B,)
  const T* scale;   // (B,)
  const T* shift;   // (B,)
  T* q;             // (B, 4) logdet, qyy, qoy, qoo
  int n, d;
  T jitter;
};

template <typename T, int NTB>
__global__ void __launch_bounds__(NTB)
    gram_chol_kernel(const GramCholArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  __shared__ T s_r1[GRAM_CHOL_MAX_D], s_r2[GRAM_CHOL_MAX_D];
  __shared__ T s_w[5];   // w1, w2, w1 + w2, scale, shift
  __shared__ __align__(8) uint64_t s_bar[GRAM_CHOL_MAX_N];
  const int n = a.n, d = a.d, b = blockIdx.x, tid = threadIdx.x;
  // the scaled rows, then the pivots
  T* const L = (T*)smem_raw;
  T* const D = L + aug_row_off(n, n);
  int ta, tb;
  tile_of(tid, n, ta, tb);
  init_row_bars(s_bar, n, NTB);
  if (tid < d) {   // d <= 16 < NTB
    s_r1[tid] = a.r1[(size_t)b * d + tid];
    s_r2[tid] = a.r2[(size_t)b * d + tid];
  }
  if (tid == 0) {
    const T pb = a.p[b];
    const T qb = A::sub(T(1), pb);
    s_w[0] = A::mul(pb, pb);
    s_w[1] = A::mul(qb, qb);
    s_w[2] = A::add(s_w[0], s_w[1]);
    s_w[3] = a.scale[b];
    s_w[4] = a.shift[b];
  }
  __syncthreads();
  const ScaledSeMixSource<T> src{a.x,    s_r1,   s_r2,     s_w[0], s_w[1],
                                 s_w[2], s_w[3], s_w[4], a.jitter, d};
  factor_tiles<T>(L, D, smem_addr(s_bar), 0, ta, tb, src, a.y, n);
  for (int j = tid; j < n; j += NTB) D[j] = A::log_(D[j]);
  __syncthreads();
  if (tid == 0) {
    T* o = a.q + (size_t)b * 4;
    tile_quadratics<T>(L, D, n, o[0], o[1], o[2], o[3]);
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* r1, const void* r2,
           const void* p, const void* scale, const void* shift, void* q,
           int B, int n, int d, double jitter, void* stream) {
  if (B < 1 || n < 1 || n > GRAM_CHOL_MAX_N || d < 1 || d > GRAM_CHOL_MAX_D)
    return (int)cudaErrorInvalidValue;
  const GramCholArgs<T> a{(const T*)x,     (const T*)y,     (const T*)r1,
                          (const T*)r2,    (const T*)p,     (const T*)scale,
                          (const T*)shift, (T*)q,           n,
                          d,               (T)jitter};
  // the scaled rows and the pivots: at n = 128 in f64 73 KB, so the block
  // opts in above 48 KB; a refusal is returned and cleared
  const size_t smem = (size_t)(aug_row_off(n, n) + n) * sizeof(T);
  const cudaStream_t s = (cudaStream_t)stream;
  return launch_result(
      with_tile_block(tile_block(reg_tiles(n)), [&](auto nt) {
        constexpr int NTB = decltype(nt)::value;
        return launch_plain(gram_chol_kernel<T, NTB>, a, B, NTB, smem, s);
      }));
}

}  // namespace

extern "C" int ccgp_gram_chol_f32(const void* x, const void* y,
                                  const void* r1, const void* r2,
                                  const void* p, const void* scale,
                                  const void* shift, void* q, int B, int n,
                                  int d, double jitter, void* stream) {
  return launch<float>(x, y, r1, r2, p, scale, shift, q, B, n, d, jitter,
                       stream);
}

extern "C" int ccgp_gram_chol_f64(const void* x, const void* y,
                                  const void* r1, const void* r2,
                                  const void* p, const void* scale,
                                  const void* shift, void* q, int B, int n,
                                  int d, double jitter, void* stream) {
  return launch<double>(x, y, r1, r2, p, scale, shift, q, B, n, d, jitter,
                        stream);
}
