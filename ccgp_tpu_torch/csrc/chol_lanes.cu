// chol_lanes: a batch of B Cholesky factorizations with the forward solve of
// [y, 1] fused in. Out: logdet, y'R^-1 y, 1'R^-1 y, 1'R^-1 1 per matrix
// and, with the factor output on, L (lower), L^-1 y and L^-1 1.
//
// Replaces both Pallas kernels of ccgp_tpu/ops/pallas_chol_lanes.py:
//   K3 `chol_quadratics_lanes` (body `_kernel`, :34-92; wrapper :236-298),
//   K4 `chol_factors_lanes` (body `_kernel_factors`, :95-151; wrapper
//      :154-233),
// with the factor output as a compile-time flag of each kernel.
//
// The TPU kernel puts 128 matrices across the VPU lanes and pads n and B to
// 128 with identity blocks. None of that carries over: nothing is padded,
// and only the lower triangle of each Gram is loaded. Two paths, by n
// (`layout`, the one place it is decided; the wrapper reads it through
// `ccgp_chol_lanes_layout`):
//   - n <= WARP_MAX_N (32): `lanes_warp_kernel`, a matrix per group of G =
//     8, 16 or 32 lanes (the next power of two >= n, from 8), so a warp
//     holds 32 / G matrices and a block of two warps 64 / G. The warp
//     stages its matrices' lower triangles through shared memory (one
//     coalesced pass); then lane i holds row i of its matrix, with ry_i and
//     ro_i, in registers (the lanes i >= n a row of the identity), and
//     pivot j moves by __shfl_sync within the group: d = sqrt(a_jj) from
//     lane j; each lane divides two values by d (lane j ry_j and ro_j,
//     giving row j of L^-1 y and L^-1 1; lane i > j a_ij, giving col_i,
//     kept in place of a_ij); wy_j and wo_j are shuffled from lane j and
//     col_c from each lane c > j; ry_i -= col_i wy_j (and ro) and
//     a_ic -= col_i col_c for j < c <= i. The step is straight-line code:
//     a lane keeps what is its own by a select, so that no branch splits
//     the shuffles, and a zero dividend (the lanes whose quotient is not
//     used, an entry that underflowed) is not divided, since it fails the
//     division's fast-path test and sends the warp down the slow path
//     (`div_pivot`). No shared memory on the factorization path and no
//     barrier. At the end lane i's registers hold row i of L; K4 stages
//     the rows through shared memory again and writes them coalesced.
//   - 32 < n <= 128: `lanes_tiles_kernel`, a block per matrix on the
//     register-tile core of csrc/tile_core.cuh, as K5 runs it (one 4 x 4
//     tile of [M | y | 1] per thread, an mbarrier per row instead of a
//     block barrier per pivot; the fewest threads, a power of two, that
//     hold the tiles), with the pivot policy `SqrtPivot`: d = sqrt(d_j),
//     L_j[c] = M[j][c] / d, the pivot d and the log term 2 log d. K4 then
//     writes L, L^-1 y and L^-1 1 from the scaled rows in shared memory, a
//     warp per row of L. The factor's diagonal is d_j itself, not the
//     scaled row's own M[j][j] / d_j, which rounds differently.
// The crossover WARP_MAX_N comes from the sweep `chip_smoke.lanes_paths`
// (two builds of this file, -DCCGP_LANES_WARP_MAX_N=0 and =32), whose
// numbers stand beside the constant.
//
// A non-PD Gram takes the square root of a negative pivot: NaN, which
// flows into logdet and the quadratics (a log-posterior of -inf, i.e. a
// rejection). No clamp, no error.
//
// What bounds it on the card, at the slice's shapes (H100 SXM: 3.35 TB/s,
// 67 TFLOP/s f32 and f64): memory. The bytes are the Grams' lower
// triangles, n (n + 1) / 2 entries each, plus the outputs (K4's factor is
// dense, n x n with zeros above).
//   K3, MAP cloud, B = 128, n = 100, f32: 2.6 MB read, ~0.77 us; 45 MFLOP,
//       ~0.68 us.
//   K4, lazy predict chunk, B = 64, n = 100, f32: 1.3 MB in, 2.6 MB out,
//       ~1.2 us.
//   K3, EB row, B = 1728, n = 14, f64: 1.5 MB, ~0.45 us.
// Both paths read each Gram's lower triangle once and write each output
// once. What they do not reach is the bound's parallelism: a
// factorization is n dependent pivot steps, so a matrix's time is n steps
// of a shuffle or mbarrier round trip and a square root and a division,
// whatever the bytes.
//
// Arithmetic: every add, multiply and divide is an explicitly rounded
// intrinsic (no contracted multiply-add), in the order of the plain
// PyTorch version (`_factor_plain` in ops/chol_lanes.py); sqrt is IEEE.
// log is the CUDA math library's, as PyTorch's elementwise kernel uses.

#include "tile_core.cuh"

namespace {

// The largest n on the warp path (a build for the sweep sets it: 0 sends
// every n to the tile path). `chip_smoke.lanes_paths` on one H100 80GB
// HBM3 at 700 W, device ms, warp / tile path, K3 then K4:
//   B = 1728 f64: n = 8   0.0058 / 0.0109, 0.0063 / 0.0130
//                 n = 14  0.0103 / 0.0165, 0.0116 / 0.0203
//                 n = 16  0.0119 / 0.0186, 0.0149 / 0.0228
//                 n = 24  0.0269 / 0.0267, 0.0489 / 0.0326
//                 n = 32  0.0351 / 0.0637, 0.0732 / 0.0722
//   B = 128 f32:  n = 8   0.0047 / 0.0070, 0.0050 / 0.0089
//                 n = 14  0.0076 / 0.0102, 0.0088 / 0.0133
//                 n = 16  0.0084 / 0.0117, 0.0093 / 0.0150
//                 n = 24  0.0158 / 0.0161, 0.0159 / 0.0209
//                 n = 32  0.0205 / 0.0204, 0.0222 / 0.0235
// The warp path wins every shape to n = 16 and most beyond (the tile path
// K4 in f64 at n = 24 and, within 1.4%, three others), and its sum over
// n = 24 and 32 is the smaller: 32.
#ifndef CCGP_LANES_WARP_MAX_N
#define CCGP_LANES_WARP_MAX_N 32
#endif
constexpr int WARP_MAX_N = CCGP_LANES_WARP_MAX_N;
static_assert(WARP_MAX_N >= 0 && WARP_MAX_N <= 32, "a matrix per warp");

constexpr int WARP_THREADS = 64;   // threads per block on the warp path
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
struct LanesArgs {
  const T* grams;   // (B, n, n), only the lower triangle read
  const T* y;       // (n,)
  T* q;             // (B, 4) logdet, qyy, qoy, qoo
  T* chol;          // K4: (B, n, n)
  T* wy;            // K4: (B, n) L^-1 y
  T* wo;            // K4: (B, n) L^-1 1
  int B, n;
  T jitter;
};

// ---------------------------------------------------------------------------
// n <= WARP_MAX_N: a matrix per group of G lanes, in registers
// ---------------------------------------------------------------------------

template <typename T, int G, bool FACTORS>
__global__ void __launch_bounds__(WARP_THREADS)
    lanes_warp_kernel(const LanesArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  constexpr int PER_WARP = 32 / G;
  const int n = a.n, nn = n * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = (blockIdx.x * (WARP_THREADS / 32) + warp) * PER_WARP;
  if (b0 >= a.B) return;   // a warp past the batch, all its lanes
  const int i = lane % G;   // the row of its matrix this lane holds
  const int grp = lane / G;
  const int b = b0 + grp;
  const bool live = b < a.B;   // false in a part-filled warp's last groups
  const int span = min(PER_WARP, a.B - b0) * nn;
  T* const S = (T*)smem_raw + warp * PER_WARP * nn;   // the warp's matrices

  // the lower triangles of the warp's matrices (contiguous in memory), a
  // coalesced pass; (r, c) of element e is stepped along, not divided out
  {
    const T* g = a.grams + (size_t)b0 * nn;
    const int dr = 32 / n, dc = 32 % n;
    int r = (lane / n) % n, c = lane % n;
    for (int e = lane; e < span; e += 32) {
      if (c <= r) S[e] = g[e];
      c += dc;
      r += dr;
      if (c >= n) {
        c -= n;
        ++r;
      }
      while (r >= n) r -= n;
    }
  }
  __syncwarp();

  // m[c]: row i of the lower triangle (jitter on the diagonal), then row i
  // of L; zeros beyond it; the lanes i >= n and the groups past the batch
  // hold a row of the identity
  T m[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    T v = c == i ? T(1) : T(0);
    if (live && c <= i && i < n) {
      v = S[grp * nn + i * n + c];
      if (c == i && a.jitter != T(0)) v = A::add(v, a.jitter);
    }
    m[c] = v;
  }
  T ry = live && i < n ? a.y[i] : T(0);
  T ro = T(1);
  T dd = T(0), wy = T(0), wo = T(0);   // this lane's d_i, (L^-1 y)_i, (L^-1 1)_i
  T qyy = T(0), qoy = T(0), qoo = T(0);   // every lane alike, pivot order

  // No branch between the shuffles: every lane runs the same straight-line
  // step, and what a lane keeps is a select.
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < n) {   // the same for every lane of the warp
      const T d = A::sqrt_(__shfl_sync(FULL_MASK, m[j], j, G));
      // two quotients per lane: lane j's are row j of L^-1 y and L^-1 1,
      // lane i > j's first is col_i = L[i][j]; the rest are not used
      const T qa = div_pivot(i == j ? ry : m[j], d);
      const T qb = div_pivot(ro, d);
      const T wyj = __shfl_sync(FULL_MASK, qa, j, G);
      const T woj = __shfl_sync(FULL_MASK, qb, j, G);
      T lc[G];   // col_c from lane c
#pragma unroll
      for (int c = j + 1; c < G; ++c)
        lc[c] = __shfl_sync(FULL_MASK, qa, c, G);
      qyy = A::add(qyy, A::mul(wyj, wyj));
      qoy = A::add(qoy, A::mul(wyj, woj));
      qoo = A::add(qoo, A::mul(woj, woj));
      const bool below = i > j, on = i == j;
      const T ryn = A::sub(ry, A::mul(qa, wyj));
      const T ron = A::sub(ro, A::mul(qa, woj));
      ry = below ? ryn : ry;
      ro = below ? ron : ro;
      m[j] = below ? qa : (on ? d : m[j]);   // col_i in place of a_ij
      dd = on ? d : dd;
      wy = on ? wyj : wy;
      wo = on ? woj : wo;
      // a_ic -= col_i col_c for j < c <= i (lanes c >= n hold zeros)
#pragma unroll
      for (int c = j + 1; c < G; ++c) {
        const T v = A::sub(m[c], A::mul(qa, lc[c]));
        m[c] = i >= c ? v : m[c];
      }
    }
  }

  // logdet: the log terms one per lane (0 in the lanes i >= n), summed in
  // pivot order
  const T lg = i < n ? A::mul(T(2), A::log_(dd)) : T(0);
  T lgs[G];
#pragma unroll
  for (int j = 0; j < G; ++j) lgs[j] = __shfl_sync(FULL_MASK, lg, j, G);
  T ld = T(0);
#pragma unroll
  for (int j = 0; j < G; ++j) ld = j < n ? A::add(ld, lgs[j]) : ld;

  if (live && i == 0) {
    T* o = a.q + (size_t)b * 4;
    o[0] = ld;
    o[1] = qyy;
    o[2] = qoy;
    o[3] = qoo;
  }
  if (FACTORS) {
    if (live && i < n) {
      a.wy[(size_t)b * n + i] = wy;
      a.wo[(size_t)b * n + i] = wo;
    }
    __syncwarp();   // every lane has read its row of S
    if (live && i < n) {
      T* Si = S + grp * nn + i * n;
#pragma unroll
      for (int c = 0; c < G; ++c)
        if (c < n) Si[c] = c <= i ? m[c] : T(0);
    }
    __syncwarp();
    T* const out = a.chol + (size_t)b0 * nn;
    for (int e = lane; e < span; e += 32) out[e] = S[e];
  }
}

// ---------------------------------------------------------------------------
// 32 < n <= 128: a block per matrix on the register-tile core
// ---------------------------------------------------------------------------

template <typename T, int NTB, bool FACTORS>
__global__ void __launch_bounds__(NTB)
    lanes_tiles_kernel(const LanesArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  __shared__ __align__(8) uint64_t s_bar[TILE];
  const int n = a.n, b = blockIdx.x, tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  // the scaled rows, the pivots d_j, the log terms 2 log d_j
  T* const L = (T*)smem_raw;
  T* const D = L + aug_row_off(n, n);
  T* const lg = D + n;
  int ta, tb;
  tile_of(tid, n, ta, tb);
  init_row_bars(s_bar, n, NTB);
  __syncthreads();
  const GramSource<T> src{a.grams + (size_t)b * nn, n, a.jitter};
  factor_tiles<T, SqrtPivot>(L, D, smem_addr(s_bar), 0, ta, tb, src, a.y,
                             n);
  for (int j = tid; j < n; j += NTB) lg[j] = A::mul(T(2), A::log_(D[j]));
  __syncthreads();
  if (tid == 0) {
    T* o = a.q + (size_t)b * 4;
    tile_quadratics<T>(L, lg, n, o[0], o[1], o[2], o[3]);
  }
  if (FACTORS) {
    // a warp per row i of L: column c < i is scaled row c at column i
    T* const out = a.chol + (size_t)b * nn;
    for (int i = tid >> 5; i < n; i += NTB >> 5)
      for (int c = tid & 31; c < n; c += 32)
        out[(size_t)i * n + c] =
            c < i ? *aug_at(L, c, i, n) : (c == i ? D[i] : T(0));
    for (int i = tid; i < n; i += NTB) {
      const T* Li = aug_at(L, i, n, n);
      a.wy[(size_t)b * n + i] = Li[0];
      a.wo[(size_t)b * n + i] = Li[1];
    }
  }
}

// ---------------------------------------------------------------------------
// the layout and the launches
// ---------------------------------------------------------------------------

struct LanesLayout {
  int group;     // lanes per matrix on the warp path; 0: the tile path
  int threads;   // per block
  int grid;      // blocks
  size_t smem;   // dynamic shared memory per block, bytes
};

LanesLayout layout(int n, int B, int elem) {
  LanesLayout l;
  if (n <= WARP_MAX_N) {
    l.group = n <= 8 ? 8 : (n <= 16 ? 16 : 32);
    l.threads = WARP_THREADS;
    const int per_block = WARP_THREADS / l.group;   // matrices
    l.grid = (B + per_block - 1) / per_block;
    l.smem = (size_t)per_block * n * n * elem;
  } else {
    l.group = 0;
    l.threads = tile_block(reg_tiles(n));
    l.grid = B;
    // the scaled rows, the pivots and the log terms: at n = 128 in f64
    // 74 KB, so the block opts in above 48 KB
    l.smem = (size_t)(aug_row_off(n, n) + 2 * n) * elem;
  }
  return l;
}

template <typename T, bool FACTORS>
cudaError_t launch_layout(const LanesArgs<T>& a, const LanesLayout& l,
                          cudaStream_t s) {
  switch (l.group) {
    case 8:
      return launch_plain(lanes_warp_kernel<T, 8, FACTORS>, a, l.grid,
                          WARP_THREADS, l.smem, s);
    case 16:
      return launch_plain(lanes_warp_kernel<T, 16, FACTORS>, a, l.grid,
                          WARP_THREADS, l.smem, s);
    case 32:
      return launch_plain(lanes_warp_kernel<T, 32, FACTORS>, a, l.grid,
                          WARP_THREADS, l.smem, s);
    default:
      return with_tile_block(l.threads, [&](auto nt) {
        constexpr int NTB = decltype(nt)::value;
        return launch_plain(lanes_tiles_kernel<T, NTB, FACTORS>, a, l.grid,
                            NTB, l.smem, s);
      });
  }
}

bool valid(int B, int n) { return B >= 1 && n >= 1 && n <= TILE; }

template <typename T>
int launch(const void* grams, const void* y, void* q, void* chol, void* wy,
           void* wo, int B, int n, int factors, double jitter, void* stream) {
  if (!valid(B, n)) return (int)cudaErrorInvalidValue;
  const LanesArgs<T> a{(const T*)grams, (const T*)y, (T*)q, (T*)chol,
                       (T*)wy,          (T*)wo,      B,     n,
                       (T)jitter};
  const LanesLayout l = layout(n, B, (int)sizeof(T));
  const cudaStream_t s = (cudaStream_t)stream;
  // a refusal (shared memory the card will not give) is returned and
  // cleared
  return launch_result(factors ? launch_layout<T, true>(a, l, s)
                               : launch_layout<T, false>(a, l, s));
}

}  // namespace

extern "C" int ccgp_chol_lanes_f32(const void* grams, const void* y, void* q,
                                   void* chol, void* wy, void* wo, int B,
                                   int n, int factors, double jitter,
                                   void* stream) {
  return launch<float>(grams, y, q, chol, wy, wo, B, n, factors, jitter,
                       stream);
}

extern "C" int ccgp_chol_lanes_f64(const void* grams, const void* y, void* q,
                                   void* chol, void* wy, void* wo, int B,
                                   int n, int factors, double jitter,
                                   void* stream) {
  return launch<double>(grams, y, q, chol, wy, wo, B, n, factors, jitter,
                        stream);
}

// The launch for B matrices of n x n in elements of `elem` bytes: the
// lanes per matrix on the warp path (0: the tile path), the threads per
// block and the blocks.
extern "C" int ccgp_chol_lanes_layout(int n, int B, int elem, int* group,
                                      int* threads, int* blocks) {
  if (!valid(B, n) || (elem != 4 && elem != 8))
    return (int)cudaErrorInvalidValue;
  const LanesLayout l = layout(n, B, elem);
  *group = l.group;
  *threads = l.threads;
  *blocks = l.grid;
  return 0;
}
